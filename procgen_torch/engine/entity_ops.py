"""Batched operations on the SoA entity table (counterpart of
``procgen_tpu/engine/entity_ops.py``).

Every field is ``(N, E)``; a slot index ``i`` is a Python int shared by all
envs.  Writes return new tensors (the caller's table is never modified).
"""

from __future__ import annotations

import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.state import F32, I32, EntityTable, default_entity_fields

AGENT = 0  # agent is always slot 0 (basic-abstract-game.cpp:788-792)


def _col(arr: torch.Tensor, val) -> torch.Tensor:
    """``val`` (a Python number or a tensor) as an (N,) column of ``arr``'s
    dtype and device.  Python numbers become a fill on the device, not a
    host-to-device copy (which would synchronize the stream)."""
    if not isinstance(val, torch.Tensor):
        return torch.full(arr.shape[:-1], val, dtype=arr.dtype, device=arr.device)
    return val.to(device=arr.device, dtype=arr.dtype).expand(arr.shape[:-1])


def write_slot(ents: EntityTable, i: int, **updates) -> EntityTable:
    new = {}
    for name, val in updates.items():
        arr = getattr(ents, name).clone()
        arr[:, i] = _col(arr, val)
        new[name] = arr
    return ents.replace(**new)


def write_slot_masked(ents: EntityTable, i: int, mask, **updates) -> EntityTable:
    """Write fields at slot ``i`` only where ``mask`` (bool (N,)) holds."""
    new = {}
    for name, val in updates.items():
        arr = getattr(ents, name).clone()
        arr[:, i] = torch.where(mask, _col(arr, val), arr[:, i])
        new[name] = arr
    return ents.replace(**new)


def read_slots(ents: EntityTable, idxs, names) -> dict:
    """Fields of slots ``idxs`` as {name: (N, M)}: ``idxs`` is a list of
    ints shared by all envs or an (N, M) int64 tensor of per-env slots.
    Direct indexing keeps every bit, signed zeros included."""
    if isinstance(idxs, torch.Tensor):
        return {n: torch.gather(getattr(ents, n), 1, idxs) for n in names}
    return {n: getattr(ents, n)[:, idxs] for n in names}


def write_slots_masked(ents: EntityTable, idxs, mask, **updates) -> EntityTable:
    """Write (N, M) ``updates`` into slots ``idxs`` (as in ``read_slots``,
    distinct per env) where ``mask`` (N, M) holds."""
    new = {}
    for name, val in updates.items():
        arr = getattr(ents, name)
        if isinstance(idxs, torch.Tensor):
            cur = torch.gather(arr, 1, idxs)
            new[name] = arr.scatter(1, idxs, torch.where(mask, val.to(arr.dtype), cur))
        else:
            arr = arr.clone()
            arr[:, idxs] = torch.where(mask, val.to(arr.dtype), arr[:, idxs])
            new[name] = arr
    return ents.replace(**new)


def at(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per-env slot read ``arr[n, i[n]]`` of an (N, E) field, (N,)."""
    return torch.gather(arr, 1, i[:, None])[:, 0]


def set_at(arr: torch.Tensor, i: torch.Tensor, val, mask) -> torch.Tensor:
    """``arr`` with ``arr[n, i[n]] = val[n]`` where ``mask[n]``; ``val`` is
    an (N,) tensor or a Python number."""
    cur = at(arr, i)
    val = val if isinstance(val, torch.Tensor) else torch.full_like(cur, val)
    return arr.scatter(1, i[:, None], torch.where(mask, val, cur).to(arr.dtype)[:, None])


def make_entity(x, y, vx, vy, rx, ry, type_) -> dict:
    return default_entity_fields(x, y, vx, vy, rx, ry, type_)


def _like(val: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """``val`` on ``arr``'s device and dtype (no op when it already is: the
    entity writes run hundreds of times per reset)."""
    if val.device == arr.device and val.dtype == arr.dtype:
        return val
    return val.to(device=arr.device, dtype=arr.dtype)


def _write_where(arr: torch.Tensor, dest: torch.Tensor, val) -> torch.Tensor:
    """``arr`` with ``val`` (a Python number or an (N,) tensor) written where
    ``dest`` (N, E) holds."""
    if isinstance(val, torch.Tensor):
        val = _like(val, arr)
        val = val[:, None] if val.dim() == 1 else val
    out = torch.where(dest, val, arr)
    return out if out.dtype == arr.dtype else out.to(arr.dtype)


def append_entity(ents: EntityTable, fields: dict, active=True):
    """push_back: write ``fields`` into slot ``count`` (the number of alive
    slots) where ``active`` (bool (N,) or a Python bool) holds; returns
    (ents, slot (N,)).  A full table drops the append (capacities are sized
    so that this cannot happen in-distribution)."""
    E = ents.capacity
    idx = ents.alive.to(I32).sum(1)
    ok = idx < E
    if isinstance(active, torch.Tensor):
        ok = ok & active
    elif not active:
        return ents, idx.clamp(max=E - 1)
    slot = idx.clamp(max=E - 1)
    dest = (torch.arange(E, device=idx.device)[None, :] == slot[:, None]) & ok[:, None]
    new = {
        name: _write_where(getattr(ents, name), dest, val)
        for name, val in fields.items()
    }
    return ents.replace(**new), slot


def append_entities_masked(ents: EntityTable, fields: dict, mask, descending=True):
    """Append one entity per masked source (mask (N, K): the table's own
    slots, K = E, or any other sources, e.g. grid cells), in descending (or
    ascending) source order; every field is an (N, K) candidate tensor or a
    Python number, and ``alive`` is set.  Equivalent to a loop of
    ``append_entity`` calls over the sources in that order (the
    destinations are dead slots, never a source).  Overflow appends are
    dropped."""
    E = ents.capacity
    K = mask.shape[1]
    dev = mask.device
    slot = torch.arange(E, device=dev)
    source = torch.arange(K, device=dev)
    key = torch.where(mask, (K - 1 - source) if descending else source, 2 * K)
    order = torch.sort(key, dim=1, stable=True).indices  # masked sources first
    n = mask.to(I32).sum(1, keepdim=True)
    cnt = ents.alive.to(I32).sum(1, keepdim=True)
    k = slot[None, :] - cnt  # destination slot j takes source number j - cnt
    dest = (k >= 0) & (k < n)
    src = torch.gather(order, 1, k.clamp(0, K - 1))
    new = {"alive": ents.alive | dest}
    for name, val in fields.items():
        arr = getattr(ents, name)
        if isinstance(val, torch.Tensor):
            val = torch.gather(val.to(device=dev, dtype=arr.dtype), 1, src)
        new[name] = torch.where(dest, val, arr).to(arr.dtype)
    return ents.replace(**new)


def find_entity_index(ents: EntityTable, type_) -> torch.Tensor:
    """bag.cpp:1133-1143: the last alive slot of ``type_`` per env, -1 if
    none (int64 (N,))."""
    slot = torch.arange(ents.capacity, device=ents.x.device)
    match = ents.alive & (ents.type == type_)
    return torch.where(match, slot, -1).amax(1)


def _env_col(v):
    """A per-env (N,) tensor as an (N, 1) column against (N, E) fields; a
    Python number stays a number."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 else v


def entity_vs_all(ents: EntityTable, x, y, rx, ry, margin=0.0):
    """AABB overlap of one box per env (x, y, rx, ry: (N,) or numbers) with
    every slot: has_collision (bag.cpp:1145-1150) as (N, E) bool."""
    x, y, rx, ry, margin = (_env_col(v) for v in (x, y, rx, ry, margin))
    tx = (rx + ents.rx) + margin
    ty = (ry + ents.ry) + margin
    return (torch.abs(x - ents.x) < tx) & (torch.abs(y - ents.y) < ty)


def has_any_collision_mask(ents: EntityTable, x, y, rx, ry, margin=0.0):
    """Alive slots that overlap the box and do not avoid collisions, (N, E)
    bool."""
    return entity_vs_all(ents, x, y, rx, ry, margin) & ents.alive & ~ents.avoids_collisions


def is_out_of_bounds(x, y, rx, ry, main_width, main_height):
    """bag.cpp:1068-1084; ``main_width``/``main_height`` broadcast against
    ``x``."""
    w = main_width.to(F32)
    h = main_height.to(F32)
    return (x + rx < 0) | (y + ry < 0) | (x - rx > w) | (y - ry > h)


def compact(ents: EntityTable, main_width, main_height) -> EntityTable:
    """erase_if_needed (bag.cpp:748-756): drop will_erase / auto-erased OOB
    slots, stably compacting survivors (reverse-order vector::erase)."""
    oob = is_out_of_bounds(
        ents.x, ents.y, ents.rx, ents.ry, main_width[:, None], main_height[:, None]
    )
    dead = ents.will_erase | (ents.auto_erase & oob) | ~ents.alive
    E = ents.capacity
    slot = torch.arange(E, device=dead.device)
    order = torch.where(dead, E + slot, slot)
    perm = torch.sort(order, dim=1, stable=True).indices
    new = {
        f: torch.gather(getattr(ents, f), 1, perm)
        for f in ents.__dataclass_fields__
    }
    n_alive = (~dead).to(I32).sum(1, keepdim=True)
    new["alive"] = slot[None, :] < n_alive
    return EntityTable(**new)


REPOSITION_SPAN = "procgen_torch.reposition"
# how often reposition's retry loop reads on the host whether any env is
# still retrying (each read synchronizes the stream)
REPOSITION_CHECK_EVERY = 4


def _batch_f32(rs, v) -> torch.Tensor:
    """``v`` (a number or an (N,) tensor) as a float32 (N,) tensor on the
    device and batch of the draw source ``rs``."""
    like = rs.cursor if isinstance(rs, R.MTBlock) else rs.pos
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=F32).expand(like.shape)
    return torch.full(like.shape, v, dtype=F32, device=like.device)


def rand_pos(rs, r, lo, hi, active=True):
    """bag.cpp:1100-1108: a coordinate in [lo + r, hi - r].  Draws only
    where the box is loose (hi - lo > 2r); a tight box gives its midpoint
    without touching the stream (part of the RNG contract).  ``r``, ``lo``,
    ``hi``: (N,) float32 tensors or numbers (float32 values, as the
    reference's float parameters); returns (rs, (N,) float32)."""
    r, lo, hi = (_batch_f32(rs, v) for v in (r, lo, hi))
    span = hi - lo
    tight = span <= 2 * r
    draw = ~tight if active is True else ~tight & active
    rs, u = R.rs_rand01(rs, active=draw)
    # "(max - min - 2 * r) * rand01() + r + min", each op rounded in turn
    loose = (span - 2 * r) * u + r + lo
    return rs, torch.where(tight, (hi + lo) / 2, loose)


def reposition(rs, state, rx, ry, type_, collision_margin, x, y, w, h,
               check_collisions=True, active=True):
    """bag.cpp:541-560: draw a position in the box (x, y, w, h) and redraw,
    up to 100 times, while it overlaps the agent (for a non-player type) or,
    with ``check_collisions``, any live slot that does not avoid
    collisions.  ``active`` (bool (N,) or True) gates every draw.  The loop
    stops once no env is still redrawing, read on the host every
    ``REPOSITION_CHECK_EVERY`` tries (exact: an inactive env draws nothing).
    Returns (rs, px, py)."""
    ents = state.ents
    x, y, w, h = (_batch_f32(rs, v) for v in (x, y, w, h))
    act = torch.ones_like(ents.alive[:, 0]) if active is True else active

    def try_place(rs, act):
        rs, px = rand_pos(rs, rx, x, x + w, act)
        rs, py = rand_pos(rs, ry, y, y + h, act)
        return rs, px, py

    with torch.profiler.record_function(REPOSITION_SPAN):
        rs, px, py = try_place(rs, act)
        for k in range(100):
            # has_agent_collision (bag.cpp:1126-1131), then has_any_collision
            bad = torch.zeros_like(act)
            if type_ != O.PLAYER:
                bad = entity_vs_all(ents, px, py, rx, ry, collision_margin)[:, AGENT]
            if check_collisions:
                bad = bad | has_any_collision_mask(ents, px, py, rx, ry).any(1)
            act = act & bad
            if k % REPOSITION_CHECK_EVERY == 0 and not bool(act.any()):
                break
            rs, nx, ny = try_place(rs, act)
            px = torch.where(act, nx, px)
            py = torch.where(act, ny, py)
    return rs, px, py


def spawn_entity_rxy(rs, state, rx, ry, type_, x, y, w, h, check_collisions=True,
                     active=True):
    """bag.cpp:511-519: reposition a fresh entity, then push_back.
    Returns (rs, state, slot)."""
    fields = make_entity(0.0, 0.0, 0.0, 0.0, rx, ry, type_)
    rs, px, py = reposition(
        rs, state, rx, ry, type_, fields["collision_margin"], x, y, w, h,
        check_collisions, active=active,
    )
    fields["x"] = px
    fields["y"] = py
    ents, idx = append_entity(state.ents, fields, active)
    return rs, state.replace(ents=ents), idx


def add_entity_rxy(state, x, y, vx, vy, rx, ry, type_, active=True):
    """bag.cpp:521-529: push_back an entity at (x, y)."""
    ents, idx = append_entity(state.ents, make_entity(x, y, vx, vy, rx, ry, type_), active)
    return state.replace(ents=ents), idx


def reposition_agent(cfg, state, rs):
    """reposition_agent (bag.cpp:531-539): the agent at "rand01() *
    (main_width - 2 * rx) + rx" (and y), each op rounded in turn, redrawn up
    to 99 more times while it overlaps a live entity.  The loop stops once
    no env redraws, read on the host every ``REPOSITION_CHECK_EVERY`` tries
    (exact: an env that stopped draws nothing).  Returns (state, rs)."""
    ents = state.ents
    arx, ary = ents.rx[:, AGENT], ents.ry[:, AGENT]
    mw, mh = state.main_width.to(F32), state.main_height.to(F32)

    def try_pos(rs, act):
        rs, ux = R.rs_rand01(rs, active=act)
        rs, uy = R.rs_rand01(rs, active=act)
        return rs, fm.fmuladd32(cfg, ux, mw - 2 * arx, arx), fm.fmuladd32(cfg, uy, mh - 2 * ary, ary)

    with torch.profiler.record_function(REPOSITION_SPAN):
        act = torch.ones_like(state.done)
        rs, ax, ay = try_pos(rs, act)
        for k in range(99):
            hit = entity_vs_all(ents, ax, ay, arx, ary, margin=ents.collision_margin)
            act = act & (hit & ents.alive & (ents.type != O.PLAYER)).any(1)
            if k % REPOSITION_CHECK_EVERY == 0 and not bool(act.any()):
                break
            rs, nx, ny = try_pos(rs, act)
            ax = torch.where(act, nx, ax)
            ay = torch.where(act, ny, ay)
    return state.replace(ents=write_slot(ents, AGENT, x=ax, y=ay)), rs
