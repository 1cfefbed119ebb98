"""Sub-stepped grid-collision physics (counterpart of
``procgen_tpu/engine/physics.py``; reference basic-abstract-game.cpp:270-372
sub_step, :593-656 basic_step_object, :1086-1098 step_entities).

Batched over a leading env axis.  Movers interact with grid cells (ninja's
throwing stars stop dead on a wall probe) and, in games that push
(coinrun's crates), with the entity table through the vectorized push/block
branch, and (dodgeball's enemies off its lava walls) through the sequential
entity-reflect sweep.  Pure entity blocking arrives with the game that
uses it.
"""

from __future__ import annotations

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import telemetry
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.rand_util import first_true
from procgen_torch.state import F32, I32, EnvState

REFLECT_SPAN = "procgen_torch.physics.entity_reflect"

POS_EPS = float(np.float32(-0.001))  # bag.cpp:10
SUB_STEP_MARGIN = float(np.float32(0.98))  # bag.cpp:276


def _per_env(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (N,) tensor reshaped to broadcast against ``like`` (N, ...)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


# ---------------------------------------------------------------------------
# Grid access
# ---------------------------------------------------------------------------


def get_obj(state: EnvState, x, y):
    """bag.cpp:180-185: the cell at integer (x, y), or out_of_bounds_object
    outside [0, w) x [0, h).  ``x``/``y`` are (N, ...) int tensors."""
    x = torch.as_tensor(x).to(torch.int64)
    y = torch.as_tensor(y).to(torch.int64)
    x, y = torch.broadcast_tensors(x, y)
    N, H, W = state.grid.shape
    flat = (y.clamp(0, H - 1) * W + x.clamp(0, W - 1)).reshape(N, -1)
    val = torch.gather(state.grid.reshape(N, H * W), 1, flat).reshape(x.shape)
    inside = (
        (x >= 0) & (x < _per_env(state.main_width, x))
        & (y >= 0) & (y < _per_env(state.main_height, y))
    )
    return torch.where(inside, val, _per_env(state.out_of_bounds_object, x))


def get_obj_from_floats(state: EnvState, fx, fy):
    """bag.cpp:167-174: negative floats -> OOB, else floor to cell."""
    neg = (fx < 0) | (fy < 0)
    val = get_obj(state, torch.floor(fx).to(I32), torch.floor(fy).to(I32))
    return torch.where(neg, _per_env(state.out_of_bounds_object, val), val)


def set_obj(state: EnvState, x, y, obj) -> EnvState:
    """Write ``obj`` at cell (x, y) of every env (x, y, obj: (N,))."""
    N, H, W = state.grid.shape
    grid = state.grid.clone().reshape(N, H * W)
    flat = (torch.as_tensor(y).to(torch.int64) * W + torch.as_tensor(x).to(torch.int64))
    flat = flat.expand(N)[:, None]
    obj = torch.as_tensor(obj, device=grid.device).to(I32).expand(N)[:, None]
    grid.scatter_(1, flat, obj)
    return state.replace(grid=grid.reshape(N, H, W))


def fill_rect(grid, x, y, dx, dy, v):
    """fill_elem: ``grid[y:y+dy, x:x+dx] = v`` in every env of an (N, H, W)
    grid; origins and sizes are (N,) tensors or numbers, and a size <= 0
    fills nothing."""
    N, H, W = grid.shape
    xs = torch.arange(W, device=grid.device)[None, None, :]
    ys = torch.arange(H, device=grid.device)[None, :, None]
    x, y, dx, dy = (_per_env(t, grid) if isinstance(t, torch.Tensor) else t for t in (x, y, dx, dy))
    m = (xs >= x) & (xs < x + dx) & (ys >= y) & (ys < y + dy)
    return torch.where(m, v, grid)


# ---------------------------------------------------------------------------
# sub_step / basic_step_object
# ---------------------------------------------------------------------------


def check_physics_features(gd):
    """Raise for the sub-step features no ported game needs yet."""
    if gd.uses_entity_reflect and gd.uses_entity_push:
        raise NotImplementedError(
            f"procgen_torch: {gd.name}: the entity-reflect sweep with push is "
            "not ported (no game of the reference package uses it)"
        )
    if gd.uses_entity_block and not gd.uses_entity_push:
        raise NotImplementedError(
            f"procgen_torch: {gd.name}: entity blocking without push is not "
            "ported (no game of the reference package uses it)"
        )


def _corner_probes(gd, cfg, state, obj, nx, ny, is_horizontal):
    """The 4 corner probes at +-0.98*r (bag.cpp:276): whether any is
    blocked (N, M), and the probed cell types (N, 4, M)."""
    rxm = obj["rx"] * SUB_STEP_MARGIN
    rym = obj["ry"] * SUB_STEP_MARGIN
    px = torch.stack([nx + rxm * d for d in (-1.0, -1.0, 1.0, 1.0)], 1)  # (N, 4, M)
    py = torch.stack([ny + rym * d for d in (-1.0, 1.0, -1.0, 1.0)], 1)
    t = get_obj_from_floats(state, px, py)
    src_type = obj["type"][:, None, :]
    block = gd.is_blocked(cfg, state, src_type, t, is_horizontal[:, None, :]).any(1)
    return block, t


def _entity_push(gd, cfg, state, idxs, obj, nx, ny, nvx, nvy, is_horizontal,
                 active, n_live):
    """The vectorized push/block branch (bag.cpp:240-268, 335-369 as the
    reference package runs it): every mover (per-env slots ``idxs`` (N, M))
    against the first ``n_live`` slots at once (slots past the live count of
    every env are dead and never block).  The lowest-index blocker gives the clamp; the
    pushed position re-probes the grid.  Returns (state, nx, ny, nvx, nvy,
    block2)."""
    ents = state.ents
    E = n_live
    bl = {f: getattr(ents, f)[:, :E] for f in ("x", "y", "rx", "ry", "type", "image_theme")}
    ok = (ents.alive & ~ents.will_erase)[:, :E]
    slot = torch.arange(E, device=nx.device)
    valid = ok[:, None, :] & (slot[None, None, :] != idxs[:, :, None])  # (N, M, E)
    coll = (
        (torch.abs(nx[..., None] - bl["x"][:, None, :])
         < obj["rx"][..., None] + bl["rx"][:, None, :] + POS_EPS)
        & (torch.abs(ny[..., None] - bl["y"][:, None, :])
           < obj["ry"][..., None] + bl["ry"][:, None, :] + POS_EPS)
    )
    tgt = {f: bl[f][:, None, :] for f in ("type", "image_theme", "y", "ry")}
    blocked_mat = valid & coll & gd.is_blocked_ents_vals(
        cfg, state, obj["type"][..., None], tgt, is_horizontal[..., None]
    )
    block2 = blocked_mat.any(-1)
    m = first_true(blocked_mat)  # (N, M) lowest blocking slot, 0 if none
    blk = {f: torch.gather(bl[f], 1, m) for f in ("x", "y", "rx", "ry")}
    rsx = blk["rx"] + obj["rx"]
    rsy = blk["ry"] + obj["ry"]
    push_dx = blk["x"] + fm.fsign(nx - blk["x"]) * rsx - nx
    push_dy = blk["y"] + fm.fsign(ny - blk["y"]) * rsy - ny
    pxp = nx + torch.where(is_horizontal, push_dx, 0.0)
    pyp = ny + torch.where(is_horizontal, 0.0, push_dy)
    gblock, _ = _corner_probes(gd, cfg, state, obj, pxp, pyp, is_horizontal)
    rx, ry = obj["rx"], obj["ry"]
    pcl_x = torch.where(push_dx > 0, torch.floor(pxp + rx) - rx, torch.ceil(pxp - rx) + rx)
    pcl_y = torch.where(push_dy > 0, torch.floor(pyp + ry) - ry, torch.ceil(pyp - ry) + ry)
    gs = state.grid_step[:, None]
    pcl_x = torch.where(gs, nx, pcl_x)
    pcl_y = torch.where(gs, ny, pcl_y)
    pxp = torch.where(gblock & is_horizontal, pcl_x, pxp)
    pyp = torch.where(gblock & ~is_horizontal, pcl_y, pyp)
    appb = block2 & active
    nx = torch.where(appb, pxp, nx)
    ny = torch.where(appb, pyp, ny)
    nvx = torch.where(appb & is_horizontal, 0.0, nvx)
    nvy = torch.where(appb & ~is_horizontal, 0.0, nvy)
    state = gd.note_entity_blocks(
        cfg, state, idxs, blocked_mat & active[..., None], is_horizontal
    )
    return state, nx, ny, nvx, nvy, block2


def _entity_reflect(gd, cfg, state, idxs, obj, nx, ny, nvx, nvy, _vx, _vy,
                    is_horizontal, active, slots):
    """The sequential entity sweep of sub_step without push (bag.cpp:335-369
    as the reference package runs it): slots in descending order, each
    reflection moving the mover before the next slot is tested, all movers
    (N, M) at once against the table as it stood before the sub-step.
    ``slots``: the slots that can block or reflect some mover in some env,
    descending (the others change nothing).  No game with this sweep
    observes entity blocks (``note_entity_blocks``).  Returns (nx, ny, nvx,
    nvy, block2)."""
    ents = state.ents
    block2 = torch.zeros_like(active)
    for b in slots:
        valid = (ents.alive[:, b] & ~ents.will_erase[:, b])[:, None] & (idxs != b)
        bx, by, brx, bry = (getattr(ents, f)[:, b:b + 1] for f in ("x", "y", "rx", "ry"))
        hit = valid & (
            (torch.abs(nx - bx) < obj["rx"] + brx + POS_EPS)
            & (torch.abs(ny - by) < obj["ry"] + bry + POS_EPS)
        )
        tgt = {f: getattr(ents, f)[:, b:b + 1] for f in ("type", "image_theme", "y", "ry")}
        blocked_m = hit & gd.is_blocked_ents_vals(cfg, state, obj["type"], tgt, is_horizontal)
        refl = hit & ~blocked_m & gd.will_reflect(cfg, state, obj["type"], tgt["type"])
        bounce_dx = torch.where(_vx > 0, -2 * (brx + obj["rx"] - (bx - nx)),
                                2 * (brx + obj["rx"] + (bx - nx)))
        bounce_dy = torch.where(_vy > 0, -2 * (bry + obj["ry"] - (by - ny)),
                                2 * (bry + obj["ry"] + (by - ny)))
        app = refl & active
        nx = torch.where(app & is_horizontal, nx + bounce_dx, nx)
        ny = torch.where(app & ~is_horizontal, ny + bounce_dy, ny)
        nvx = torch.where(app & is_horizontal, -nvx, nvx)
        nvy = torch.where(app & ~is_horizontal, -nvy, nvy)
        block2 = block2 | blocked_m
    return nx, ny, nvx, nvy, block2


def sub_step(gd, cfg, state: EnvState, idxs, _vx, _vy, active, n_live=None,
             reflect_slots=()):
    """One axis-separated sub-step (bag.cpp:270-372) for entity slots
    ``idxs`` (M ints, or per-env slots (N, M)), all at once.
    ``_vx``/``_vy``/``active``: (N, M).  ``n_live``: a bound on the live
    slots of every env (the push branch tests blockers below it; None = the
    whole table).  ``reflect_slots``: the slots the entity-reflect sweep
    tests, descending.  Returns (state, blocked (N, M))."""
    check_physics_features(gd)
    obj = eo.read_slots(
        state.ents, idxs, ("x", "y", "vx", "vy", "rx", "ry", "type", "will_erase")
    )
    active = active & ~obj["will_erase"]

    # "nx = obj->x + _vx" (bag.cpp:274-275): the add rounds separately from
    # the caller's vx * pct product
    nx = fm.fadd32(cfg, obj["x"], _vx)
    ny = fm.fadd32(cfg, obj["y"], _vy)
    is_horizontal = _vx != 0  # (N, M)

    block, t2 = _corner_probes(gd, cfg, state, obj, nx, ny, is_horizontal)
    reflect = gd.will_reflect(cfg, state, obj["type"][:, None, :], t2).any(1)

    # Reflection off grid (bag.cpp:292-315)
    rx, ry = obj["rx"], obj["ry"]
    delta_x = torch.where(
        _vx < 0,
        torch.ceil(nx - rx) - (nx - rx),
        torch.floor(nx + rx) - (nx + rx),
    )
    delta_y = torch.where(
        _vy < 0,
        torch.ceil(ny - ry) - (ny - ry),
        torch.floor(ny + ry) - (ny + ry),
    )
    refl_x = torch.where(is_horizontal, nx + 2 * delta_x, nx)
    refl_y = torch.where(is_horizontal, ny, ny + 2 * delta_y)

    # Blocking clamp (bag.cpp:316-330)
    gs = state.grid_step[:, None]
    clamp_x = torch.where(
        gs,
        obj["x"],
        torch.where(_vx > 0, torch.floor(nx + rx) - rx, torch.ceil(nx - rx) + rx),
    )
    clamp_y = torch.where(
        gs,
        obj["y"],
        torch.where(_vy > 0, torch.floor(ny + ry) - ry, torch.ceil(ny - ry) + ry),
    )

    do_block = block & ~reflect
    nx = torch.where(
        reflect, refl_x, torch.where(do_block & is_horizontal, clamp_x, nx)
    )
    ny = torch.where(
        reflect, refl_y, torch.where(do_block & ~is_horizontal, clamp_y, ny)
    )
    nvx = torch.where(reflect & is_horizontal, -obj["vx"], obj["vx"])
    nvy = torch.where(reflect & ~is_horizontal, -obj["vy"], obj["vy"])

    if gd.block_zeroes_velocity_types:
        # ninja's is_blocked zeroes a throwing star's velocity when a wall
        # probe blocks it (ninja.cpp:139-152): both components stop
        zmask = torch.zeros_like(block)
        for t_ in gd.block_zeroes_velocity_types:
            zmask = zmask | (obj["type"] == t_)
        stopped = block & zmask & active
        nvx = torch.where(stopped, 0.0, nvx)
        nvy = torch.where(stopped, 0.0, nvy)

    if gd.uses_entity_push:
        state, nx, ny, nvx, nvy, block2 = _entity_push(
            gd, cfg, state, idxs, obj, nx, ny, nvx, nvy, is_horizontal, active,
            state.ents.capacity if n_live is None else n_live,
        )
        block = block | block2
    elif gd.uses_entity_reflect:
        with telemetry.span(REFLECT_SPAN):
            nx, ny, nvx, nvy, block2 = _entity_reflect(
                gd, cfg, state, idxs, obj, nx, ny, nvx, nvy, _vx, _vy, is_horizontal,
                active, reflect_slots,
            )
        block = block | block2

    ents = eo.write_slots_masked(
        state.ents, idxs, active, x=nx, y=ny, vx=nvx, vy=nvy
    )
    return state.replace(ents=ents), active & block


def basic_step_object(gd, cfg, state: EnvState, idxs, active=None, n_live=None,
                      reflect_slots=()) -> EnvState:
    """bag.cpp:593-656 for entity slots ``idxs`` (M ints, or per-env slots
    (N, M)), stepped together.  The sub-step loop stops after the largest
    sub-step count of an active mover, read once per call: in every later
    iteration no mover acts, so nothing is written and no count changes.
    ``n_live``, ``reflect_slots``: see ``sub_step``."""
    M = idxs.shape[1] if isinstance(idxs, torch.Tensor) else len(idxs)
    N = state.num_envs
    dev = state.done.device
    if active is None:
        active = torch.ones((N, M), dtype=torch.bool, device=dev)
    obj0 = eo.read_slots(state.ents, idxs, ("vx", "vy", "type", "will_erase"))
    vx0, vy0 = obj0["vx"], obj0["vy"]
    active = active & ~obj0["will_erase"]

    # "int(4 * sqrt(vx*vx + vy*vy))": f32 squares and sum, DOUBLE sqrt and
    # "4 * ..." before the int truncation (bag.cpp:601); "float pct = 1.0 /
    # num_sub_steps" is a double division narrowed on assignment (:606)
    s2 = vx0 * vx0 + vy0 * vy0
    if cfg.parity_mode:
        nss = (4 * torch.sqrt(s2.double())).to(I32)
    else:
        nss = (4 * fm.sqrt32(s2)).to(I32)
    nss = torch.clamp(nss, min=4)
    nss = torch.where(state.grid_step[:, None], 1, nss)
    nss = torch.clamp(nss, max=gd.max_substeps)  # static safety cap
    if cfg.parity_mode:
        pct = (1.0 / nss.double()).to(F32)
    else:
        pct = 1.0 / nss.to(F32)

    cmp = torch.abs(vx0) - torch.abs(vy0)
    sri_even = (state.step_rand_int % 2 == 0)[:, None]
    step_x_first = torch.where(cmp == 0, sri_even, cmp > 0)
    is_player = obj0["type"] == O.PLAYER
    avx = state.action_vx[:, None]
    avy = state.action_vy[:, None]
    step_x_first = torch.where(is_player & (avx != 0), True, step_x_first)
    step_x_first = torch.where(is_player & (avy != 0), False, step_x_first)

    zero = torch.zeros((N, M), dtype=F32, device=dev)
    vx_pct, vy_pct = zero, zero
    broke = torch.zeros((N, M), dtype=torch.bool, device=dev)
    telemetry.count("host_reads.physics.substeps")
    for s in range(int(torch.where(active, nss, 0).max())):
        act = active & (s < nss) & ~broke
        cur = eo.read_slots(state.ents, idxs, ("vx", "vy"))
        vx = cur["vx"] * pct
        vy = cur["vy"] * pct
        # first pass moves along x if step_x_first else y; second the other
        a1x = torch.where(step_x_first, vx, 0.0)
        a1y = torch.where(step_x_first, 0.0, vy)
        state, b1 = sub_step(gd, cfg, state, idxs, a1x, a1y, act, n_live, reflect_slots)
        # the reference evaluates "obj->vx * pct" at each sub_step call
        # (bag.cpp:634-638): re-read after the first axis
        cur2 = eo.read_slots(state.ents, idxs, ("vx", "vy"))
        a2x = torch.where(step_x_first, 0.0, cur2["vx"] * pct)
        a2y = torch.where(step_x_first, cur2["vy"] * pct, 0.0)
        state, b2 = sub_step(gd, cfg, state, idxs, a2x, a2y, act, n_live, reflect_slots)
        block_x = torch.where(step_x_first, b1, b2)
        block_y = torch.where(step_x_first, b2, b1)
        vx_pct = vx_pct + torch.where(act & ~block_x, 1.0, 0.0)
        vy_pct = vy_pct + torch.where(act & ~block_y, 1.0, 0.0)
        broke = broke | (block_x & block_y)

    nss_f32 = nss.to(F32)
    cur = eo.read_slots(state.ents, idxs, ("vx", "vy"))
    # "vx_pct / num_sub_steps" is an IEEE f32 division (bag.cpp:651-652)
    new_vx = cur["vx"] * fm.fdiv(cfg, vx_pct, nss_f32)
    new_vy = cur["vy"] * fm.fdiv(cfg, vy_pct, nss_f32)
    ents = eo.write_slots_masked(state.ents, idxs, active, vx=new_vx, vy=new_vy)
    return state.replace(ents=ents)


def entity_euler_step_all(ents, mask):
    """Entity::step (entity.cpp:57-82) over the masked (N, E) slots."""
    move = mask & ~ents.smart_step
    life_time = torch.where(mask, ents.life_time + 1, ents.life_time)
    expired = mask & (ents.expire_time > 0) & (life_time > ents.expire_time)
    bump = mask & (ents.type == O.EXPLOSION) & (ents.image_type < O.EXPLOSION5)
    return ents.replace(
        x=torch.where(move, ents.x + ents.vx, ents.x),
        y=torch.where(move, ents.y + ents.vy, ents.y),
        rotation=torch.where(mask, ents.rotation + ents.vrot, ents.rotation),
        vx=torch.where(mask, ents.vx * ents.friction, ents.vx),
        vy=torch.where(mask, ents.vy * ents.friction, ents.vy),
        life_time=life_time,
        will_erase=ents.will_erase | expired,
        image_type=torch.where(bump, ents.image_type + 1, ents.image_type),
        rx=torch.where(mask, ents.rx * ents.grow_rate, ents.rx),
        ry=torch.where(mask, ents.ry * ents.grow_rate, ents.ry),
        alpha=torch.where(mask, ents.alpha_decay * ents.alpha, ents.alpha),
    )


def step_entities(gd, cfg, state: EnvState) -> EnvState:
    """bag.cpp:1086-1098.

    Non-smart entities Euler-step as one vector op (their updates commute
    and none of them moves during the smart phase).  Smart entities then
    sub-step together: no ported game lets one smart entity block, reflect
    off or push another, so the reference's reverse slot order has no
    observable effect (audited per game in the reference package's
    physics.step_entities).  The smart movers: chaser's enemies (grid
    blocking only), coinrun's walking enemies (crates, which are not smart,
    and the grid), ninja's throwing stars, which ``is_blocked`` tests
    against grid cell types only, so neither a star nor the agent blocks or
    pushes another smart entity, caveflyer's enemies (they reflect off the
    grid only: no entity has a reflecting type) and dodgeball's enemies,
    which reflect off its lava walls, non-smart entities that do not move
    during the smart phase.  When the agent is the only smart entity it
    takes the sub-step path alone (slot 0, stepped last).

    The movers are cut to the batch's largest smart count, read once per
    step with the push branch's live count and the reflect sweep's slots
    (exact: movers past an env's smart count never act)."""
    ents = state.ents
    E = ents.capacity
    slot = torch.arange(E, device=ents.x.device)
    if gd.agent_only_smart:
        others = ents.alive & (slot != eo.AGENT)[None, :]
        state = state.replace(ents=entity_euler_step_all(ents, others))
        agent = [eo.AGENT]
        if gd.uses_entity_push:  # the push branch takes per-env slots (N, M)
            agent = torch.full((state.num_envs, 1), eo.AGENT, dtype=torch.int64,
                               device=slot.device)
        state = basic_step_object(gd, cfg, state, agent)
        agent_mask = (slot == eo.AGENT)[None, :] & state.ents.alive
        return state.replace(ents=entity_euler_step_all(state.ents, agent_mask))

    M = min(gd.max_smart_entities or E, E)
    state = state.replace(ents=entity_euler_step_all(ents, ents.alive & ~ents.smart_step))
    ents = state.ents
    smart_alive = ents.alive & ents.smart_step
    n_smart = smart_alive.to(I32).sum(1, keepdim=True)
    # smart slots in descending order first; a stable sort keeps the rest
    # ascending, as the reference package's argsort does
    key = torch.where(smart_alive, E - 1 - slot, 2 * E)
    order = torch.sort(key, dim=1, stable=True).indices[:, :M]
    act = slot[None, :M] < n_smart
    reads = [n_smart.max().to(torch.int64)[None]]
    if gd.uses_entity_push:
        # the push branch compares every mover with every slot: bound the
        # slots by the batch's largest live count.  Exact: live slots are a
        # prefix of the table (compact keeps survivors in front, appends go
        # to slot count) and dead slots never block.
        reads.append(ents.alive.sum(1).max()[None])
    if gd.uses_entity_reflect:
        # the slots that can block or reflect an active mover in some env;
        # the sweep skips the others, which change nothing
        mtype = torch.gather(ents.type, 1, order)[..., None]
        tgt = {f: getattr(ents, f)[:, None, :] for f in ("type", "image_theme", "y", "ry")}
        horiz = torch.ones_like(act)[..., None]
        can = gd.will_reflect(cfg, state, mtype, tgt["type"])
        for h in (horiz, ~horiz):
            can = can | gd.is_blocked_ents_vals(cfg, state, mtype, tgt, h)
        ok = (ents.alive & ~ents.will_erase)[:, None, :] & (order[..., None] != slot)
        reads.append((can & ok & act[..., None]).any(1).any(0).to(torch.int64))
    telemetry.count("host_reads.physics.mover_counts")
    vals = torch.cat(reads).tolist()
    M = min(M, max(vals[0], 1))
    n_live = vals[1] if gd.uses_entity_push else None
    reflect_slots = ()
    if gd.uses_entity_reflect:
        reflect_slots = [b for b in range(E - 1, -1, -1) if vals[-E + b]]
    state = basic_step_object(gd, cfg, state, order[:, :M], active=act[:, :M],
                              n_live=n_live, reflect_slots=reflect_slots)
    return state.replace(ents=entity_euler_step_all(state.ents, smart_alive))


def check_grid_collisions(gd, cfg, state: EnvState, idx, active=True) -> EnvState:
    """bag.cpp:145-165 for smart entity slot ``idx`` (an int shared by all
    envs, or an (N,) int64 tensor of per-env slots): dispatch the game's
    handler over the <= 4 overlapped cells in reference order (x ascending
    outer, y ascending inner).  ``active`` (bool (N,) or True) gates the
    dispatch through the handler's ``valid``."""
    slots = idx[:, None] if isinstance(idx, torch.Tensor) else [idx]
    obj = eo.read_slots(state.ents, slots, ("x", "y", "rx", "ry"))
    ax, ay, arx, ary = (obj[f][:, 0] for f in ("x", "y", "rx", "ry"))
    # int() truncates toward zero
    min_x = (ax - (arx + POS_EPS)).to(I32)
    max_x = (ax + (arx + POS_EPS)).to(I32)
    min_y = (ay - (ary + POS_EPS)).to(I32)
    max_y = (ay + (ary + POS_EPS)).to(I32)
    for cx, cy, extra_valid in (
        (min_x, min_y, None),
        (min_x, max_y, max_y != min_y),
        (max_x, min_y, max_x != min_x),
        (max_x, max_y, (max_x != min_x) & (max_y != min_y)),
    ):
        neg = (cx < 0) | (cy < 0)
        t = torch.where(neg, state.out_of_bounds_object, get_obj(state, cx, cy))
        valid = (t != O.SPACE) & active
        if extra_valid is not None:
            valid = valid & extra_valid
        state = gd.handle_grid_collision(cfg, state, idx, t, cx, cy, valid)
    return state
