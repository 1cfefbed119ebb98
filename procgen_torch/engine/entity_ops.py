"""Batched operations on the SoA entity table (counterpart of
``procgen_tpu/engine/entity_ops.py``).

Every field is ``(N, E)``; a slot index ``i`` is a Python int shared by all
envs.  Writes return new tensors (the caller's table is never modified).
"""

from __future__ import annotations

import torch

from procgen_torch.state import F32, I32, EntityTable

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
    """Fields of slots ``idxs`` (a list of ints) as {name: (N, M)}; direct
    indexing keeps every bit, signed zeros included."""
    return {n: getattr(ents, n)[:, idxs] for n in names}


def write_slots_masked(ents: EntityTable, idxs, mask, **updates) -> EntityTable:
    """Write (N, M) ``updates`` into slots ``idxs`` where ``mask`` (N, M)
    holds (idxs distinct)."""
    new = {}
    for name, val in updates.items():
        arr = getattr(ents, name).clone()
        arr[:, idxs] = torch.where(mask, val.to(arr.dtype), arr[:, idxs])
        new[name] = arr
    return ents.replace(**new)


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
