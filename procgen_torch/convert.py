"""numpy <-> port state conversion.

States cross between the two packages as flat dicts of numpy arrays keyed by
dotted field paths (``ents.x``, ``rng.key``, ``extra.maze_dim``; a
``FastState`` adds a leading ``state.``/``queue.`` and has ``queue_valid``).
MT19937 words are uint32 in numpy and int64 in the port; every other dtype
is kept.  The port never imports JAX: a caller holding a JAX pytree flattens
it with ``jax.tree_util.tree_flatten_with_path`` and hands the pairs to
``fields_from_keypaths``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from procgen_torch.parallel.fast import FastState
from procgen_torch.rng import MT
from procgen_torch.state import EntityTable, EnvState, tree_leaves_with_names


def _key_name(k) -> str:
    for attr in ("name", "key", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported key path entry {k!r}")


def fields_from_keypaths(pairs) -> dict:
    """[(key path, array)] (e.g. from ``tree_flatten_with_path``) -> a flat
    {dotted path: np.ndarray} dict.  Key entries are read by their ``name``,
    ``key`` or ``idx`` attribute."""
    return {".".join(_key_name(k) for k in path): np.asarray(v) for path, v in pairs}


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if a.dtype == np.int64:  # MT19937 words, in [0, 2**32)
        a = a.astype(np.uint32)
    return a


_NESTED = {"rng": MT, "level_seed_rng": MT, "asset_rng": MT, "ents": EntityTable}


def state_from_numpy(fields: dict, device, prefix: str = "") -> EnvState:
    """Build an EnvState from flat dotted-path arrays (see module doc)."""
    kw = {}
    for f in dataclasses.fields(EnvState):
        p = prefix + f.name
        if f.name in _NESTED:
            cls = _NESTED[f.name]
            kw[f.name] = cls(
                **{
                    g.name: _to_tensor(fields[f"{p}.{g.name}"], device)
                    for g in dataclasses.fields(cls)
                }
            )
        elif f.name == "extra":
            kw["extra"] = {
                k[len(p) + 1:]: _to_tensor(v, device)
                for k, v in fields.items()
                if k.startswith(p + ".")
            }
        else:
            kw[f.name] = _to_tensor(fields[p], device)
    return EnvState(**kw)


def state_to_numpy(state: EnvState, prefix: str = "") -> dict:
    """Flat {dotted path: np.ndarray} view of an EnvState."""
    return {prefix + k: _to_numpy(v) for k, v in tree_leaves_with_names(state)}


def fast_state_from_numpy(fields: dict, device) -> FastState:
    return FastState(
        state=state_from_numpy(fields, device, "state."),
        queue=state_from_numpy(fields, device, "queue."),
        queue_valid=_to_tensor(fields["queue_valid"], device),
    )


def fast_state_to_numpy(fs: FastState) -> dict:
    out = state_to_numpy(fs.state, "state.")
    out.update(state_to_numpy(fs.queue, "queue."))
    out["queue_valid"] = _to_numpy(fs.queue_valid)
    return out
