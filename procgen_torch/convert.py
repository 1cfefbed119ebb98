"""numpy <-> port state conversion.

States cross between the two packages as flat dicts of numpy arrays keyed by
dotted field paths (``ents.x``, ``rng.key``, ``extra.maze_dim``; a
``FastState`` adds a leading ``state.``/``queue.`` and has ``queue_valid``).
MT19937 words are uint32 in numpy and int64 in the port; every other dtype
is kept.  The port never imports JAX: a caller holding a JAX pytree flattens
it with ``jax.tree_util.tree_flatten_with_path`` and hands the pairs to
``fields_from_keypaths``.

The IMPALA net's parameters cross the same way, keyed by flax's key paths
(``params.ConvSequence_0.ResidualBlock_1.Conv_0.kernel``): conv kernels are
HWIO there and OIHW here, dense kernels ``(in, out)`` there and ``(out, in)``
here.  The dense layer's 2048 inputs keep flax's (h, w, c) order, since the
port's forward flattens its activations NHWC as flax does.
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


# flax module names -> the port's ImpalaCNN attribute names
_IMPALA_DENSE = {"Dense_0": "dense", "Dense_1": "logits", "Dense_2": "value"}
_IMPALA_LEAF = {"kernel": "weight", "bias": "bias"}


def _impala_key(path: str) -> str:
    """``params.ConvSequence_0.ResidualBlock_1.Conv_0.kernel`` ->
    ``seqs.0.res1.conv0.weight`` (``params.Dense_1.bias`` -> ``logits.bias``)."""
    root, *mods, leaf = path.split(".")
    if root != "params":
        raise KeyError(f"not an ImpalaCNN parameter path: {path}")
    out = []
    for m in mods:
        kind, idx = m.rsplit("_", 1)
        if kind == "ConvSequence":
            out.append(f"seqs.{idx}")
        elif kind == "ResidualBlock":
            out.append(f"res{idx}")
        elif kind == "Conv":  # a sequence's own conv, or a block's two
            out.append("conv" if len(mods) == 2 else f"conv{idx}")
        else:
            out.append(_IMPALA_DENSE[m])
    return ".".join(out + [_IMPALA_LEAF[leaf]])


def _impala_layout(a: np.ndarray) -> np.ndarray:
    """flax kernel layout -> the port's (biases unchanged)."""
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a


def impala_params_from_numpy(flat: dict) -> dict:
    """{flax key path: np.ndarray} (see ``fields_from_keypaths``) -> a
    state_dict for ``learn.nets.ImpalaCNN.load_state_dict``."""
    return {
        _impala_key(k): torch.from_numpy(np.ascontiguousarray(_impala_layout(np.array(v))))
        for k, v in flat.items()
    }


def impala_params_to_numpy(module) -> dict:
    """The inverse: an ImpalaCNN's parameters as {flax key path: np.ndarray}
    in flax's layouts."""
    sd = module.state_dict()
    out = {}
    for k in _impala_paths(len(module.seqs)):
        a = sd[_impala_key(k)].detach().cpu().numpy()
        if a.ndim == 4:  # OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        out[k] = np.ascontiguousarray(a.T if a.ndim == 2 else a)
    return out


def _impala_paths(n_seqs: int) -> list:
    """flax's key paths of an ImpalaCNN with ``n_seqs`` conv sequences."""
    mods = []
    for i in range(n_seqs):
        mods.append(f"ConvSequence_{i}.Conv_0")
        mods += [f"ConvSequence_{i}.ResidualBlock_{j}.Conv_{k}" for j in range(2) for k in range(2)]
    mods += list(_IMPALA_DENSE)
    return [f"params.{m}.{leaf}" for m in mods for leaf in _IMPALA_LEAF]
