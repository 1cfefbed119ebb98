"""RandGen collection helpers (reference randgen.cpp:33-88); counterpart of
``procgen_tpu/engine/rand_util.py``, batched over a leading env axis N.

Every helper draws through ``rs`` (an MT state or an open MTBlock) with
per-env ``active`` masks, so each env consumes exactly the reference's
stream.  A rejection loop stops early once no env is still redrawing: the
remaining iterations of the reference package's fixed-count loop draw
nothing and change nothing.
"""

from __future__ import annotations

import torch

from procgen_torch import rng as R
from procgen_torch.state import I32


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (``jnp.argmax`` over a bool mask), as int64."""
    K = mask.shape[-1]
    pos = torch.arange(K, device=mask.device)
    idx = torch.where(mask, pos, K).amin(-1)
    return torch.where(idx == K, 0, idx)


def choose_nth_masked(mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Index of the n-th True of each row of ``mask`` (N, K) in ascending
    order, 0 where there is none; mirrors indexing into a vector built by an
    ascending filter scan (e.g. get_cells_with_type).  Returns int64 (N,)."""
    pos = torch.cumsum(mask.to(I32), -1) - 1
    return first_true(mask & (pos == n.to(I32)[..., None]))


def _rejection_pick(rs, in_set, high, active):
    """One pick of simple_choose: a draw in [0, high), redrawn (at most 16
    times) while it hits ``in_set`` (N, n).  Returns (rs, pick int32 (N,))."""
    rs, nxt = R.rs_randn(rs, high, active=active)
    act = active
    for _ in range(16):
        hit = torch.gather(in_set, 1, nxt.to(torch.int64)[:, None])[:, 0]
        act = act & hit
        if not bool(act.any()):
            break
        rs, nxt2 = R.rs_randn(rs, high, active=act)
        nxt = torch.where(act, nxt2, nxt)
    return rs, nxt


def simple_choose(rs, n: int, k: int):
    """randgen.cpp:70-88: draw ``k`` distinct values in [0, n) by rejection
    (each pick redrawn at most 16 times, as the reference package bounds
    it).  Returns (rs, chosen int32 (N, k))."""
    batch = rs.cursor if isinstance(rs, R.MTBlock) else rs.pos
    N, dev = batch.shape[0], batch.device
    in_set = torch.zeros((N, n), dtype=torch.bool, device=dev)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    picks = []
    for _ in range(k):
        rs, nxt = _rejection_pick(rs, in_set, n, active)
        picks.append(nxt)
        in_set.scatter_(1, nxt.to(torch.int64)[:, None], True)
    return rs, torch.stack(picks, 1).to(I32)


def simple_choose_dyn(rs, n, k, n_max: int, k_max: int):
    """simple_choose with per-env ``n`` (N,) (<= n_max) and ``k`` (N,) or
    int (<= k_max).  Returns (rs, chosen int32 (N, k_max)); entries past k
    are 0."""
    n = torch.as_tensor(n)
    N, dev = n.shape[0], n.device
    in_set = torch.zeros((N, n_max), dtype=torch.bool, device=dev)
    n1 = n.to(I32).clamp(min=1)
    chosen = []
    for i in range(k_max):
        if isinstance(k, int):
            active0 = torch.full((N,), i < k, dtype=torch.bool, device=dev)
        else:
            active0 = i < k
        rs, nxt = _rejection_pick(rs, in_set, n1, active0)
        chosen.append(torch.where(active0, nxt, 0))
        cell = nxt.to(torch.int64)[:, None]
        in_set.scatter_(1, cell, torch.gather(in_set, 1, cell) | active0[:, None])
    return rs, torch.stack(chosen, 1).to(I32)


def partition(rs, x, n: int, x_max: int):
    """randgen.cpp:33-41: drop ``x`` (N,) balls into ``n`` buckets; ``x`` <=
    x_max.  Returns (rs, counts int32 (N, n))."""
    x = torch.as_tensor(x)
    N, dev = x.shape[0], x.device
    counts = torch.zeros((N, n), dtype=I32, device=dev)
    for i in range(x_max):
        active = i < x
        rs, b = R.rs_randn(rs, n, active=active)
        counts.scatter_add_(1, b.to(torch.int64)[:, None], active.to(I32)[:, None])
    return rs, counts


def choose_n_erase(rs, mask, k_max: int, k):
    """randgen.cpp:49-68 (choose_n) over the True positions of each row of
    ``mask`` (N, K) in ascending order: repeatedly pick a random remaining
    element and remove it.  ``k`` (N,) or int, <= k_max.  Returns (rs,
    picks int32 (N, k_max), count (N,)).  If k exceeds the row's popcount the
    reference returns every element in order; count == popcount then."""
    N, K = mask.shape
    dev = mask.device
    if isinstance(k, int):
        k = torch.full((N,), k, dtype=I32, device=dev)
    size0 = mask.to(I32).sum(1)
    take_all = k > size0
    count = torch.where(take_all, size0, k.to(I32))
    mask = mask.clone()
    picks = torch.zeros((N, k_max), dtype=torch.int64, device=dev)
    for i in range(k_max):
        remaining = mask.to(I32).sum(1)
        active = (i < count) & ~take_all
        rs, n = R.rs_randn(rs, remaining.clamp(min=1), active=active)
        idx = choose_nth_masked(mask, n)
        picks[:, i] = torch.where(active, idx, picks[:, i])
        hit = torch.nn.functional.one_hot(idx, K).bool() & active[:, None]
        mask = mask & ~hit
    # take-all path: the elements in ascending order (0-filled), from the
    # untouched mask (no draw removed anything on that path)
    pos = torch.arange(K, device=dev)
    order = torch.sort(torch.where(mask, pos, K + pos), dim=1, stable=True).values
    ascending = torch.where(order < K, order, 0)
    if K < k_max:
        ascending = torch.nn.functional.pad(ascending, (0, k_max - K))
    picks = torch.where(take_all[:, None], ascending[:, :k_max], picks)
    return rs, picks.to(I32), count
