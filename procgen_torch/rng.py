"""Bit-exact, batch-vectorized MT19937 in PyTorch.

Counterpart of ``procgen_tpu/rng.py``: the reference environment draws every
piece of level generation and per-step randomness from ``std::mt19937``
wrapped by ``RandGen`` (procgen/src/randgen.{h,cpp}), so trajectory parity
needs the exact 32-bit output sequence and the exact derivations
(``randint`` = modulo, ``rand01`` = double division, ...).

The generator state is a pair of tensors with a leading batch axis:

  * ``key``  -- int64[..., 624]  the raw Mersenne words, each in [0, 2**32)
  * ``pos``  -- int32[...]       next word to read (624 == twist required)

PyTorch's uint32 support is partial, so words live in int64.  XOR, AND and
right shifts keep a word inside 32 bits; every multiply and left shift is
followed by ``& 0xFFFFFFFF`` (or by an AND with a 32-bit constant).  Each
draw takes an optional ``active`` mask: inactive streams return a value the
caller discards and do not advance.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

N = 624
M = 397
MASK32 = 0xFFFFFFFF
MATRIX_A = 0x9908B0DF
UPPER_MASK = 0x80000000
LOWER_MASK = 0x7FFFFFFF
SEED_MULT = 1812433253
TEMPER_B = 0x9D2C5680
TEMPER_C = 0xEFC60000

# float(2**-32): scaling by an exact power of two commutes with rounding, so
# float32(x) * 2^-32 equals float32(double(x) / 2^32), the expression of
# RandGen::rand01 (randgen.cpp:19-23).
_INV_2_32 = float(2.0**-32)


@dataclasses.dataclass
class MT:
    """Batched MT19937 state (leading batch dims on both tensors)."""

    key: torch.Tensor  # int64[..., 624]
    pos: torch.Tensor  # int32[...]

    def replace(self, **kw) -> "MT":
        return dataclasses.replace(self, **kw)


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 value to int32 two's complement (C++ int conversion)."""
    return (((v & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _i64(v):
    """A Python int stays a Python int (no host-to-device copy); a tensor
    becomes int64."""
    return v.to(torch.int64) if isinstance(v, torch.Tensor) else int(v)


def _umod(x: torch.Tensor, m) -> torch.Tensor:
    """uint32 ``x % m`` (m an int64 tensor or Python int in [0, 2**32)) with
    ``x % 0 == 0``, as ``jnp.remainder`` gives (a discarded draw of an
    inactive stream may see m == 0)."""
    if not isinstance(m, torch.Tensor):
        return x % m if m else torch.zeros_like(x)
    zero = m == 0
    return torch.where(zero, 0, x % torch.where(zero, torch.ones_like(m), m))


def mt_seed(seed) -> MT:
    """``std::mt19937::seed`` for a batch of int32 seeds (randgen.cpp:95-98):
    mt[i] = 1812433253 * (mt[i-1] ^ (mt[i-1] >> 30)) + i."""
    seed = torch.as_tensor(seed)
    key = torch.empty(seed.shape + (N,), dtype=torch.int64, device=seed.device)
    cur = seed.to(torch.int64) & MASK32
    key[..., 0] = cur
    for i in range(1, N):
        cur = (SEED_MULT * (cur ^ (cur >> 30)) + i) & MASK32
        key[..., i] = cur
    pos = torch.full(seed.shape, N, dtype=torch.int32, device=seed.device)
    return MT(key=key, pos=pos)


def _twist_word(y: torch.Tensor) -> torch.Tensor:
    return (y >> 1) ^ torch.where((y & 1).bool(), MATRIX_A, 0)


def _twist(key: torch.Tensor) -> torch.Tensor:
    """One full MT19937 twist over the trailing 624-word axis.

    The in-place C recurrence only feeds back with lag 227, so the new words
    resolve in chunks [0, 227), [227, 454), [454, 623) and {623}."""
    nxt = torch.roll(key, -1, dims=-1)  # key[(i+1) % 624]; slot 623 fixed below
    base = _twist_word((key & UPPER_MASK) | (nxt & LOWER_MASK))
    # new[i] = src[i] ^ base[i]; src = old[i+397] for i<227, new[i-227] after.
    new_a = key[..., M:N] ^ base[..., 0 : N - M]
    new_b = new_a[..., 0 : N - M] ^ base[..., N - M : 2 * (N - M)]
    new_c = new_b[..., 0 : N - 1 - 2 * (N - M)] ^ base[..., 2 * (N - M) : N - 1]
    # i = 623: y uses the *new* word 0 (the C loop already overwrote mt[0]).
    base_last = _twist_word(
        (key[..., N - 1] & UPPER_MASK) | (new_a[..., 0] & LOWER_MASK)
    )
    # (623+397) % 624 = 396 -> new[396] = new_b[169]
    new_last = new_b[..., M - 1 - (N - M)] ^ base_last
    return torch.cat([new_a, new_b, new_c, new_last[..., None]], dim=-1)


def _temper(y: torch.Tensor) -> torch.Tensor:
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & TEMPER_B)
    y = y ^ ((y << 15) & TEMPER_C)
    return y ^ (y >> 18)


def mt_raw(mt: MT, active: Optional[torch.Tensor] = None):
    """One raw uint32 per stream (``stdgen()``); returns (mt, int64 value).

    Twists only where ``needs & active``: an inactive stream neither twists
    nor advances.  The twist is computed for the whole batch and selected
    (no host sync)."""
    needs = mt.pos >= N
    sel = needs if active is None else needs & active
    key = torch.where(sel[..., None], _twist(mt.key), mt.key)
    pos = torch.where(needs, 0, mt.pos)
    word = torch.gather(key, -1, pos[..., None].to(torch.int64))[..., 0]
    out = _temper(word)
    new_pos = pos + 1
    if active is not None:
        key = torch.where(active[..., None], key, mt.key)
        new_pos = torch.where(active, new_pos, mt.pos)
    return MT(key=key, pos=new_pos.to(torch.int32)), out


# The values of RandGen's draws from raw 32-bit outputs ``x`` (int64
# tensors): randint(low, high), randn(high), rand01().
def randint_value(x, low, high):
    low = _i64(low)
    rng_range = (_i64(high) - low) & MASK32  # uint32(high - low)
    return to_int32(low + to_int32(_umod(x, rng_range)).to(torch.int64))


def randn_value(x, high):
    return to_int32(_umod(x, _i64(high) & MASK32))


def rand01_value(x):
    return x.to(torch.float32) * _INV_2_32


def _randrange_value(r, low, high):
    """rand01() * (high - low) + low with separate float32 roundings (the
    reference is built without FMA; eager ops never contract)."""
    if not isinstance(low, torch.Tensor) and not isinstance(high, torch.Tensor):
        return r * float(np.float32(high) - np.float32(low)) + float(np.float32(low))
    low = torch.as_tensor(low, dtype=torch.float32, device=r.device)
    high = torch.as_tensor(high, dtype=torch.float32, device=r.device)
    return r * (high - low) + low


def mt_randint(mt: MT, low, high, active=None):
    """``RandGen::randint(low, high)`` = low + x % uint32(high - low)."""
    mt, x = mt_raw(mt, active)
    return mt, randint_value(x, low, high)


def mt_randn(mt: MT, high, active=None):
    """``RandGen::randn(high)`` = x % uint32(high)."""
    mt, x = mt_raw(mt, active)
    return mt, randn_value(x, high)


def mt_randint_full(mt: MT, active=None):
    """``RandGen::randint()`` = int(stdgen()) -- full width, may be negative."""
    mt, x = mt_raw(mt, active)
    return mt, to_int32(x)


def mt_rand01(mt: MT, active=None):
    """``RandGen::rand01`` = float(double(x) / 2^32) as float32 (exact)."""
    mt, x = mt_raw(mt, active)
    return mt, rand01_value(x)


def mt_randbool(mt: MT, active=None):
    mt, r = mt_rand01(mt, active)
    return mt, r > 0.5


def mt_randrange(mt: MT, low, high, active=None):
    """``RandGen::randrange`` (randgen.cpp:29-31)."""
    mt, r = mt_rand01(mt, active)
    return mt, _randrange_value(r, low, high)


# ---------------------------------------------------------------------------
# Block-prefetch API for draw-heavy sections (level generation): opening a
# block computes the twist chain once and tempers a window of up to
# ``max_draws`` upcoming outputs; a draw is then a gather and a masked cursor
# bump.  Closing commits the consumed count into an exact MT state.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MTBlock:
    vals: torch.Tensor  # int64[..., M] tempered outputs at offsets 0..M-1
    cursor: torch.Tensor  # int32[...] consumed draws
    keys: torch.Tensor  # int64[..., T, 624] twist chain (keys[0] = entry key)
    pos: torch.Tensor  # int32[...] entry position

    def replace(self, **kw) -> "MTBlock":
        return dataclasses.replace(self, **kw)


def mt_block_open(mt: MT, max_draws: int) -> MTBlock:
    """Prefetch up to ``max_draws`` outputs (an exact window of the stream)."""
    n_chain = (N + max_draws - 1) // N + 1  # keys needed incl. entry
    chain = [mt.key]
    for _ in range(n_chain - 1):
        chain.append(_twist(chain[-1]))
    keys = torch.stack(chain, dim=-2)  # (..., T, 624)
    flat = _temper(keys.reshape(keys.shape[:-2] + (n_chain * N,)))
    idx = mt.pos[..., None].to(torch.int64) + torch.arange(
        max_draws, device=mt.pos.device
    )
    vals = torch.gather(flat, -1, idx.clamp(max=n_chain * N - 1))
    return MTBlock(
        vals=vals, cursor=torch.zeros_like(mt.pos), keys=keys, pos=mt.pos
    )


def mt_block_close(blk: MTBlock) -> MT:
    """Commit the cursor: the returned MT equals drawing ``cursor`` times."""
    total = blk.pos + blk.cursor
    crossed = torch.where(
        blk.cursor > 0, torch.div(total - 1, N, rounding_mode="floor"), 0
    )
    new_pos = total - crossed * N
    T = blk.keys.shape[-2]
    sel = crossed.clamp(0, T - 1).to(torch.int64)[..., None, None]
    new_key = torch.gather(
        blk.keys, -2, sel.expand(sel.shape[:-1] + (N,))
    )[..., 0, :]
    return MT(key=new_key, pos=new_pos.to(torch.int32))


def blk_raw(blk: MTBlock, active=None):
    cur = blk.cursor.clamp(max=blk.vals.shape[-1] - 1).to(torch.int64)
    v = torch.gather(blk.vals, -1, cur[..., None])[..., 0]
    inc = 1 if active is None else torch.as_tensor(active).to(torch.int32)
    return blk.replace(cursor=(blk.cursor + inc).to(torch.int32)), v


def blk_raw_vec(blk: MTBlock, k: int):
    """Draw ``k`` consecutive raw outputs at once (e.g. caveflyer's per-cell
    noise, caveflyer.cpp:152-158)."""
    start = blk.cursor.clamp(0, max(blk.vals.shape[-1] - k, 0)).to(torch.int64)
    idx = start[..., None] + torch.arange(k, device=start.device)
    v = torch.gather(blk.vals, -1, idx)
    return blk.replace(cursor=(blk.cursor + k).to(torch.int32)), v


def blk_raw_masked(blk: MTBlock, active: torch.Tensor):
    """The raw draws of a run of ``K`` gated draws at once (``active`` (...,
    K) bool, in draw order): entry k is the value the k-th of ``K``
    consecutive ``blk_raw(blk, active[..., k])`` calls would return where
    that call is active (elsewhere it is undefined), and the cursor moves
    by the number of active entries."""
    a = active.to(torch.int64)
    offs = blk.cursor[..., None].to(torch.int64) + torch.cumsum(a, -1) - a
    v = torch.gather(blk.vals, -1, offs.clamp(max=blk.vals.shape[-1] - 1))
    return blk.replace(cursor=(blk.cursor + a.sum(-1)).to(torch.int32)), v


def rs_rand01_vec(rs: MTBlock, k: int):
    """k consecutive rand01 draws from an open block."""
    rs, x = blk_raw_vec(rs, k)
    return rs, rand01_value(x)


def blk_overflowed(blk: MTBlock) -> torch.Tensor:
    """True where more draws were consumed than prefetched."""
    return blk.cursor > blk.vals.shape[-1]


# ---------------------------------------------------------------------------
# Draw-source dispatch: levelgen and step code draw through rs_* and work
# with either a raw MT state or an open MTBlock.
# ---------------------------------------------------------------------------


def rs_raw(rs, active=None):
    if isinstance(rs, MTBlock):
        return blk_raw(rs, active)
    return mt_raw(rs, active)


def rs_randint(rs, low, high, active=None):
    rs, x = rs_raw(rs, active)
    return rs, randint_value(x, low, high)


def rs_randn(rs, high, active=None):
    rs, x = rs_raw(rs, active)
    return rs, randn_value(x, high)


def rs_randint_full(rs, active=None):
    rs, x = rs_raw(rs, active)
    return rs, to_int32(x)


def rs_rand01(rs, active=None):
    rs, x = rs_raw(rs, active)
    return rs, rand01_value(x)


def rs_randbool(rs, active=None):
    rs, r = rs_rand01(rs, active)
    return rs, r > 0.5


def rs_randrange(rs, low, high, active=None):
    rs, r = rs_rand01(rs, active)
    return rs, _randrange_value(r, low, high)


def mt_select(pred: torch.Tensor, a: MT, b: MT) -> MT:
    """Per-stream select between two MT states (pred over the batch shape)."""
    return MT(
        key=torch.where(pred[..., None], a.key, b.key),
        pos=torch.where(pred, a.pos, b.pos),
    )


# ---------------------------------------------------------------------------
# Host-side scalar generator (numpy) for asset generation and seed dealing.
# ---------------------------------------------------------------------------


class HostMT:
    """Plain-numpy scalar MT19937 with RandGen's derivations."""

    def __init__(self, seed: int):
        self.mt = np.zeros(N, dtype=np.uint32)
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.mt[0] = np.uint32(seed & MASK32)
        for i in range(1, N):
            prev = int(self.mt[i - 1])
            self.mt[i] = np.uint32((SEED_MULT * (prev ^ (prev >> 30)) + i) & MASK32)
        self.pos = N

    def _twist(self) -> None:
        mt = self.mt
        for i in range(N):
            y = (int(mt[i]) & UPPER_MASK) | (int(mt[(i + 1) % N]) & LOWER_MASK)
            mt[i] = np.uint32(
                int(mt[(i + M) % N]) ^ (y >> 1) ^ (MATRIX_A if y & 1 else 0)
            )
        self.pos = 0

    def raw(self) -> int:
        if self.pos >= N:
            self._twist()
        y = int(self.mt[self.pos])
        self.pos += 1
        y ^= y >> 11
        y ^= (y << 7) & TEMPER_B
        y ^= (y << 15) & TEMPER_C
        y ^= y >> 18
        return y

    def randint(self, low: int, high: int) -> int:
        return low + self.raw() % ((high - low) & MASK32)

    def randn(self, high: int) -> int:
        return self.raw() % (high & MASK32)

    def randint_full(self) -> int:
        return int(np.uint32(self.raw()).view(np.int32))

    def rand01(self) -> np.float32:
        return np.float32(np.float64(self.raw()) / np.float64(2**32))

    def randbool(self) -> bool:
        return bool(self.rand01() > np.float32(0.5))

    def randrange(self, low: float, high: float) -> np.float32:
        return np.float32(
            self.rand01() * (np.float32(high) - np.float32(low)) + np.float32(low)
        )
