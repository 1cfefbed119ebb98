"""Float-arithmetic parity helpers (counterpart of ``procgen_tpu/fmath.py``).

The reference is C++ with ``float`` storage, but several expressions mix in
``double`` literals (e.g. ``agent->vx = .9 * agent->vx``,
basic-abstract-game.cpp:682-684), which promote to double and narrow on
assignment.  With ``cfg.parity_mode`` those sites compute in float64 and
narrow; otherwise they compute in float32.

Eager PyTorch runs every op as its own kernel, so a multiply and a following
add always round separately (the reference is built without FMA) and a
division is IEEE-rounded.  ``fmuladd32``, ``fadd32`` and ``seq`` therefore
need no pinning here; they keep the reference's names so call sites line up.
Never route these through ``addcmul``, ``lerp`` or ``torch.compile``.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
F64 = torch.float64


def f32(c) -> float:
    """A Python constant rounded to float32 (the C++ ``float`` literal)."""
    return float(np.float32(c))


def _t(x, dtype=F32) -> torch.Tensor:
    return torch.as_tensor(x).to(dtype)


def dmul(cfg, a, c):
    """float32( double(a) * c ) in parity mode; float32 multiply otherwise."""
    if cfg.parity_mode:
        return (_t(a, F64) * float(c)).to(F32)
    return _t(a) * f32(c)


def dadd(cfg, a, c):
    if cfg.parity_mode:
        return (_t(a, F64) + float(c)).to(F32)
    return _t(a) + f32(c)


def wide(cfg, x):
    """Promote a C++ ``float`` operand to double for a parity-mode mixed
    expression; identity float32 on the fast path."""
    x = _t(x)
    return x.to(F64) if cfg.parity_mode else x


def narrow(x):
    """Round a (possibly float64) expression result back to the C++ float."""
    return _t(x, F32)


def fdiv(cfg, a, b):
    """IEEE-rounded float32 division (float64 then narrowed in parity mode,
    as the reference package does)."""
    if cfg.parity_mode:
        return (_t(a).to(F64) / _t(b).to(F64)).to(F32)
    return _t(a) / _t(b)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE float32 ``x / c`` for a constant divisor.  PyTorch's CUDA
    division by a CPU scalar multiplies by the reciprocal instead, which is
    up to 1 ulp off, so the divisor is made a tensor on ``x``'s device."""
    return x / torch.full((), f32(c), dtype=F32, device=x.device)


def seq(cfg, x):
    """Pin an intermediate's float32 rounding in a constant chain.  Eager ops
    are never reassociated, so this is the identity."""
    return x


def dmuladd(cfg, a, c, b):
    """float32( float(b) + c * double(a) ), the shape of
    ``float x = b + .2 * rand01()`` (e.g. fruitbot.cpp:170)."""
    if cfg.parity_mode:
        return (_t(b).to(F64) + float(c) * _t(a, F64)).to(F32)
    return (b if isinstance(b, torch.Tensor) else f32(b)) + f32(c) * _t(a)


def fmuladd32(cfg, r, scale, off):
    """``r * scale + off`` with separate float32 roundings (no FMA)."""
    return _t(r) * _t(scale) + _t(off)


def fadd32(cfg, a, b):
    """``a + b`` of two float32 products whose roundings must stay pinned."""
    return _t(a) + _t(b)


def dcos_np(x) -> np.ndarray:
    """C++ ``cos(float)`` of the double overload, narrowed at a float store:
    ``float(cos(double(x)))`` for float32 ``x``, on the host.  Callers with
    a handful of angles (ninja's stars) tabulate it, so the card and the CPU
    read the same bits (their float trig differs in the last bit)."""
    return np.cos(np.asarray(x, np.float32).astype(np.float64)).astype(np.float32)


def dsin_np(x) -> np.ndarray:
    return np.sin(np.asarray(x, np.float32).astype(np.float64)).astype(np.float32)


def atan2_wide(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``atan2`` computed in float64 and narrowed.  The card and the
    CPU agree except where the double result lies within a few of its ulps
    of a float32 rounding boundary (jumper's compass, which has no
    reference bits: it approximates Qt's antialiased drawing)."""
    return torch.atan2(y.to(F64), x.to(F64)).to(F32)


def cos_wide(x: torch.Tensor) -> torch.Tensor:
    """float32 ``cos`` computed in float64 and narrowed (see atan2_wide)."""
    return torch.cos(x.to(F64)).to(F32)


def sin_wide(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.to(F64)).to(F32)


def fsign(x: torch.Tensor) -> torch.Tensor:
    """cpp-utils.h:42-44 ``sign()``: +1 / 0 / -1 as float32, where the 0
    branch covers both IEEE zeros and returns +0.0 (``torch.sign`` keeps
    -0.0, which would diverge wherever sign() feeds a float chain, e.g.
    chaser's velocity re-normalization, chaser.cpp:85-86)."""
    return torch.where(
        x > 0, 1.0, torch.where(x == 0, 0.0, -1.0)
    ).to(F32)
