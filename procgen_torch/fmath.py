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


_LIBM = None


def libm():
    """The host C library's libm through ctypes: the functions the reference
    binary links (glibc's ``cos``/``sin`` of a double, ``atan2f``).  NumPy's
    and torch's trig are other implementations and may differ in the last
    bit (glibc's ``atan2f`` differs from a narrowed double ``atan2`` on
    about 16% of inputs)."""
    global _LIBM
    if _LIBM is None:
        import ctypes

        lib = ctypes.CDLL("libm.so.6")
        for name, arg in (("cos", ctypes.c_double), ("sin", ctypes.c_double),
                          ("atan2f", ctypes.c_float)):
            fn = getattr(lib, name)
            fn.restype = arg
            fn.argtypes = [arg] * (2 if name == "atan2f" else 1)
        _LIBM = lib
    return _LIBM


def _libm_map(name, x) -> np.ndarray:
    fn = getattr(libm(), name)
    x = np.asarray(x, np.float32)
    out = [fn(float(v)) for v in x.reshape(-1)]
    return np.asarray(out, np.float64).reshape(x.shape)


def dcos_libm(x) -> np.ndarray:
    """C++ ``cos(float)`` of the double overload, narrowed at a float store:
    ``float(cos(double(x)))`` for float32 ``x``, by the host libm.  Callers
    with a handful of angles (ninja's stars) tabulate it, so the card and
    the CPU read the same bits."""
    return _libm_map("cos", x).astype(np.float32)


def dsin_libm(x) -> np.ndarray:
    return _libm_map("sin", x).astype(np.float32)


def atan2f_libm(y, x) -> np.ndarray:
    """glibc ``atan2f`` (the float overload) of float32 arrays."""
    fn = libm().atan2f
    y, x = np.broadcast_arrays(np.asarray(y, np.float32), np.asarray(x, np.float32))
    out = [fn(float(a), float(b)) for a, b in zip(y.reshape(-1), x.reshape(-1))]
    return np.asarray(out, np.float32).reshape(y.shape)


# ---------------------------------------------------------------------------
# atan2f of any float32 inputs, on the device, and face_rotation
# ---------------------------------------------------------------------------


def _f32_bits(b: int) -> float:
    return float(np.array([b], np.uint32).view(np.float32)[0])


# glibc's float atan2f/atanf (fdlibm's e_atan2f.c and s_atanf.c), constants
# read from their bit patterns
_ATANHI = tuple(_f32_bits(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA))
_ATANLO = tuple(_f32_bits(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168))
_AT = tuple(_f32_bits(b) for b in (
    0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
    0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7))
_PI = _f32_bits(0x40490FDB)
_PI_O_2 = _f32_bits(0x3FC90FDB)
_PI_LO = _f32_bits(0xB3BBBD2E)


def pick(idx: torch.Tensor, values) -> torch.Tensor:
    """``values[idx]`` for an integer tensor ``idx`` in range (a theme's
    sprite aspect ratio, a branch's constant): ``values`` are two or more
    Python numbers or tensors that broadcast against ``idx``, picked by a
    chain of selects (no host-to-device copy)."""
    out = values[-1]
    for k in range(len(values) - 2, -1, -1):
        out = torch.where(idx == k, values[k], out)
    return out


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atanf`` of finite float32 ``x``: every branch computed as
    float32 ops in the library's order and the taken one selected."""
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = torch.abs(x)
    # argument reduction (|x| >= 7/16): id 0-3
    idv = torch.where(ix < 0x3F300000, 0, torch.where(
        ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    r0 = (ax * 2.0 - 1.0) / (ax + 2.0)
    r1 = (ax - 1.0) / (ax + 1.0)
    r2 = (ax - 1.5) / (ax * 1.5 + 1.0)
    r3 = torch.full_like(ax, -1.0) / ax
    small = ix < 0x3EE00000  # |x| < 7/16: no reduction
    xr = torch.where(small, x, torch.where(idv == 0, r0, torch.where(
        idv == 1, r1, torch.where(idv == 2, r2, r3))))
    z = xr * xr
    w = z * z
    s1 = z * (_AT[0] + w * (_AT[2] + w * (_AT[4] + w * (_AT[6] + w * (_AT[8] + w * _AT[10])))))
    s2 = w * (_AT[1] + w * (_AT[3] + w * (_AT[5] + w * (_AT[7] + w * _AT[9]))))
    s = s1 + s2
    reduced = pick(idv, _ATANHI) - ((xr * s - pick(idv, _ATANLO)) - xr)
    out = torch.where(small, xr - xr * s, torch.where(hx < 0, -reduced, reduced))
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29
    huge = f32(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]))  # |x| >= 2^25
    return torch.where(ix >= 0x4C000000, torch.where(hx < 0, -huge, huge), out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """C++ ``atan2f`` (glibc's float atan2, which the reference links) of
    finite float32 tensors, as eager float32 ops in the library's order:
    each op rounds as IEEE requires on the CPU and on the card alike
    (divisions are tensor by tensor), so both give glibc's bits.
    tests/test_torch_trig.py holds it against glibc through ctypes."""
    y, x = torch.broadcast_tensors(y.to(F32), x.to(F32))
    hx = x.view(torch.int32)
    hy = y.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    iy = hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23
    # x == 1 returns atanf(y) at once; atanf is odd and y / 1 is exact, so
    # that is the quadrant rule below on |y / x| without the |y/x| > 2^60
    # shortcut
    z = _atanf(torch.abs(y / x))
    z = torch.where((k > 60) & (hx != 0x3F800000),
                    f32(np.float32(_PI_O_2) + np.float32(0.5) * np.float32(_PI_LO)),
                    torch.where((hx < 0) & (k < -60), 0.0, z))
    out = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, _PI - (z - _PI_LO), (z - _PI_LO) - _PI)))
    out = torch.where(ix == 0, torch.where(hy < 0, -_PI_O_2, _PI_O_2), out)
    return torch.where(iy == 0, torch.where(m < 2, y, torch.where(m == 2, _PI, -_PI)), out)


def face_rotation(dx: torch.Tensor, dy: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """Entity::face_direction (entity.cpp:84-88): ``rotation = -atan2(dy,
    dx) + offset``, where ``atan2`` is glibc's ``atan2f`` (entity.cpp
    includes <math.h>) and the chain is float32 in both modes.  The caller
    applies the "only when moving" guard."""
    return -atan2f(dy, dx) + f32(offset)


# ---------------------------------------------------------------------------
# cos/sin of a float angle through the double overload, on the device
# ---------------------------------------------------------------------------

# fdlibm's __ieee754_rem_pio2 (medium case), __kernel_sin and __kernel_cos
_INVPIO2 = 6.36619772367581382433e-01
_PIO2_1, _PIO2_1T = 1.57079632673412561417e+00, 6.07710050650619224932e-11
_PIO2_2, _PIO2_2T = 6.07710050630396597660e-11, 2.02226624879595063154e-21
_PIO2_3, _PIO2_3T = 2.02226624871116645580e-21, 8.47842766036889956997e-32
_S = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
      -1.98412698298579493134e-04, 2.75573137070700676789e-06,
      -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
      2.48015872894767294178e-05, -2.75573143513906633035e-07,
      2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _hi_exp(v: torch.Tensor) -> torch.Tensor:
    """The biased exponent of a float64 (``(__HI(v) >> 20) & 0x7ff``)."""
    return (v.view(torch.int64) >> 52) & 0x7FF


def _rem_pio2(t: torch.Tensor):
    """fdlibm's medium-case argument reduction of ``t`` = |x| >= 0 (float64,
    t < 2^19 * pi/2): (n, y0, y1) with t = n * pi/2 + y0 + y1.  Every
    iteration is computed and the one fdlibm would stop at is selected."""
    fn = torch.floor(t * _INVPIO2 + 0.5)
    r = t - fn * _PIO2_1
    w = fn * _PIO2_1T
    y0 = r - w
    j = _hi_exp(t)
    # 2nd iteration, taken where the first cancelled more than 16 bits
    r2 = r - fn * _PIO2_2
    w2 = fn * _PIO2_2T - ((r - r2) - fn * _PIO2_2)
    y02 = r2 - w2
    # 3rd iteration, where the second cancelled more than 49 bits
    r3 = r2 - fn * _PIO2_3
    w3 = fn * _PIO2_3T - ((r2 - r3) - fn * _PIO2_3)
    y03 = r3 - w3
    it2 = (j - _hi_exp(y0)) > 16
    it3 = it2 & ((j - _hi_exp(y02)) > 49)
    r = torch.where(it3, r3, torch.where(it2, r2, r))
    w = torch.where(it3, w3, torch.where(it2, w2, w))
    y0 = torch.where(it3, y03, torch.where(it2, y02, y0))
    y1 = (r - y0) - w
    return fn.to(torch.int64), y0, y1


def _kernel_sin(x, y, iy: bool):
    z = x * x
    v = z * x
    r = _S[1] + z * (_S[2] + z * (_S[3] + z * (_S[4] + z * _S[5])))
    if not iy:
        return x + v * (_S[0] + z * r)
    return x - ((z * (0.5 * y - v * r) - y) - v * _S[0])


def _kernel_cos(x, y):
    ax = torch.abs(x)
    z = x * x
    r = z * (_C[0] + z * (_C[1] + z * (_C[2] + z * (_C[3] + z * (_C[4] + z * _C[5])))))
    small = 1.0 - (0.5 * z - (z * r - x * y))
    # |x| >= 0.3: qx = x/4 with its low word cleared, or 0.28125 past 0.78125
    bits = ax.view(torch.int64)
    qx = (((bits >> 32) - 0x00200000) << 32).view(torch.float64)
    qx = torch.where((bits >> 32) > 0x3FE90000, 0.28125, qx)
    hz = 0.5 * z - qx
    big = (1.0 - qx) - (hz - (z * r - x * y))
    return torch.where((bits >> 32) < 0x3FD33333, small, big)


def sincos64(x: torch.Tensor):
    """(sin, cos) of a float64 tensor by fdlibm's algorithm (|x| < 2^19 *
    pi/2), written as separate eager torch ops: each op rounds as IEEE
    requires on the CPU and on the card alike, so both give the same bits.
    fdlibm is within one ulp of the true value, as glibc is, so narrowed to
    float32 the two agree except within a double ulp of a float32 rounding
    boundary (tests/test_torch_engine.py holds it against glibc)."""
    t = torch.abs(x)
    n, y0, y1 = _rem_pio2(t)
    # |x| <~ pi/4 (fdlibm compares the high word): no reduction, iy = 0
    tiny = (t.view(torch.int64) >> 32) <= 0x3FE921FB
    y0 = torch.where(tiny, t, y0)
    y1 = torch.where(tiny, 0.0, y1)
    n = torch.where(tiny, 0, n)
    ks = torch.where(tiny, _kernel_sin(y0, y1, False), _kernel_sin(y0, y1, True))
    kc = _kernel_cos(y0, y1)
    q = n & 3
    sin_t = torch.where(q == 0, ks, torch.where(q == 1, kc, torch.where(q == 2, -ks, -kc)))
    cos_t = torch.where(q == 0, kc, torch.where(q == 1, -ks, torch.where(q == 2, -kc, ks)))
    # sin is odd, cos even (fdlibm reduces |x| and negates n, y0, y1)
    return torch.where(torch.signbit(x), -sin_t, sin_t), cos_t


def dsincos(cfg, x: torch.Tensor):
    """(sin, cos) of C++ ``sin(float)``/``cos(float)``, which resolve to the
    double overloads: float64 in parity mode (the caller narrows at the
    store), narrowed to float32 on the fast path."""
    s, c = sincos64(_t(x).to(F64))
    return (s, c) if cfg.parity_mode else (s.to(F32), c.to(F32))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on the CPU and on the card
    alike.  The card's ``sqrt`` is correctly rounded; torch's CPU one is not
    (about 0.7% of random float32 inputs come out an ulp off, and about
    0.8% in float64), and on the CPU the float64 root narrowed is still an
    ulp off on a few inputs in some runs.  So the narrowed float64 root
    ``r`` takes one correction step, exact in float64: the midpoints
    between ``r`` and its float32 neighbours and their squares are exact
    there (25 and 50 bits), and the root of a float32 never lies on a
    midpoint, so ``r`` moves to the neighbour whose side ``x`` is on."""
    x = _t(x)
    x64 = x.to(F64)
    r = torch.sqrt(x64).to(F32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.zeros_like(r))
    r64 = r.to(F64)
    hi = (r64 + up.to(F64)) * 0.5
    lo = (r64 + dn.to(F64)) * 0.5
    return torch.where(x64 > hi * hi, up, torch.where(x64 < lo * lo, dn, r))


def _split(a: torch.Tensor):
    """Veltkamp's split of a float64 into two halves of at most 26
    significant bits each, ``a == hi + lo`` exactly."""
    c = a * 134217729.0  # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _exceeds_product(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x > a * b`` decided exactly, for float64 ``x`` within a factor of 2
    of the product: Dekker's product ``a * b == p + e`` (each eager op
    rounds once, so the error term is exact) and Sterbenz's lemma (``x -
    p`` is exact) reduce it to one comparison of two doubles."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return (x - p) > e


def sqrt64(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root of float32 values (C++
    ``sqrt(float)``), on the CPU and on the card alike.  Torch's CPU float64
    ``sqrt`` is an ulp off on about 0.8% of inputs, so its root ``r`` takes
    one correction step.  The midpoint between ``r`` and its neighbour
    ``n`` squares to ``r * n + (|n - r| / 2)**2``; ``x - r * n`` is a
    multiple of four times that last term (``x`` has 24 significant bits),
    so ``x`` lies above the upper midpoint exactly when ``x > r * n_up`` and
    below the lower one exactly when ``x <= n_down * r``, both decided
    exactly by ``_exceeds_product``.  On the CPU torch's root is sometimes
    far more than an ulp off (one thread's share of a first call), so one
    Newton step first brings it within 2 ulps, and the correction runs
    twice.  Zeros (either sign), infinities, NaNs and
    negative inputs keep ``torch.sqrt``'s result."""
    x64 = _t(x).to(F64)
    r0 = torch.sqrt(x64)
    r = (r0 + x64 / r0) * 0.5
    for _ in range(2):
        up = torch.nextafter(r, torch.full_like(r, float("inf")))
        dn = torch.nextafter(r, torch.zeros_like(r))
        r = torch.where(
            _exceeds_product(x64, r, up), up,
            torch.where(_exceeds_product(x64, dn, r), r, dn),
        )
    normal = (x64 > 0) & torch.isfinite(x64)
    return torch.where(normal, r, r0)


def dsqrt(cfg, x: torch.Tensor) -> torch.Tensor:
    """C++ ``sqrt(float)``: the double overload of a float operand, the
    correctly rounded float64 root in parity mode (the caller narrows at the
    store), the correctly rounded float32 root otherwise."""
    x = _t(x)
    return sqrt64(x) if cfg.parity_mode else sqrt32(x)


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
