"""Sprite compositor: CUDA kernel wrapper and its plain PyTorch version.

``composite_entities`` blends z-sorted entity records over a batch of
64x64 RGB float canvases.  It replaces the TPU kernel
``procgen_tpu/render/pallas_compositor.py:_kernel`` and its XLA twin
``procgen_tpu/render/fast2.py:composite_entities``; the kernel source and
its design notes are in ``procgen_torch/csrc/compositor.cu``.

For CUDA tensors the wrapper launches the kernel (or raises); for CPU
tensors it runs ``composite_entities_ref``, the plain version, which
performs the same float operations in the same order and so gives the same
bits.  ``launches`` counts kernel launches.  ``pixel_span`` mirrors the
kernel's clipping of each record to its box.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from procgen_torch import cuda_build, telemetry
from procgen_torch.fmath import div_const

RES = 64
NF = 11  # record fields, fast2._RF layout
_F = dict(bbx0=0, bby0=1, bbw=2, bbh=3, var=4, refl=5, alpha=6, ok=7, n_th=8, n_tv=9, z=10)
Z_FILTERS = {"all": 0, "neg": 1, "nonneg": 2}

launches = 0  # kernel launches since import (reset by callers that count)


def _kmax_bound(kmax, E: int) -> int:
    if kmax is None:
        return E
    if isinstance(kmax, torch.Tensor):
        telemetry.count("host_reads.compositor.kmax")
    return min(E, int(kmax))


def _hull(t, ok):
    """Per record, the pixels ``[first, end)`` of one axis whose centres lie
    in its box (``0 <= t < 1``) in any env where ``ok``: ``t`` (N, K, 64),
    ``ok`` (N, K).  Returns a (K, 2) int64 tensor; ``first >= end`` where
    no env's box holds a pixel centre."""
    hit = ((t >= 0) & (t < 1) & ok[..., None]).any(0)  # (K, 64)
    pos = torch.arange(RES, device=t.device)
    first = torch.where(hit, pos, RES).amin(1)
    end = torch.where(hit, pos + 1, 0).amax(1)
    return torch.stack([first, end], 1)


def composite_entities_ref(tables, records, kmax, canvas, z_filter="all"):
    """Plain PyTorch compositor (direct texel indexing).

    tables.var_mips: (NV, R, R, 4) uint8; records: (N, E, 11) f32;
    canvas: (N, 64, 64, 3) f32.  Returns the blended canvas (new tensor).
    Op order of the reference package: ``a_t = tex_a * (alpha / 255)``,
    premultiplied ``rgb * a_t``, both rounded to bf16 (round to nearest
    even), then ``c = s + c * (1 - a)``, each op separately rounded.

    A pixel outside a record's box takes ``c = 0 + c * (1 - 0)``, which
    leaves every ``c >= +0`` as it is (the canvases are; a -0.0 would turn
    into +0.0), so each record is blended over the rectangle of pixels that
    lie in its box in some env of the batch, from the same box tests, with
    the rectangles of all records read to the host once."""
    atlas = tables.var_mips
    NV, R = atlas.shape[0], atlas.shape[1]
    flat = atlas.reshape(NV * R * R, 4).to(torch.float32)
    N, E, _ = records.shape
    K = _kmax_bound(kmax, E)
    dev = canvas.device
    px = torch.arange(RES, dtype=torch.float32, device=dev) + 0.5
    out = canvas.clone()

    def field(rec, f):
        return rec[..., _F[f]]

    def axis(p, rec, lo, size):
        return (p - field(rec, lo)[..., None]) / field(rec, size)[..., None]

    recs = records[:, :K]
    ok_all = field(recs, "ok") > 0
    if z_filter == "neg":
        ok_all = ok_all & (field(recs, "z") < 0)
    elif z_filter == "nonneg":
        ok_all = ok_all & (field(recs, "z") >= 0)
    telemetry.count("host_reads.compositor.rects")
    rects = torch.cat([_hull(axis(px, recs, "bbx0", "bbw"), ok_all),
                       _hull(axis(px, recs, "bby0", "bbh"), ok_all)], 1).tolist()

    def coord(t, n):
        raw = t * n[:, None]
        u = torch.where(n[:, None] > 1, raw - torch.floor(raw), t)
        return (torch.clamp(u, 0.0, 0.9999) * R).to(torch.int32).clamp(0, R - 1)

    for k, (x0, x1, y0, y1) in enumerate(rects):
        if x0 >= x1 or y0 >= y1:
            continue  # no env draws a pixel of this record
        rec = records[:, k]

        def g(f):
            return field(rec, f)

        ok = ok_all[:, k]
        col = axis(px[x0:x1], rec, "bbx0", "bbw")  # (N, w) x
        row = axis(px[y0:y1], rec, "bby0", "bbh")  # (N, h) y
        in_x = (col >= 0) & (col < 1)
        in_y = (row >= 0) & (row < 1)
        su = coord(col, g("n_th"))
        sv = coord(row, g("n_tv"))
        su = torch.where((g("refl") > 0)[:, None], R - 1 - su, su)
        var = g("var")
        vi = var.to(torch.int64)
        var_ok = (vi.to(torch.float32) == var) & (vi >= 0) & (vi < NV)
        idx = (vi.clamp(0, NV - 1)[:, None, None] * R + sv[:, :, None]) * R + su[:, None, :]
        tex = torch.where(var_ok[:, None, None, None], flat[idx], 0.0)  # (N, h, w, 4)
        a_t = tex[..., 3] * div_const(g("alpha"), 255.0)[:, None, None]
        s = (tex[..., :3] * a_t[..., None]).to(torch.bfloat16).to(torch.float32)
        a = a_t.to(torch.bfloat16).to(torch.float32)
        inside = in_y[:, :, None] & in_x[:, None, :]
        s = torch.where(inside[..., None], s, 0.0)
        a = torch.where(inside, a, 0.0)
        c = out[:, y0:y1, x0:x1]
        blended = s + c * (1 - a)[..., None]
        out[:, y0:y1, x0:x1] = torch.where(ok[:, None, None, None], blended, c)
    return out


def pixel_span(lo, size):
    """Conservative pixel span ``[first, end)`` of one box axis (edge
    ``lo``, size ``size``, float32 arrays): every pixel x whose centre the
    exact test ``(x + 0.5 - lo) / size in [0, 1)`` accepts has
    ``first <= x < end``.  The kernel draws a record only over its span;
    this mirrors ``pixel_span`` in ``procgen_torch/csrc/compositor.cu``
    operation for operation (float32, clamped to [0, 64] before the
    conversion; a size outside (0, 1e30) takes the whole axis, since past
    2**126 the quotient can underflow to -0.0, which the test accepts).
    Returns two int32 arrays."""
    lo = np.asarray(lo, np.float32)
    size = np.asarray(size, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        first = np.floor(lo - np.float32(1.5))
        end = np.ceil((lo + size) + np.float32(0.5))
        whole = ~((size > 0) & (size < np.float32(1e30)))
    first = np.where(whole, 0, np.fmin(np.fmax(first, np.float32(0)), np.float32(RES)))
    end = np.where(whole, RES, np.fmin(np.fmax(end, np.float32(0)), np.float32(RES)))
    return first.astype(np.int32), end.astype(np.int32)


def edge_axes(rs, count: int):
    """``count`` adversarial (lo, size) pairs of one box axis, float32: edges
    at pixel centres k + 0.5 and one ulp either side, size 1e-6 (the main
    path's clamp), boxes at +-1e6 and fully off screen, and a share of
    sizes that are not > 0 or not finite."""
    f32 = np.float32
    centres = np.arange(-3, 68, dtype=np.float32) + f32(0.5)
    edges = np.concatenate([centres, np.nextafter(centres, f32(np.inf)),
                            np.nextafter(centres, f32(-np.inf))])
    lo = rs.choice(edges, count).astype(np.float32)
    far = edges[rs.randint(0, len(edges), count)]
    size = np.where(far > lo, far - lo, rs.uniform(0.5, 30, count)).astype(np.float32)
    kind = rs.randint(0, 10, count)
    size = np.where(kind == 1, f32(1e-6), size)
    big = np.array([[-1e6, 1e6 + 32], [-1e6, 2e6], [1e6, 10], [-1e6, 10], [-1e6, 1e6],
                    [-50, 10], [70, 10], [64.5, 1], [-1, 0.5], [63.5, 1e-6]], np.float32)
    pick = big[rs.randint(0, len(big), count)]
    lo = np.where(kind == 2, pick[:, 0], lo)
    size = np.where(kind == 2, pick[:, 1], size)
    odd = np.array([0.0, -0.0, -3.0, 3e38, np.inf, np.nan], np.float32)
    size = np.where(kind == 3, odd[rs.randint(0, len(odd), count)], size)
    return lo.astype(np.float32), size.astype(np.float32)


def edge_case(n: int, e: int, nv: int = 8, r: int = 16, seed: int = 0):
    """Seeded adversarial compositor inputs: boxes from ``edge_axes``, tiled
    boxes, overlapping records with different z (each env's second half
    repeats its first half's boxes shifted by under a pixel), variants that
    name no atlas entry, and a canvas of which half the values are exactly
    0.  Returns (records, atlas, canvas) as ``synthetic_case`` does."""
    rec, atlas, canvas = synthetic_case(n, e, nv, r, seed=seed, binary_alpha=True)
    rs = np.random.RandomState(seed + 1)
    for lo_f, size_f in (("bbx0", "bbw"), ("bby0", "bbh")):
        lo, size = edge_axes(rs, n * e)
        rec[..., _F[lo_f]] = lo.reshape(n, e)
        rec[..., _F[size_f]] = size.reshape(n, e)
    h = e // 2
    for f in ("bbx0", "bby0", "bbw", "bbh"):
        rec[:, h:2 * h, _F[f]] = rec[:, :h, _F[f]]
    rec[:, h:2 * h, _F["bbx0"]] += rs.uniform(-0.9, 0.9, size=(n, h)).astype(np.float32)
    z = rec[:, :h, _F["z"]]
    rec[:, h:2 * h, _F["z"]] = np.where(z == 1, -1, z + 1)
    rec[..., _F["n_th"]] = rs.choice([1, 2, 3, 7], size=(n, e))
    rec[..., _F["n_tv"]] = rs.choice([1, 2, 3, 7], size=(n, e))
    bad = rs.rand(n, e) < 0.1
    rec[..., _F["var"]] = np.where(bad, rs.choice([-1.0, nv, 2.5], size=(n, e)), rec[..., _F["var"]])
    canvas[rs.rand(*canvas.shape) < 0.5] = 0.0
    return rec, atlas, canvas


def synthetic_case(n: int, e: int, nv: int = 20, r: int = 32, seed: int = 0,
                   binary_alpha: bool = False, cell: float | None = None):
    """Seeded numpy inputs that exercise every compositor path: boxes partly
    off screen, tiling n_th / n_tv in {1, 2, 3}, reflection, mixed ok, z in
    {-1, 0, 1}; texel alpha in {0, 255} and entity alpha 1 when
    ``binary_alpha``, else fractional.  Box sides are uniform in 1-40 px,
    or with ``cell`` (a grid cell in px, as 64 / 13 for coinrun's view)
    0.5-1.5 cells, as the main path's sprites are.  Returns (records
    (n, e, 11) f32, atlas (nv, r, r, 4) uint8, canvas (n, 64, 64, 3) f32)."""
    rs = np.random.RandomState(seed)
    atlas = rs.randint(0, 256, size=(nv, r, r, 4)).astype(np.uint8)
    if binary_alpha:
        atlas[..., 3] = 255 * rs.randint(0, 2, size=(nv, r, r))
    rec = np.zeros((n, e, NF), np.float32)
    edge = (-24, 60) if cell is None else (-cell, RES)
    side = (1, 40) if cell is None else (0.5 * cell, 1.5 * cell)
    rec[..., _F["bbx0"]] = rs.uniform(*edge, size=(n, e))
    rec[..., _F["bby0"]] = rs.uniform(*edge, size=(n, e))
    rec[..., _F["bbw"]] = rs.uniform(*side, size=(n, e))
    rec[..., _F["bbh"]] = rs.uniform(*side, size=(n, e))
    rec[..., _F["var"]] = rs.randint(0, nv, size=(n, e))
    rec[..., _F["refl"]] = rs.randint(0, 2, size=(n, e))
    rec[..., _F["alpha"]] = 1.0 if binary_alpha else rs.uniform(0, 1, size=(n, e))
    rec[..., _F["ok"]] = rs.rand(n, e) < 0.8
    rec[..., _F["n_th"]] = rs.randint(1, 4, size=(n, e))
    rec[..., _F["n_tv"]] = rs.randint(1, 4, size=(n, e))
    rec[..., _F["z"]] = rs.randint(-1, 2, size=(n, e))
    canvas = rs.randint(0, 256, size=(n, RES, RES, 3)).astype(np.float32)
    return rec, atlas, canvas


def _lib():
    lib = cuda_build.load("compositor")
    fn = lib.composite_entities_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def blocks_per_sm() -> int:
    """Resident kernel blocks per SM on the current card (needs CUDA)."""
    n = cuda_build.load("compositor").composite_entities_blocks_per_sm()
    if n < 0:
        raise RuntimeError(f"composite_entities: occupancy query failed (error {-n})")
    return n


def composite_entities(tables, records, kmax, canvas, z_filter="all"):
    """Blend sorted entity records over ``canvas`` (interleaved (N, 64, 64,
    3) f32); ``kmax`` bounds the records walked (None = all).  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    global launches
    if z_filter not in Z_FILTERS:
        raise ValueError(f"z_filter must be one of {sorted(Z_FILTERS)}")
    if canvas.device.type == "cpu":
        return composite_entities_ref(tables, records, kmax, canvas, z_filter)
    if canvas.device.type != "cuda":
        raise ValueError(f"composite_entities: unsupported device {canvas.device}")
    atlas = tables.var_mips
    N, E, nf = records.shape
    if nf != NF or canvas.shape != (N, RES, RES, 3):
        raise ValueError(
            f"composite_entities: records {tuple(records.shape)} / canvas "
            f"{tuple(canvas.shape)} do not match (N, E, {NF}) / (N, 64, 64, 3)"
        )
    if atlas.dim() != 4 or atlas.shape[1] != atlas.shape[2] or atlas.shape[3] != 4:
        raise ValueError(f"composite_entities: atlas shape {tuple(atlas.shape)}")
    for name, t, dtype in (
        ("records", records, torch.float32),
        ("canvas", canvas, torch.float32),
        ("atlas", atlas, torch.uint8),
    ):
        if t.device != canvas.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"composite_entities: {name} must be a contiguous {dtype} "
                f"tensor on {canvas.device}"
            )
    if canvas.data_ptr() % 16:
        raise ValueError("composite_entities: the kernel's bulk copy needs a 16-byte aligned canvas")
    if kmax is None:
        kmax = E
    kmax_t = torch.as_tensor(kmax, device=canvas.device).to(torch.int32).reshape(1)
    out = torch.empty_like(canvas)
    stream = torch.cuda.current_stream(canvas.device).cuda_stream
    rc = _lib()(
        records.data_ptr(), atlas.data_ptr(), kmax_t.data_ptr(),
        canvas.data_ptr(), out.data_ptr(),
        N, E, atlas.shape[0], atlas.shape[1], Z_FILTERS[z_filter], stream,
    )
    if rc != 0:
        raise RuntimeError(f"composite_entities: CUDA launch failed (error {rc})")
    launches += 1
    return out
