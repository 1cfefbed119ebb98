"""Sprite compositor: CUDA kernel wrapper and its plain PyTorch version.

``composite_entities`` blends z-sorted entity records over a batch of
64x64 RGB float canvases.  It replaces the TPU kernel
``procgen_tpu/render/pallas_compositor.py:_kernel`` and its XLA twin
``procgen_tpu/render/fast2.py:composite_entities``; the kernel source and
its design notes are in ``procgen_torch/csrc/compositor.cu``.

For CUDA tensors the wrapper launches the kernel (or raises); for CPU
tensors it runs ``composite_entities_ref``, the plain version, which
performs the same float operations in the same order and so gives the same
bits.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from procgen_torch import cuda_build
from procgen_torch.fmath import div_const

RES = 64
NF = 11  # record fields, fast2._RF layout
_F = dict(bbx0=0, bby0=1, bbw=2, bbh=3, var=4, refl=5, alpha=6, ok=7, n_th=8, n_tv=9, z=10)
Z_FILTERS = {"all": 0, "neg": 1, "nonneg": 2}

launches = 0  # kernel launches since import (reset by callers that count)


def _kmax_bound(kmax, E: int) -> int:
    return E if kmax is None else min(E, int(kmax))


def composite_entities_ref(tables, records, kmax, canvas, z_filter="all"):
    """Plain PyTorch compositor (direct texel indexing).

    tables.var_mips: (NV, R, R, 4) uint8; records: (N, E, 11) f32;
    canvas: (N, 64, 64, 3) f32.  Returns the blended canvas (new tensor).
    Op order of the reference package: ``a_t = tex_a * (alpha / 255)``,
    premultiplied ``rgb * a_t``, both rounded to bf16 (round to nearest
    even), then ``c = s + c * (1 - a)``, each op separately rounded."""
    atlas = tables.var_mips
    NV, R = atlas.shape[0], atlas.shape[1]
    flat = atlas.reshape(NV * R * R, 4).to(torch.float32)
    N, E, _ = records.shape
    dev = canvas.device
    px = torch.arange(RES, dtype=torch.float32, device=dev) + 0.5
    out = canvas

    def coord(t, n):
        raw = t * n[:, None]
        u = torch.where(n[:, None] > 1, raw - torch.floor(raw), t)
        return (torch.clamp(u, 0.0, 0.9999) * R).to(torch.int32).clamp(0, R - 1)

    for k in range(_kmax_bound(kmax, E)):
        rec = records[:, k]

        def g(f):
            return rec[:, _F[f]]

        ok = g("ok") > 0
        if z_filter == "neg":
            ok = ok & (g("z") < 0)
        elif z_filter == "nonneg":
            ok = ok & (g("z") >= 0)
        col = (px[None, :] - g("bbx0")[:, None]) / g("bbw")[:, None]  # (N, 64) x
        row = (px[None, :] - g("bby0")[:, None]) / g("bbh")[:, None]  # (N, 64) y
        in_x = (col >= 0) & (col < 1)
        in_y = (row >= 0) & (row < 1)
        su = coord(col, g("n_th"))
        sv = coord(row, g("n_tv"))
        su = torch.where((g("refl") > 0)[:, None], R - 1 - su, su)
        var = g("var")
        vi = var.to(torch.int64)
        var_ok = (vi.to(torch.float32) == var) & (vi >= 0) & (vi < NV)
        idx = (vi.clamp(0, NV - 1)[:, None, None] * R + sv[:, :, None]) * R + su[:, None, :]
        tex = torch.where(var_ok[:, None, None, None], flat[idx], 0.0)  # (N, 64, 64, 4)
        a_t = tex[..., 3] * div_const(g("alpha"), 255.0)[:, None, None]
        s = (tex[..., :3] * a_t[..., None]).to(torch.bfloat16).to(torch.float32)
        a = a_t.to(torch.bfloat16).to(torch.float32)
        inside = in_y[:, :, None] & in_x[:, None, :]
        s = torch.where(inside[..., None], s, 0.0)
        a = torch.where(inside, a, 0.0)
        blended = s + out * (1 - a)[..., None]
        out = torch.where(ok[:, None, None, None], blended, out)
    return out


def synthetic_case(n: int, e: int, nv: int = 20, r: int = 32, seed: int = 0,
                   binary_alpha: bool = False):
    """Seeded numpy inputs that exercise every compositor path: boxes partly
    off screen, tiling n_th / n_tv in {1, 2, 3}, reflection, mixed ok, z in
    {-1, 0, 1}; texel alpha in {0, 255} and entity alpha 1 when
    ``binary_alpha``, else fractional.  Returns (records (n, e, 11) f32,
    atlas (nv, r, r, 4) uint8, canvas (n, 64, 64, 3) f32)."""
    rs = np.random.RandomState(seed)
    atlas = rs.randint(0, 256, size=(nv, r, r, 4)).astype(np.uint8)
    if binary_alpha:
        atlas[..., 3] = 255 * rs.randint(0, 2, size=(nv, r, r))
    rec = np.zeros((n, e, NF), np.float32)
    rec[..., _F["bbx0"]] = rs.uniform(-24, 60, size=(n, e))
    rec[..., _F["bby0"]] = rs.uniform(-24, 60, size=(n, e))
    rec[..., _F["bbw"]] = rs.uniform(1, 40, size=(n, e))
    rec[..., _F["bbh"]] = rs.uniform(1, 40, size=(n, e))
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
