"""Time builds of the compositor kernel on the same inputs, in turns.

    python3 -m procgen_torch.bench.compositor_ab --other [NAME=]PATH/compositor.cu \\
        [--other ...] [--kmax 20,60,201]

Builds ``procgen_torch/csrc/compositor.cu`` ("this") and each source given
by ``--other`` (named "other" unless NAME is given) with the same nvcc
flags.  Times every build on synthetic records at coinrun's main-path shape
(4096 envs, 512 slots plus the pad record, boxes of 0.5-1.5 cells of 64/13
px) and leaper's (4096 envs, 192 slots plus the pad record, cells of 64/15
px), with the records at or past ``kmax`` not drawable, and once as the
main path walks them (kmax "main": coinrun's 201 and leaper's 57 records
walked in every env, of which each env draws a prefix of 0 to twice the
main path's mean, 15 and 19), in the order others, this, then back (other,
this, this, other for one other).  Every
build must equal the plain version bit for bit.  Prints one JSON line per
(shape, kmax), with the launch's byte bound, and the card's name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from procgen_torch import cuda_build
from procgen_torch.render import compositor

N = 4096
# (name, records per env, grid cell in px, kmax and mean drawn records per
# env on the main path) of the main paths that draw many records: coinrun's
# 13-cell view, leaper's 15x15 world (chip_smoke.py's timing phase: 14.8 and
# 18.8 drawn on average at kmax 201 and 57)
SHAPES = (("coinrun", 513, 64 / 13, 201, 15), ("leaper", 193, 64 / 15, 57, 19))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def build(src: Path) -> ctypes.CDLL:
    flags = cuda_build.NVCC_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = cuda_build.BUILD / f"libcompositor-ab-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [cuda_build._nvcc(), *flags, "-o", str(out), str(src)],
            check=True, capture_output=True, text=True,
        )
    lib = ctypes.CDLL(str(out))
    lib.composite_entities_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.composite_entities_launch.restype = ctypes.c_int
    return lib


def launch(lib, rec, atlas, kmax_t, canvas, out):
    n, e, _ = rec.shape
    rc = lib.composite_entities_launch(
        rec.data_ptr(), atlas.data_ptr(), kmax_t.data_ptr(), canvas.data_ptr(), out.data_ptr(),
        n, e, atlas.shape[0], atlas.shape[1], 0, torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"launch failed (error {rc})")


def time_ms(fn, iters: int = 50) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, action="append",
                    help="[NAME=]PATH of another compositor.cu (repeatable)")
    ap.add_argument("--kmax", default="20,60,201", help="records walked per env, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compositor_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    this = cuda_build.CSRC / "compositor.cu"
    libs = {}
    for o in args.other:
        name, _, path = o.rpartition("=")
        libs[name or "other"] = build(Path(path))
    libs["this"] = build(this)
    order = list(libs) + list(libs)[::-1]
    dev = "cuda"
    for shape, E, cell, main_kmax, main_drawn in SHAPES:
        rec, atlas, canvas = compositor.synthetic_case(N, E, 64, 32, seed=11, binary_alpha=True,
                                                       cell=cell)
        atlas_t = torch.as_tensor(atlas, device=dev)
        canvas_t = torch.as_tensor(canvas, device=dev)
        tables = type("Tables", (), {"var_mips": atlas_t})()
        drawn = np.random.RandomState(12).randint(0, 2 * main_drawn + 1, size=(N, 1))
        for kmax in [*args.kmax.split(","), "main"]:
            r = rec.copy()
            if kmax == "main":
                k = main_kmax
                r[..., 7] = np.arange(E)[None, :] < drawn  # a drawable prefix
            else:
                k = int(kmax)
                r[:, k:, 7] = 0.0  # non-drawable records sort last
            rec_t = torch.as_tensor(r, device=dev)
            kmax_t = torch.full((1,), k, dtype=torch.int32, device=dev)
            outs = {name: torch.empty_like(canvas_t) for name in libs}
            for name, lib in libs.items():
                launch(lib, rec_t, atlas_t, kmax_t, canvas_t, outs[name])
            plain = compositor.composite_entities_ref(tables, rec_t, k, canvas_t)
            torch.cuda.synchronize()
            for name, out in outs.items():
                if not torch.equal(out.view(torch.int32), plain.view(torch.int32)):
                    raise AssertionError(f"compositor_ab: {name} kernel != plain at {shape} kmax {k}")
            ms = {name: [] for name in libs}
            for name in order:
                lib, out = libs[name], outs[name]
                ms[name].append(time_ms(lambda: launch(lib, rec_t, atlas_t, kmax_t, canvas_t, out)))
            walked = min(E, k)
            nbytes = N * walked * compositor.NF * 4 + atlas_t.numel() + 4 + canvas_t.numel() * 4 * 2
            print(json.dumps({
                "shape": shape, "records": [N, E], "kmax": k if kmax != "main" else kmax, "walked": walked, "cell_px": cell,
                "drawn_per_env": float((rec_t[:, :walked, 7] > 0).sum()) / N,
                "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                **{f"ms_{name}": v for name, v in ms.items()}, "bitwise_equal": True,
            }), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
