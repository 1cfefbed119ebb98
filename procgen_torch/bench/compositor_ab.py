"""Time two builds of the compositor kernel on the same inputs, in turns.

    python3 -m procgen_torch.bench.compositor_ab --other PATH/compositor.cu

Builds ``procgen_torch/csrc/compositor.cu`` ("this") and the source at
``--other`` with the same nvcc flags, and times both on synthetic records at
coinrun's main-path shape (4096 envs, 512 slots plus the pad record) with
the drawable records first and ``kmax`` of them drawn, in the order other,
this, this, other.  Both kernels must equal the plain version bit for bit.
Prints one JSON line per kmax and the card's name and power limit.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from procgen_torch import cuda_build
from procgen_torch.render import compositor

N, E = 4096, 513


def build(src: Path) -> ctypes.CDLL:
    digest = hashlib.sha256(src.read_bytes() + " ".join(cuda_build.NVCC_FLAGS).encode())
    out = cuda_build.BUILD / f"libcompositor-ab-{digest.hexdigest()[:12]}.so"
    if not out.exists():
        cuda_build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
            check=True, capture_output=True, text=True,
        )
    lib = ctypes.CDLL(str(out))
    lib.composite_entities_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.composite_entities_launch.restype = ctypes.c_int
    return lib


def launch(lib, rec, atlas, kmax_t, canvas, out):
    rc = lib.composite_entities_launch(
        rec.data_ptr(), atlas.data_ptr(), kmax_t.data_ptr(), canvas.data_ptr(), out.data_ptr(),
        N, E, atlas.shape[0], atlas.shape[1], 0, torch.cuda.current_stream().cuda_stream,
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
    ap.add_argument("--other", required=True, type=Path, help="the other compositor.cu")
    ap.add_argument("--kmax", default="60,160,513", help="drawn records per env, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compositor_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    libs = {"other": build(args.other), "this": build(cuda_build.CSRC / "compositor.cu")}
    rec, atlas, canvas = compositor.synthetic_case(N, E, 64, 32, seed=11, binary_alpha=True)
    dev = "cuda"
    atlas_t = torch.as_tensor(atlas, device=dev)
    canvas_t = torch.as_tensor(canvas, device=dev)
    tables = type("Tables", (), {"var_mips": atlas_t})()
    for k in (int(v) for v in args.kmax.split(",")):
        r = rec.copy()
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
                raise AssertionError(f"compositor_ab: {name} kernel != plain at kmax {k}")
        ms = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            lib, out = libs[name], outs[name]
            ms[name].append(time_ms(lambda: launch(lib, rec_t, atlas_t, kmax_t, canvas_t, out)))
        print(json.dumps({"records": [N, E], "kmax": k, "ms_other": ms["other"],
                          "ms_this": ms["this"], "bitwise_equal": True}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
