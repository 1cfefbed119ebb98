"""Build and load the port's native libraries (plain C interface, ctypes).

Each source under ``procgen_torch/csrc`` compiles into its own shared
library under ``procgen_torch/_build/`` at first use: the CUDA kernels with
``nvcc`` (all of them together, when the first is loaded), the PNG
decoder's host-side unfilter and the host builds of the maze kernels' and
the miner sweep's code with ``g++``.  The file name carries a hash of the
source, the headers it includes from ``csrc`` and the flags, so an edited
source is rebuilt.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

# library name -> (source file under csrc/, compiler)
SOURCES = {
    "compositor": ("compositor.cu", "nvcc"),
    "mazegen": ("mazegen.cu", "nvcc"),
    "miner_sweep": ("miner_sweep.cu", "nvcc"),
    "png_unfilter": ("png_unfilter.cpp", "g++"),
    "mazegen_host": ("mazegen_host.cpp", "g++"),
    "miner_sweep_host": ("miner_sweep_host.cpp", "g++"),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # the kernels reproduce the reference's separately rounded float math
    "-fmad=false",
    "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> list:
    return NVCC_FLAGS if SOURCES[name][1] == "nvcc" else GXX_FLAGS


def _local_includes(src: bytes) -> bytes:
    """The bytes of the ``csrc`` headers that ``src`` includes by name."""
    names = re.findall(rb'^#include "([^"]+)"', src, re.M)
    return b"".join((CSRC / n.decode()).read_bytes() for n in names)


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name][0]).read_bytes()
    digest = hashlib.sha256(
        src + _local_includes(src) + " ".join(_flags(name)).encode()
    ).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start the compiler for ``name`` unless its library exists; returns
    (path, process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compiler = _nvcc() if SOURCES[name][1] == "nvcc" else "g++"
    cmd = [compiler, *_flags(name), "-o", str(tmp), str(CSRC / SOURCES[name][0])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp)


def build_all(names=None) -> dict:
    """Compile the named libraries (default: all) with one compiler
    process each, all started together.  Returns {name: {"seconds", "log"}};
    raises with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.time()
    started = {n: _start(n) for n in names}
    report = {}
    for n, (out, job) in started.items():
        log = ""
        if job is not None:
            proc, tmp = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{SOURCES[n][1]} failed for {n}:\n{log}")
            os.replace(tmp, out)
        report[n] = {"seconds": time.time() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The shared library ``name``, built first if needed.  Loading a CUDA
    library builds every CUDA library that is not built yet, in parallel."""
    if name not in _LIBS:
        kind = SOURCES[name][1]
        build_all([n for n in SOURCES if SOURCES[n][1] == kind] if kind == "nvcc" else [name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
