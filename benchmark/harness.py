"""One run of one cell: ``python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

Everything a cell needs is found by name.  ``BENCHMARK.json`` names the
cell's configuration (its file) and its traffic (``traffic/<name>.json``);
the traffic file names its driver (``drivers/<driver>.py``), which builds
the program, warms it up, runs the window and checks what the window
produced against the plain reference; each per-layer metric is read by
``metrics/<name>.py``.  A cell, a traffic mix or a per-layer metric is
added by adding files.

The last line of standard output is the result (one JSON object); the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.  Without a CUDA card with as many
devices as the cell asks for, or if JAX or the JAX package is loaded once
the window has closed, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "procgen_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    root: Path  # the checkout: BENCHMARK.json and benchmark/
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the end-to-end values, the traced summary and
    counts the per-layer readers take, and the checks."""

    metrics: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list  # [(name, value, limit)]: correct iff value <= limit for all
    trace: object = None  # trace.TraceSummary of a --trace 1 run
    counts: dict = dataclasses.field(default_factory=dict)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, root: Path) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(
        name=name,
        root=root,
        chips=int(cell["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text()),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def asset_dir() -> Path:
    """Where a run writes its synthetic asset root: under ``TMPDIR``."""
    return Path(tempfile.gettempdir()) / "benchmark_assets"


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float  # process start on the host clock
    device: object = None


def run_cell(ctx: Context, system=None) -> Outcome:
    """The cell's driver on this context (``system``: a stand-in for the
    program, for the control and the fault checks)."""
    driver = load_module(ctx.cell.root / "benchmark" / "drivers" / f"{ctx.cell.traffic['driver']}.py")
    return driver.run(ctx, system)


def result_line(cell: Cell, out: Outcome, trace: bool, device: dict) -> dict:
    correct = all(v <= lim for _, v, lim in out.checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module(cell.root / "benchmark" / "metrics" / f"{m['name']}.py").read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace.device_ops,
                             "idle_gaps": out.trace.idle_gaps}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = find_cell(args.workload, HERE.parent)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), t_start,
                  torch.device("cuda", 0))
    out = run_cell(ctx)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.trace and out.trace is not None:
        device.update(busy_s=out.trace.busy_s, window_s=out.trace.window_s)
    line = result_line(cell, out, ctx.trace, device)
    print(f"card: {card()}", file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def set_cache_dirs() -> None:
    """Every cache at a fixed path inside the checkout (the CUDA kernels
    build into the port's own ``procgen_torch/_build``)."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
