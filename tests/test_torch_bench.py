"""The port's throughput benchmark (``procgen_torch/bench/throughput.py``
through its console entry point ``procgen_torch.bench_cli``) on the CPU:
one JSON line whose checksum equals the same loop run in-process, and no
run without CUDA unless the CPU is asked for."""

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from procgen_torch.bench import throughput
from test_torch_assets import asset_root_fixture

REPO = Path(__file__).resolve().parent.parent

synth_root = asset_root_fixture()


def _cli(*args, **env):
    return subprocess.run([sys.executable, "-m", "procgen_torch.bench_cli", *args],
                          capture_output=True, text=True, timeout=600, cwd=REPO,
                          env={**os.environ, **env})


def test_bench_cli_prints_one_line_with_the_loops_checksum(synth_root):
    out = _cli("--device", "cpu", "--games", "maze", "--num-envs", "8", "--chunk", "2",
               "--chunks", "1")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    for key in ("metric", "value", "unit", "per_game", "checksum", "card"):
        assert key in rec, key
    assert rec["metric"] == throughput.METRIC and rec["unit"] == "steps/s"
    assert list(rec["per_game"]) == ["maze"] and rec["per_game"]["maze"] > 0
    assert rec["value"] == rec["per_game"]["maze"] and rec["card"] == "cpu"
    torch.set_num_threads(1)
    here = throughput.bench_game("maze", 8, 2, 1, device="cpu").record
    assert rec["checksum"] == {"maze": here["checksum"]}
    assert 0 < here["checksum"] < 2**32


def test_bench_cli_needs_cuda_unless_the_cpu_is_asked_for():
    out = _cli("--games", "maze", "--num-envs", "8", "--chunk", "2", "--chunks", "1",
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
