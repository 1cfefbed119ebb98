"""A later change adds a cell and a per-layer metric by adding files: in a
copy of the benchmark, a new traffic file, a new reader and their entries
in BENCHMARK.json run without an edit to any file already there."""

import json
import shutil

from benchmark import harness
from benchmark.tests.helpers import ROOT, correct, run_tiny

READER = '''"""Frames per second of the traced window."""


def read(run):
    return run.counts["frames"] / run.trace.window_s
'''


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/random-4096.json").read_text())
    (tmp_path / "benchmark/traffic/random-12.json").write_text(
        json.dumps(dict(traffic, num_envs=12, refill_bucket=3,
                        check=dict(traffic["check"], envs=12, near_timeout=0, min_levels=0))))
    (tmp_path / "benchmark/metrics/frames_per_s.py").write_text(READER)
    bench["workloads"].append({"name": "maze-hard.random-12", "config": "maze-hard",
                               "traffic": "random-12", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("maze-hard.random-12")
    bench["per_layer"].append({"name": "frames_per_s", "unit": "frames/s", "better": "higher",
                               "source": "program_counter", "layer": "render.fast2",
                               "moves": "env_steps_per_s",
                               "workloads": ["maze-hard.random-12"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell("maze-hard.random-12", tmp_path)
    assert cell.traffic["num_envs"] == 12
    out = run_tiny(cell, seconds=1.0, trace=True)
    assert correct(out), out.checks
    line = harness.result_line(cell, out, True, {"platform": "cpu"})
    assert line["metrics"]["frames_per_s"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed
