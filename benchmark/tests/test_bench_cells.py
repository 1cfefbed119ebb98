"""Each cell's driver and the reference at a tiny size on the CPU: the run
is correct, reports its end-to-end metrics, and its traced run feeds every
per-layer reader of the cell."""

import json

import pytest

from benchmark import harness

from benchmark.tests.helpers import ROOT, correct, run_tiny, tiny_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_cpu(name):
    cell = tiny_cell(name)
    out = run_tiny(cell)
    assert correct(out), out.checks
    assert out.attempted > 0 and out.failed == 0
    for m in cell.end_to_end:
        assert out.metrics[m["name"]] > 0, m["name"]
    line = harness.result_line(cell, out, False, {"platform": "cpu"})
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", ["maze-hard.random-4096", "maze-hard.ppo-256"])
def test_traced_run_feeds_the_readers(name):
    cell = tiny_cell(name)
    out = run_tiny(cell, trace=True, seconds=1.0)
    assert correct(out), out.checks
    line = harness.result_line(cell, out, True, {"platform": "cpu"})
    # the spans of every step are there; a refill may not have run; no
    # device on the CPU: its readers find an idle card and no kernel
    always = {"game_step.share.env", "frame.share.env", "device.idle_share.env",
              "device.idle_share.train", "mfu.train", "env_steps_per_s.train"}
    for m in cell.per_layer:
        if m["name"] in always:
            assert line["metrics"][m["name"]]["value"] > 0, m["name"]
    assert not any("roofline" in name for name in line["metrics"])


def test_setup_and_window_are_timed_apart():
    out = run_tiny(tiny_cell("maze-hard.random-4096"), seconds=1.0)
    assert out.metrics["setup_s"] > 0
    assert out.metrics["env_steps_per_s"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(cuda, name):
    cell = tiny_cell(name, num_envs=64, bucket=16)
    out = run_tiny(cell, seconds=3.0, device=cuda)
    assert correct(out), out.checks
