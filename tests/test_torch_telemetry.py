"""``procgen_torch.telemetry``: spans and counters that read one flag and do
nothing else while no profiler session collects, and that keep totals
beside the profiler's own events while one does.

CPU only, no JAX program: maze hard with generated assets, 8 envs, a refill
bucket of 2, three queue slots emptied and their envs at their timeout (so
that the first step refills twice), 4 fast-path steps with their frames,
then one
PPO iteration of 6-step rollouts; the same run with a profiler on and off.
Then each per-layer reader of the benchmark that reads the telemetry, on a
tiny traced run of its cell.
"""

from __future__ import annotations

import importlib
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import procgen_torch
from procgen_torch import convert, telemetry
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env
from procgen_torch.games import make_game
from procgen_torch.learn import ppo
from procgen_torch.parallel import fast
from procgen_torch.render.fast2 import render_frames2
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import seeded_template

N, BUCKET, STEPS = 8, 2, 4
PPO = ppo.PPOConfig(n_steps=6, n_minibatches=2, n_epochs=1)
# the readers of the benchmark's cells that read the telemetry
READERS = {
    "maze-hard.random-4096": ["game_step.ms_per_step.env", "frame.ms_per_step.env",
                              "refill.levelgen.ms_per_call", "refill.bake.ms_per_call",
                              "refill.rows_used.share", "host_reads_per_step.env",
                              "swaps_per_step.env"],
    "miner-hard.random-4096": ["game_step.ms_per_step.env", "frame.ms_per_step.env",
                               "refill.levelgen.ms_per_call", "refill.bake.ms_per_call",
                               "refill.rows_used.share", "host_reads_per_step.env",
                               "swaps_per_step.env", "miner.gravity_sweep.ms_per_step.env",
                               "frame.grid_pass.ms_per_step.env"],
    "maze-hard.ppo-256": ["rollout.share.train", "policy.ms_per_step.train",
                          "gae.ms_per_iter.train", "update.host_s_per_iter.train"],
}


def span_events(prof) -> dict:
    """The profiler's own (count, total ns) per program span name."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in telemetry.SPANS:
            n, ns = out.get(e.name(), (0, 0))
            out[e.name()] = (n + 1, ns + e.end_ns() - e.start_ns())
    return out


def run(cfg, gd, pack, profiled: bool) -> dict:
    """The scenario of the module docstring; with ``profiled`` inside one
    profiler session.  Returns what the run produced, the dones of every
    step, the queue's empty slots at both ends, the telemetry and the
    profiler's span events."""
    fast_init, _ = fast.make_fast_fns(gd, cfg, pack, refill_bucket=N)
    _, fast_step = fast.make_fast_fns(gd, cfg, pack, refill_bucket=BUCKET)
    s = seeded_template(gd, cfg, N, device="cpu")
    fs = fast_init(update_view_params(gd, cfg, reset_env(gd, cfg, s)))
    # envs 0-2 die at the first step with their queue slots empty: two
    # bucket passes, the second writing one of its two rows; env 3 dies at
    # the second step on a full slot
    left = torch.tensor([1, 1, 1, 2, 0, 0, 0, 0], dtype=torch.int32)
    cur_time = torch.where(left > 0, fs.state.timeout - left, 0)
    fs = fast.FastState(fs.state.replace(cur_time=cur_time), fs.queue,
                        fs.queue_valid & torch.tensor([0, 0, 0, 1, 1, 1, 1, 1], dtype=torch.bool))
    dones = []

    def step(fs, actions):
        fs = fast_step(fs, actions)
        dones.append(int(fs.state.done.sum()))
        return fs

    def render(state):
        return render_frames2(gd, cfg, state, pack)

    init_ts, train_iter, _ = ppo.make_train_fns(gd, cfg, pack, PPO, step, render, "cpu")
    gen = torch.Generator().manual_seed(7)
    ts = init_ts(gen)
    actions = torch.randint(0, 15, (STEPS, N), generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32)
    empty0 = int((~fs.queue_valid).sum())

    def body():
        nonlocal fs, ts
        frames = []
        for t in range(STEPS):
            fs = step(fs, actions[t])
            frames.append(render(fs.state))
        ts, fs, _, metrics = train_iter(ts, fs, gen, torch.zeros(N))
        return frames, metrics

    prof = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            frames, metrics = body()
    else:
        frames, metrics = body()
    out = convert.fast_state_to_numpy(fs)
    out["frames"] = torch.stack(frames).numpy()
    out.update({f"metric.{k}": v.float().numpy() for k, v in metrics.items()})
    out.update({f"param.{i}": p.detach().float().numpy()
                for i, p in enumerate(ts.net.parameters())})
    return {"out": out, "dones": dones, "empty": (empty0, int((~fs.queue_valid).sum())),
            "snap": telemetry.snapshot(), "events": span_events(prof) if prof else None}


@pytest.fixture(scope="module")
def runs():
    cfg = EnvConfig(env_name="maze", num_envs=N, distribution_mode=DistributionMode.hard,
                    rand_seed=5, use_generated_assets=True)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        pass  # an empty session: the unprofiled run must leave it empty
    return run(cfg, gd, pack, False), run(cfg, gd, pack, True)


def test_off_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert telemetry.span("procgen_torch.frame") is telemetry.span("procgen_torch.gae")
    with telemetry.span("procgen_torch.frame"):
        telemetry.count("fast.steps")
        telemetry.count("refill.rows_used", torch.ones(3, dtype=torch.bool))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span_events(prof) == {}
    assert telemetry.snapshot() == {"spans": {}, "counters": {}}


def test_self_time_counts_and_device_counters():
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("procgen_torch.rollout"):
            for _ in range(2):
                with telemetry.span("procgen_torch.policy"):
                    time.sleep(0.002)
            time.sleep(0.001)
        telemetry.count("refill.rows_used", torch.tensor(3))
        telemetry.count("refill.rows_used", torch.tensor([True, False, True]))
        telemetry.count("fast.steps", 2)
        telemetry.count("fast.steps")
    snap = telemetry.snapshot()
    n, total, own = snap["spans"]["procgen_torch.rollout"]
    pn, ptotal, pown = snap["spans"]["procgen_torch.policy"]
    assert (n, pn) == (1, 2) and pown == ptotal >= 4_000_000
    assert own == total - ptotal and own >= 1_000_000
    assert snap["counters"] == {"refill.rows_used": 5, "fast.steps": 3}


def test_two_sessions_keep_the_second():
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("procgen_torch.frame"):
            telemetry.count("fast.steps")
    assert set(telemetry.snapshot()["spans"]) == {"procgen_torch.frame"}
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("procgen_torch.gae"):
            pass
    snap = telemetry.snapshot()
    assert set(snap["spans"]) == {"procgen_torch.gae"} and snap["counters"] == {}


def test_the_run_is_bitwise_the_same_with_a_profiler(runs):
    off, on = runs
    assert off["dones"] == on["dones"]
    assert off["out"].keys() == on["out"].keys()
    for k, a in off["out"].items():
        np.testing.assert_array_equal(on["out"][k], a, err_msg=k)
    assert off["snap"] == {"spans": {}, "counters": {}}


def test_spans_match_the_profilers_events(runs):
    _, on = runs
    spans, events = on["snap"]["spans"], on["events"]
    reached = {"procgen_torch.game_step", "procgen_torch.frame", "procgen_torch.refill",
               "procgen_torch.refill.levelgen", "procgen_torch.refill.bake",
               "procgen_torch.rollout", "procgen_torch.policy", "procgen_torch.gae",
               "procgen_torch.update"}
    assert reached <= set(spans) and set(spans) == set(events)
    for name, (n, total, _) in spans.items():
        assert events[name][0] == n, name
        assert abs(total - events[name][1]) <= 0.05 * events[name][1], (name, total, events[name])
    # the refill's direct children are its two halves
    refill = spans["procgen_torch.refill"]
    halves = spans["procgen_torch.refill.levelgen"][1] + spans["procgen_torch.refill.bake"][1]
    assert refill[2] == refill[1] - halves
    assert spans["procgen_torch.refill.levelgen"][0] == refill[0]
    assert spans["procgen_torch.policy"][0] == PPO.n_steps
    assert spans["procgen_torch.game_step"][0] == STEPS + PPO.n_steps


def test_refill_and_step_counters(runs):
    _, on = runs
    counters = on["snap"]["counters"]
    passes = on["snap"]["spans"]["procgen_torch.refill"][0]
    steps = STEPS + PPO.n_steps
    assert passes >= 2 and counters["fast.steps"] == steps
    assert counters["refill.rows"] == passes * BUCKET > counters["refill.rows_used"]
    # every dying env had an entry after the refill and swapped it in, so
    # the slots filled are those that were empty less those still empty,
    # plus the entries the deaths took
    empty0, empty1 = on["empty"]
    assert counters["refill.rows_used"] == empty0 - empty1 + sum(on["dones"])
    # every dying env swapped in its queued level
    assert counters["fast.swaps"] == sum(on["dones"]) > 0
    # the refill's test runs once per pass and once more per step
    assert counters["host_reads.fast.refill_test"] == steps + passes


def test_spans_lists_every_span_of_the_program():
    root = Path(procgen_torch.__file__).parent
    names = set()
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent).with_suffix("")
        if rel.parts[1] in ("bench", "telemetry") or rel.name == "__main__":
            continue
        assert "record_function" not in path.read_text(), rel
        mod = importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
        names |= {v for k, v in vars(mod).items()
                  if k.endswith("_SPAN") and isinstance(v, str) and v.startswith("procgen_torch.")}
    assert names == set(telemetry.SPANS) and len(telemetry.SPANS) == len(names)


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_read_a_tiny_traced_run(cell, tmp_path, monkeypatch):
    import tempfile

    from benchmark import envloop, harness, inputs
    from benchmark.tests.helpers import correct, run_tiny, tiny_cell

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def empty_queue(cell, seeds, root, device):
        # every queue slot empty from the start: the window's first death
        # refills (the inputs are fixed, so it is the same step every run)
        envs = envloop.EnvBatch(cell.config, cell.traffic, device)
        start = envs.start

        def start_empty(phases, order):
            fs = start(phases, order)
            return fast.FastState(fs.state, fs.queue, torch.zeros_like(fs.queue_valid))

        envs.start = start_empty
        return envs

    c = tiny_cell(cell)
    env_cell = "ppo" not in c.traffic
    if c.config["game"] == "miner":
        # miner's 1000-step timeout: every env within three steps of it, so
        # the window's first steps end episodes (the check replays the same)
        monkeypatch.setattr(inputs, "phases",
                            lambda seed, n, timeout: timeout - 2 - np.arange(n) % 3)
    out = run_tiny(c, trace=True, seconds=0.5 if env_cell else 1.0,
                   system=empty_queue if env_cell else None)
    assert correct(out), out.checks
    line = harness.result_line(c, out, True, {"platform": "cpu"})
    for name in READERS[cell]:
        assert line["metrics"][name]["value"] > 0, name
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    for name in READERS[cell]:
        reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
        assert reader.read(out) is None, name
