"""Miner hard across a level swap: the fast path carries the diamond count
of the level that ended into the next, as procgen's C++ keeps its member
(miner.cpp:23, recomputed only by a step's sweep at :305) and as the
inline reset does.

CPU only, no JAX program:

* the fast path (refill bucket 2) against the inline path (``step_env``)
  over 40 steps of 8 envs, swaps by timeout, by death and forced (action
  -1): every state field, ``extra.diamonds_remaining`` included, but the
  action bookkeeping a queued level takes from the step that generated it
  (``_ACTION_FIELDS`` of tests/test_torch_coinrun.py), and every frame;
* the case of ``benchmark/tools/miner_refill_witness.py``: every env times
  out on its first step, and a slot whose second level puts the exit next
  to the agent steps onto it; the fast path's reward and done there equal
  the benchmark's reference (``benchmark/reference``), which does not win
  with diamonds left;
* the benchmark's cell ``miner-hard.random-4096`` cut to 8 envs, every
  phase within 8 steps of the timeout: the reference's check is correct
  and every slot swaps in a level;
* the carry adds no torch op to the step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import envloop, inputs
from benchmark.reference import envs as ref
from benchmark.reference.games import INT32_MAX, Miner
from benchmark.reference.mt import RandGen
from benchmark.tests.helpers import tiny_cell
from procgen_torch import convert
from procgen_torch.bench.profiling import profiled
from procgen_torch.engine.game import step_env
from procgen_torch.parallel import fast
from procgen_torch.render import assets, fast2
from procgen_torch.render.renderer import update_view_params
from test_torch_coinrun import _ACTION_FIELDS
from test_torch_fast_path import assert_fields_equal

torch.set_num_threads(2)

CELL = "miner-hard.random-4096"
N = 8
# a level-seed master whose envs 0 and 2 start their second level with the
# exit just above and just left of the agent (found with the reference)
WITNESS_MASTER = 272


@pytest.fixture(autouse=True)
def asset_root(tmp_path, monkeypatch):
    """The benchmark's synthetic PNG root under this test's own directory."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv(assets.ROOT_ENV, "")  # restored after the test
    yield envloop.write_assets(5)
    assets.clear_caches()


def _cell(bucket=2):
    return tiny_cell(CELL, num_envs=N, bucket=bucket)


def _envs(cell, master=None):
    traffic = cell.traffic
    if master is not None:
        traffic = dict(traffic, fixed=dict(traffic["fixed"], levels=master))
    return envloop.EnvBatch(cell.config, traffic, "cpu")


def test_fast_path_matches_inline_across_swaps():
    envs = _envs(_cell())
    gd, cfg, pack = envs.gd, envs.cfg, envs.pack
    assert gd.kept_across_reset == ("diamonds_remaining",)
    phases = np.array([999, 996, 993, 990, 987, 984, 10, 500], np.int32)
    fs = envs.start(phases, np.arange(N))
    inline = fs.state
    gen = torch.Generator().manual_seed(3)

    def fields(state):
        return {k: v for k, v in convert.state_to_numpy(state).items()
                if k not in _ACTION_FIELDS}

    forced, swaps, carried = (30, 31), 0, 0
    for t in range(40):
        acts = torch.randint(0, 15, (N,), generator=gen, dtype=torch.int32)
        if t in forced:
            acts[:] = -1
        queued = fs.queue.extra["diamonds_remaining"]
        fs = envs.step(fs, acts)
        stepped = update_view_params(gd, cfg, step_env(gd, cfg, inline, acts))
        inline = stepped.replace(static_layer=torch.where(
            stepped.done[:, None, None, None], fast2.render_static2(gd, cfg, stepped, pack),
            stepped.static_layer))
        assert_fields_equal(fields(inline), fields(fs.state), f"at step {t}")
        np.testing.assert_array_equal(envs.frame(inline).numpy(), envs.frame(fs.state).numpy(),
                                      err_msg=f"frame diverged at step {t}")
        done = fs.state.done
        if t not in forced:
            swaps += int(done.sum())
        # rows whose queued level held another count than the one carried
        carried += int((done & (queued != fs.state.extra["diamonds_remaining"])).sum())
    assert swaps >= 6 and carried >= 6 + N, (swaps, carried)


def _second_level_exit_steps(master):
    """Per env of ``master``'s first N level-seed streams whose second level
    has the exit next to the agent: the action that moves onto it and the
    exit's position."""
    game, steps = Miner(), {}
    for j, seed in enumerate(ref.level_seeds(master, N)):
        stream = RandGen(seed)
        stream.randint(0, INT32_MAX)
        second = stream.randint(0, INT32_MAX)
        agent, exit_ = game.reset(RandGen(second), second, None).ents
        dx, dy = int(exit_.x - agent.x), int(exit_.y - agent.y)
        if abs(dx) + abs(dy) == 1:
            steps[j] = (dx + 1) * 3 + dy + 1, (exit_.x, exit_.y)  # procgen's action
    return steps


def test_first_step_of_a_swapped_level_matches_the_reference(asset_root):
    onto_exit = _second_level_exit_steps(WITNESS_MASTER)
    assert sorted(onto_exit) == [0, 2]
    cell = _cell(bucket=1)
    envs = _envs(cell, WITNESS_MASTER)
    order, phases = np.arange(N), np.full(N, envs.timeout - 1, np.int32)
    fs = envs.start(phases, order)
    gen = torch.Generator().manual_seed(1)
    first = torch.randint(0, 15, (N,), generator=gen, dtype=torch.int32)
    second = torch.randint(0, 15, (N,), generator=gen, dtype=torch.int32)
    for j, (a, _) in onto_exit.items():
        second[j] = a
    fs = envs.step(fs, first)
    assert bool(fs.state.done.all())  # every env swapped in its second level
    kept = fs.state.extra["diamonds_remaining"]
    fs = envs.step(fs, second)
    replay = ref.Replay("miner", asset_root, WITNESS_MASTER, order, phases)
    for j, (_, exit_at) in onto_exit.items():
        want = [w for kind, _, w in replay.play(j, [int(first[j]), int(second[j])], set())
                if kind == "step"][1]
        assert float(fs.state.reward[j]) == float(want["reward"]), j
        assert bool(fs.state.done[j]) == want["done"], j
        # the agent stands on the exit with diamonds left: no win
        assert (want["agent_x"], want["agent_y"]) == exit_at, j
        assert (float(fs.state.ents.x[j, 0]), float(fs.state.ents.y[j, 0])) == exit_at, j
        assert int(kept[j]) > 0 and float(want["reward"]) < 10.0, j


def test_the_cell_cut_to_8_envs_runs_correct_near_the_timeout(asset_root):
    cell = _cell()
    envs = _envs(cell)
    order = inputs.order(11, N)
    phases = (envs.timeout - 1 - np.arange(N)).astype(np.int32)
    fs = envs.start(phases, order)
    gen = inputs.action_generator(cell.traffic["fixed"]["actions"], "cpu")
    rec = envloop.Recorder(list(range(N)), "cpu")
    rec.frame(envs.frame(fs.state))
    for _ in range(12):
        actions = inputs.random_actions(gen, N)
        fs = envs.step(fs, actions)
        rec.step(fs.state, actions)
        rec.frame(envs.frame(fs.state))
    record = rec.host()
    assert record["done"].any(0).all()  # every slot swapped in a level
    cell.traffic["check"] = dict(cell.traffic["check"], min_levels=N)
    checks, notes = envloop.check_envs(cell, asset_root, order, phases, record)
    assert all(v <= lim for _, v, lim in checks), (checks, notes)


@pytest.mark.parametrize("game_cell", ["maze-hard.random-4096", CELL])
def test_the_carry_adds_no_op(game_cell, monkeypatch):
    """The fast step's torch ops (the profiler's count, as
    ``procgen_torch.bench.op_counts`` takes it) with the game's declared
    kept fields and with none: the same.  Maze declares none."""
    cell = tiny_cell(game_cell, num_envs=N, bucket=2)
    envs = envloop.EnvBatch(cell.config, cell.traffic, "cpu")
    gd = envs.gd
    if game_cell != CELL:
        assert gd.kept_across_reset == ()
    phases = np.array([999, 998, 0, 1, 2, 3, 4, 5], np.int32)
    fs = envs.start(phases, np.arange(N))
    acts = torch.randint(0, 15, (N,), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    span = "test.fast_step"

    def ops(kept):
        monkeypatch.setattr(gd, "kept_across_reset", kept)
        _, step = fast.make_fast_fns(gd, envs.cfg, envs.pack, refill_bucket=2)
        step(fs, acts)  # warm-up

        def one():
            with torch.profiler.record_function(span):
                out = step(fs, acts)
            assert bool(out.state.done[0])
        _, summary = profiled(one, (span,), cuda=False)
        return summary["ops"][span]

    assert ops(type(gd).kept_across_reset) == ops(()) > 0
