"""The check fails what it must: the control (the timed path below the
configuration's precision) and each fault a cell can have, planted under
the harness, make ``correct`` false; and the comparisons catch one
perturbed frame byte, state field or parameter."""

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.reference import envs as ref
from benchmark.reference import learner
from benchmark.synth_assets import write_root

from benchmark.tests.helpers import correct, run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["maze-hard.random-4096", "maze-hard.ppo-256"])
@pytest.mark.parametrize("fault", control.FAULTS)
def test_control_and_faults_are_not_correct(name, fault):
    cell = tiny_cell(name)
    stand_in = control.STAND_INS[cell.traffic["driver"]]
    out = run_tiny(cell, system=lambda *a: stand_in(*a, fault=fault))
    assert not correct(out), out.checks


def _own_record(tmp_path, game="miner", steps=12, k=2):
    """A record of the reference's own outputs for ``k`` slots."""
    root = write_root(tmp_path / "assets", 5)
    order, phases = np.arange(4), np.array([990, 3, 480, 7])
    replay = ref.Replay(game, root, 77, order, phases)
    actions = np.random.RandomState(0).randint(0, 15, (steps, k)).astype(np.int32)
    record = {"slots": list(range(k)), "actions": actions, "frames": []}
    cols = {f: [[None] * k for _ in range(steps)] for f in ref.FIELDS}
    frames = [np.zeros((k, 64, 64, 3), np.uint8) for _ in range(steps + 1)]
    for j in range(k):
        for kind, t, want in replay.play(j, actions[:, j], set(range(steps + 1))):
            if kind == "frame":
                frames[t][j] = want
            else:
                for f in ref.FIELDS:
                    cols[f][t][j] = np.array(want[f], copy=True)
    dtypes = {"reward": np.float32, "done": bool, "agent_x": np.float32, "agent_y": np.float32}
    for f in ref.FIELDS:
        record[f] = np.array(cols[f], dtype=dtypes.get(f, np.int32))
    record["frames"] = list(enumerate(frames))
    return replay, record


def test_the_comparison_catches_one_perturbed_value(tmp_path):
    replay, record = _own_record(tmp_path)
    checks, _ = ref.check(replay, record, min_levels=1)
    assert all(v == 0 for _, v, _ in checks), checks  # slot 0 times out at step 10
    perturbed = [("grid", (5, 1, 3, 4)), ("agent_x", (7, 0)), ("level_seed", (11, 0)),
                 ("done", (2, 1)), ("cur_time", (9, 1))]
    for field, at in perturbed:
        bad = {**record, field: record[field].copy()}
        v = bad[field][at]
        bad[field][at] = (np.nextafter(v, np.float32(99)) if field == "agent_x"
                          else not v if field == "done" else v + 1)
        checks, _ = ref.check(replay, bad, min_levels=1)
        assert dict((n, v) for n, v, _ in checks)["step_mismatches"] == 1, field


def test_negative_zero_reward_is_caught(tmp_path):
    replay, record = _own_record(tmp_path, game="maze", steps=4, k=1)
    bad = {**record, "reward": record["reward"].copy()}
    bad["reward"][1, 0] = -0.0
    checks, _ = ref.check(replay, bad, min_levels=0)
    assert dict((n, v) for n, v, _ in checks)["step_mismatches"] == 1


def test_one_frame_byte_and_too_few_levels_are_caught(tmp_path):
    replay, record = _own_record(tmp_path, game="maze", steps=4, k=1)
    frames = [(s, f.copy()) for s, f in record["frames"]]
    frames[3][1][0, 5, 6, 2] ^= 1
    checks, _ = ref.check(replay, {**record, "frames": frames}, min_levels=2)
    got = dict((n, v) for n, v, _ in checks)  # one level swapped in, at step 0
    assert got["frame_mismatches"] == 1 and got["levels_short"] == 1


def test_one_parameter_perturbed_is_caught():
    params = [torch.ones(4, 4), torch.ones(7), torch.ones(3)]
    same = [p.clone() for p in params]
    assert learner.leaf_gaps(same, params) == 0.0
    same[1][2] += 0.5
    assert learner.leaf_gaps(same, params) > 0.05
