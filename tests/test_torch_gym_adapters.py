"""procgen_torch's Gym adapters, terminal player and examples, on the CPU,
in the default configuration (PNG assets from a synthetic root).

* the adapters (``ProcgenVecEnv``, ``ProcgenEnv``, ``ProcgenGymEnv``,
  ``make_env``) against the JAX package's on maze: the same public surface,
  and the JAX package's adapter classes, driven over port envs (their
  ``ProcgenTPUEnv`` replaced by the port's on the CPU, so that nothing
  compiles), give the same observations, rewards, dones and infos as the
  port's adapters, with the same shapes and dtypes;
* ``register_environments`` is a no-op without gym;
* ``interactive.main`` with scripted keys: ``1`` saves, ``2`` restores (the
  step after a restore repeats the frame of the step after the save),
  ``--record-dir`` writes the frames; ``--steps`` autoplays;
* both examples run a few steps on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from procgen_tpu import gym_adapters as j_ga

from procgen_torch import gym_adapters as ga
from procgen_torch import interactive
from procgen_torch.env import ProcgenTorchEnv
from test_torch_assets import asset_root_fixture

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

synth_root = asset_root_fixture()

KW = dict(rand_seed=3, distribution_mode="easy")


def _public(cls):
    return sorted(k for k in vars(cls) if not k.startswith("_"))


@pytest.fixture
def jax_adapters_on_port(monkeypatch):
    """The JAX package's adapters build port envs on the CPU."""
    monkeypatch.setattr(j_ga, "ProcgenTPUEnv",
                        lambda **kw: ProcgenTorchEnv(device="cpu", **kw))


def _same(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{k}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        np.testing.assert_array_equal(x, y, err_msg=where)


def test_vec_env_matches_reference(synth_root, jax_adapters_on_port):
    """Exact: surfaces, shapes, dtypes and values."""
    for cls in ("ProcgenVecEnv", "ProcgenGymEnv"):
        assert _public(getattr(ga, cls)) == _public(getattr(j_ga, cls)), cls
    ours = ga.ProcgenEnv(3, "maze", device="cpu", **KW)
    ref = j_ga.ProcgenEnv(3, "maze", **KW)
    assert ours.num_envs == ref.num_envs == 3
    assert ours.observation_space == ref.observation_space
    assert ours.action_space == ref.action_space
    _same(ours.reset(), ref.reset(), "reset")
    assert ours.reset()["rgb"].shape == (3, 64, 64, 3)
    rs = np.random.RandomState(0)
    for t in range(12):
        a = rs.randint(0, 15, size=3).astype(np.int32)
        _same(ours.step(a), ref.step(a), f"step {t}")
    _same(ours.render(), ref.render(), "render")
    assert ours.render().shape == (64, 64, 3)
    _same(ours.callmethod("get_state"), ref.callmethod("get_state"), "get_state")


def test_gym_env_matches_reference(synth_root, jax_adapters_on_port):
    """Exact: a single env through make_env."""
    ours = ga.make_env("maze", device="cpu", **KW)
    ref = j_ga.make_env("maze", **KW)
    assert ours.action_space_n == ref.action_space_n == 15
    assert ours.metadata == ref.metadata
    _same(ours.reset(), ref.reset(), "reset")
    rs = np.random.RandomState(1)
    for t in range(12):
        a = int(rs.randint(0, 15))
        got, want = ours.step(a), ref.step(a)
        assert type(got[1]) is float and type(got[2]) is bool
        _same(got, want, f"step {t}")
    _same(ours.render(), ref.render(), "render")


def test_register_environments_without_gym():
    """A no-op when gym is missing (as on both machines)."""
    try:
        import gym  # noqa: F401
    except ImportError:
        gym = None
    ga.register_environments()
    if gym is None:
        assert "gym" not in sys.modules


def test_interactive_scripted_keys(synth_root, tmp_path):
    """Exact: the frame after a restore repeats the frame after the save."""
    env = ProcgenTorchEnv(num=1, env_name="maze", device="cpu", **KW)
    player = interactive.Player(env, record=True)
    script = interactive._script_keys("ll1kkj.2ll")
    frames = [player.press(keys) for keys in script]
    assert player.saved_state is not None
    np.testing.assert_array_equal(frames[7], frames[2])  # "1" at step 2, "2" at step 7
    assert not np.array_equal(frames[2], frames[6])
    assert len(player.frames) == len(script)

    out = tmp_path / "rec"
    assert interactive.main(["--env-name", "maze", "--device", "cpu", "--rand-seed", "3",
                             "--keys", "ll1kkj.2ll", "--record-dir", str(out)]) == 0
    rec = np.load(out / "episode.npy")
    assert rec.shape == (10, 64, 64, 3) and rec.dtype == np.uint8
    np.testing.assert_array_equal(rec[7], rec[2])
    assert interactive.main(["--env-name", "maze", "--device", "cpu", "--steps", "4"]) == 0
    assert len(interactive._frame_to_ansi(rec[0]).splitlines()) == 32


@pytest.mark.parametrize("script", ["random_agent_gym_torch.py", "random_agent_gym3_torch.py"])
def test_examples_run(synth_root, script):
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), "--device", "cpu", "--max-steps", "5"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("step ") == 5
