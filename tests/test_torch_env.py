"""procgen_torch's gym3 surface (``ProcgenTorchEnv``) against procgen_tpu's
(``ProcgenTPUEnv``), both with generated assets, on the CPU.

Maze and miner, 4 envs, 32 act/observe rounds with random actions and a
forced reset (action -1): rewards, firsts, frames and infos equal, and the
whole state equal field for field (the inline auto-reset and the per-level
static layer included).  Coinrun, leaper, ninja, jumper, caveflyer and
dodgeball run through the surface on the port alone.  Then the master-seed
dealing of the joint env and the surface's refusals.
"""

import numpy as np
import pytest
import torch

from procgen_tpu.env import ProcgenTPUEnv

from procgen_torch import convert
from procgen_torch import rng as R
from procgen_torch.env import ProcgenJointEnv, ProcgenTorchEnv, make_procgen_env
from procgen_torch.render import assets
from test_torch_fast_path import assert_fields_equal, jax_fields

torch.set_num_threads(1)

N = 4


@pytest.mark.parametrize("game,mode", [("maze", "easy"), ("miner", "hard")])
def test_env_matches_reference(game, mode):
    kw = dict(
        env_name=game, rand_seed=5, distribution_mode=mode, use_generated_assets=True,
    )
    ref = ProcgenTPUEnv(N, **kw)
    env = ProcgenTorchEnv(N, device="cpu", **kw)
    assert env.ob_space == ref.ob_space and env.ac_space == ref.ac_space
    assert env.state.done.device.type == "cpu"

    rng = np.random.RandomState(3)
    firsts = 0
    for t in range(33):
        want, got = ref.observe(), env.observe()
        for w, g in zip((want[0], want[2]), (got[0], got[2])):
            np.testing.assert_array_equal(w, g, err_msg=f"observe at step {t}")
        np.testing.assert_array_equal(want[1]["rgb"], got[1]["rgb"], err_msg=f"frame at step {t}")
        assert ref.get_info() == env.get_info(), t
        assert_fields_equal(
            jax_fields(ref.state), convert.state_to_numpy(env.state), f"at step {t}"
        )
        firsts += int(got[2].sum())
        if t == 32:
            break
        acts = rng.randint(0, 15, size=N).astype(np.int32)
        if t == 10:
            acts[1] = -1  # forced reset: the inline level generation
        ref.act(acts)
        env.act(acts)
    assert firsts >= 1


@pytest.mark.parametrize("game", ["coinrun", "leaper", "ninja", "jumper", "caveflyer", "dodgeball"])
def test_env_runs_new_games(game):
    """The gym3 surface on coinrun, leaper, ninja, jumper, caveflyer and
    dodgeball (their steps and
    resets are held against procgen_tpu in tests/test_torch_<game>.py):
    act/observe rounds with a forced reset give a new level and a first
    flag, frames on the view of the live state."""
    env = ProcgenTorchEnv(2, game, rand_seed=9, use_generated_assets=True, device="cpu")
    seeds = env.state.current_level_seed.clone()
    rng = np.random.RandomState(4)
    for t in range(4):
        acts = rng.randint(0, 15, size=2).astype(np.int32)
        if t == 2:
            acts[0] = -1  # forced reset
        env.act(acts)
        rew, ob, first = env.observe()
        assert ob["rgb"].shape == (2, 64, 64, 3) and ob["rgb"].dtype == np.uint8
        assert (ob["rgb"] > 0).mean() > 0.9 and np.isfinite(rew).all()
        np.testing.assert_array_equal(ob["rgb"], env.render_fn(env.state).numpy())
        if t == 2:
            assert first[0] and env.state.current_level_seed[0] != seeds[0]


def test_joint_env_master_seed_dealing():
    """Env n (interleaved) gets the n-th draw of one master MT19937 seeded
    with rand_seed (vecgame.cpp:301-314)."""
    rand_seed = 77
    joint = make_procgen_env(
        4, "maze,miner", rand_seed=rand_seed, render=False, use_generated_assets=True,
        device="cpu",
    )
    assert isinstance(joint, ProcgenJointEnv)
    master = R.HostMT(rand_seed)
    expect = [master.randint_full() for _ in range(4)]
    # sub-env j slot s == global env s * 2 + j
    for j, env in enumerate(joint.envs):
        for s in range(env.num):
            rg = R.HostMT(expect[s * 2 + j] & 0xFFFFFFFF)
            lo, hi = env.cfg.level_seed_low, env.cfg.level_seed_high
            want_level = lo + rg.raw() % (hi - lo)
            assert int(env.state.current_level_seed[s]) == want_level, (j, s)
    infos = joint.get_info()
    assert [i["level_seed"] for i in infos[1::2]] == [
        int(v) for v in joint.envs[1].state.current_level_seed
    ]
    rew, ob, first = joint.observe()
    assert rew.shape == (4,) and ob == {} and first.all()
    joint.act(np.zeros(4, np.int32))


def test_env_refusals(monkeypatch):
    env = ProcgenTorchEnv(2, "maze", rand_seed=1, use_generated_assets=True, device="cpu")
    for call in (env.get_state, lambda: env.set_state([]), lambda: env.callmethod("get_state")):
        with pytest.raises(NotImplementedError, match="A9"):
            call()
    with pytest.raises(NotImplementedError, match="A11"):
        ProcgenTorchEnv(2, "maze", use_generated_assets=True, render_mode="rgb_array", device="cpu")
    # PNG assets (the default) need an asset root; there is none here
    monkeypatch.delenv(assets.ROOT_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=assets.ROOT_ENV):
        ProcgenTorchEnv(2, "maze", device="cpu")
    assert env.keys_to_act([("LEFT", "UP"), ("Q",), ("X",)])[0].tolist() == [2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ProcgenTorchEnv(2, "maze", use_generated_assets=True)  # device="cuda"
