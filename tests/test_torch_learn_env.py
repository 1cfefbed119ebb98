"""The port's learner on its real env path, on the CPU: maze easy with
generated assets, 4 envs, 8-step rollouts, the full-width bf16 net.

The rollout's observations are the fast path's own frames for the actions
it took; one ``train_iter`` gives finite losses and moves the parameters;
the phase stagger draws train.py's numpy offsets; and the CLI prints the
JAX package's JSON keys, runs on the card by default and raises without
CUDA or without an asset root.  No JAX program is compiled here.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from procgen_torch import convert
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.learn import ppo, train
from procgen_torch.learn.nets import ImpalaCNN
from procgen_torch.render import assets
from procgen_torch.render.fast2 import render_frames2
from test_torch_assets import _clear_caches, asset_root_fixture

N, T = 4, 8
SEED = 1
PPO = ppo.PPOConfig(n_steps=T, n_minibatches=2, n_epochs=1)
# the keys of procgen_tpu/learn/train.py's JSON line: its metrics
# (procgen_tpu/learn/ppo.py:211-220), then train.py:117-121
JAX_CLI_KEYS = ["loss", "pg_loss", "v_loss", "entropy", "reward_per_step", "episode_ends",
                "mean_ep_return", "episodes", "iter", "env_steps", "steps_per_sec"]

synth_root = asset_root_fixture()


def maze_cfg() -> EnvConfig:
    return EnvConfig(env_name="maze", num_envs=N, distribution_mode=DistributionMode.easy,
                     rand_seed=SEED, use_generated_assets=True)


def test_rollout_obs_are_the_fast_paths_frames():
    env = train.make_env(maze_cfg(), "cpu")
    net = ImpalaCNN(generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    fs_end, traj, last_value = ppo.rollout(net, env.fs, gen, PPO, env.fast_step, env.render_fn)
    assert traj.obs.shape == (T, N, 64, 64, 3) and traj.obs.dtype == torch.uint8
    assert traj.action.dtype == torch.int32 and torch.isfinite(traj.logp).all()

    # the same envs again, stepped with the rollout's actions
    replay = train.make_env(maze_cfg(), "cpu")
    gd, cfg, pack, fs = replay.gd, replay.cfg, replay.pack, replay.fs
    for t in range(T):
        assert torch.equal(traj.obs[t], render_frames2(gd, cfg, fs.state, pack)), t
        assert torch.equal(traj.done[t], fs.state.done), t
        fs = replay.fast_step(fs, traj.action[t])
        assert torch.equal(traj.reward[t], fs.state.reward), t
    want, got = convert.fast_state_to_numpy(fs), convert.fast_state_to_numpy(fs_end)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    with torch.no_grad():
        _, v = net(render_frames2(gd, cfg, fs.state, pack))
    assert torch.equal(last_value, v)


def test_train_iter_moves_the_parameters():
    env = train.make_env(maze_cfg(), "cpu")
    init, train_iter, _ = ppo.make_train_fns(env.gd, env.cfg, env.pack, PPO, env.fast_step,
                                             env.render_fn, "cpu")
    gen = torch.Generator().manual_seed(3)
    ts = init(gen)
    assert ts.net.dtype == torch.bfloat16
    before = [p.detach().clone() for p in ts.net.parameters()]
    ts, fs, ep_acc, m = train_iter(ts, env.fs, gen, torch.zeros(N))
    assert ts.step == PPO.n_epochs * PPO.n_minibatches
    for k in ("loss", "pg_loss", "v_loss", "entropy", "reward_per_step"):
        assert torch.isfinite(m[k]), k
    assert ep_acc.shape == (N,) and fs.state.done.shape == (N,)
    changed = [not torch.equal(a, b) for a, b in zip(before, ts.net.parameters())]
    assert all(changed), changed


def test_stagger_offsets_are_train_pys():
    """procgen_tpu/learn/train.py:313-317: ``RandomState(rand_seed +
    0x5AFE).random_sample(num_envs) * timeout``, cast to int32."""
    staggered = train.make_env(maze_cfg(), "cpu").fs.state
    plain = train.make_env(maze_cfg(), "cpu", stagger_phases=False).fs.state
    timeout = plain.timeout.numpy()
    want = (np.random.RandomState(SEED + 0x5AFE).random_sample(N) * timeout).astype(np.int32)
    np.testing.assert_array_equal(staggered.cur_time.numpy(), want)
    assert want.any() and not plain.cur_time.any()


def test_cli_prints_the_jax_keys(synth_root, capsys):
    rc = train.main(["maze", "--device", "cpu", "--num-envs", str(N), "--n-steps", str(T),
                     "--iters", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    m = json.loads(lines[0])
    assert list(m) == JAX_CLI_KEYS
    assert m["iter"] == 1 and m["env_steps"] == N * T and np.isfinite(m["loss"])


def test_cli_defaults_to_the_card(monkeypatch):
    """Without CUDA the default device raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["maze", "--iters", "1"])


def test_cli_raises_without_asset_root(monkeypatch):
    monkeypatch.delenv(assets.ROOT_ENV, raising=False)
    _clear_caches()
    try:
        with pytest.raises(FileNotFoundError, match=assets.ROOT_ENV):
            train.main(["maze", "--device", "cpu", "--num-envs", "2", "--iters", "1"])
    finally:
        _clear_caches()
