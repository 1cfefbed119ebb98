"""Rank processes of the port's distributed CPU tests
(tests/test_torch_sharding.py, tests/test_torch_learn_dp.py).

The tests spawn these functions over gloo, one process per rank, meeting
through a file store under the test's ``tmp_path``.  A spawned process
imports this module by name, so it imports only torch, numpy and
procgen_torch: the JAX side of a comparison runs in the test process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle

import numpy as np
import torch

from procgen_torch.parallel import sharding

# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------


def odd_floats(n: int) -> dict:
    """Float leaves whose bits an all-reduce of floats would not keep:
    negative zeros and NaNs with payloads, and a bool leaf."""
    bits = np.arange(n, dtype=np.int64) * 977 + 0x7FC00001
    return dict(neg_zero=torch.full((n, 3), -0.0),
                nan=torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy()),
                flag=torch.arange(n) % 3 == 0)


def roundtrip_rank(rank: int, world: int, init_method: str, out_dir: str, game: str,
                   num_envs: int):
    """``shard_env_state`` then ``make_global_env_state`` on a global fast
    state (built the same on every rank) and ``odd_floats``: rank 0 writes
    both trees' leaves; every rank writes its ``host_env_slice`` and
    ``rank_unique_seed``."""
    torch.set_num_threads(1)
    from procgen_torch.config import DistributionMode, EnvConfig
    from procgen_torch.engine.game import reset_env
    from procgen_torch.games import make_game
    from procgen_torch.parallel.fast import make_fast_fns
    from procgen_torch.render.pack import RenderPack
    from procgen_torch.render.renderer import update_view_params
    from procgen_torch.state import seeded_template, tree_map

    mesh = sharding.init_distributed(init_method, world, rank, device="cpu")
    try:
        cfg = EnvConfig(env_name=game, num_envs=num_envs, rand_seed=5,
                        distribution_mode=DistributionMode.easy, use_generated_assets=True)
        gd = make_game(cfg)
        fast_init, _ = make_fast_fns(gd, cfg, RenderPack(gd, cfg), refill_bucket=num_envs)
        state = seeded_template(gd, cfg, num_envs, "cpu")
        glob = dict(fs=fast_init(update_view_params(gd, cfg, reset_env(gd, cfg, state))),
                    odd=odd_floats(num_envs))
        local = sharding.shard_env_state(glob, mesh)
        back = sharding.make_global_env_state(local, mesh)
        leaves = []
        tree_map(lambda a, b, c: leaves.append((a.numpy(), b.numpy(), c.shape[0])),
                 glob, back, local)
        record = dict(slice=sharding.host_env_slice(num_envs),
                      seed=sharding.rank_unique_seed(1234),
                      leaves=leaves if rank == 0 else None)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"roundtrip{rank}.pkl"), "wb") as f:
        pickle.dump(record, f)


# ---------------------------------------------------------------------------
# the data-parallel learner over a toy env (tests/test_torch_learn.py's)
# ---------------------------------------------------------------------------

TOY_N, TOY_T = 4, 8
TOY_EP_LEN = (3, 5, 7, 100)  # per-env episode lengths: three end in the rollout
TOY_POS = (3, 40, 77, 150)
TOY_TIME = (0, 2, 0, 90)
TOY_DONE = (True, False, False, False)
TOY_EP_ACC = (0.5, 1.0, 0.0, 2.0)


@dataclasses.dataclass
class ToyState:
    pos: torch.Tensor
    t: torch.Tensor
    ep_len: torch.Tensor
    k: int
    acts: torch.Tensor  # (T, n): every action taken
    done: torch.Tensor
    reward: torch.Tensor


@dataclasses.dataclass
class ToyFS:
    state: ToyState


def toy_step(fs, action):
    s = fs.state
    t = s.t + 1
    reward = (action == s.pos % 15).float() + 0.25 * (action % 3).float()
    done = t >= s.ep_len
    pos = torch.where(done, (s.pos * 7 + action + 1) % 251, s.pos + action)
    acts = s.acts.clone()
    acts[s.k] = action
    return ToyFS(ToyState(pos, torch.where(done, 0, t), s.ep_len, s.k + 1, acts, done, reward))


def toy_render(s):
    yy, xx, cc = torch.meshgrid(torch.arange(64), torch.arange(64), torch.arange(3), indexing="ij")
    v = s.pos[:, None, None, None] * 13 + s.t[:, None, None, None] * 29 + xx * 3 + yy * 5 + cc * 71
    return (v % 256).to(torch.uint8)


def toy_start(start: int = 0, count: int = TOY_N):
    """The toy env's rows ``[start, start + count)`` and their episode
    return accumulators."""
    def rows(v, dtype):
        return torch.tensor(v[start:start + count], dtype=dtype)

    fs = ToyFS(ToyState(rows(TOY_POS, torch.int32), rows(TOY_TIME, torch.int32),
                        rows(TOY_EP_LEN, torch.int32), 0,
                        torch.zeros((TOY_T, count), dtype=torch.int32),
                        rows(TOY_DONE, torch.bool), torch.zeros(count)))
    return fs, rows(TOY_EP_ACC, torch.float32)


class Replay:
    """``ppo.gumbel`` and ``ppo.permutation`` returning recorded draws in
    order (the JAX package's, made in the test process)."""

    def __init__(self, gumbels, perms):
        self.gumbels, self.perms = list(gumbels), list(perms)

    def gumbel(self, shape, generator, device):
        g = torch.from_numpy(self.gumbels.pop(0))
        assert tuple(g.shape) == tuple(shape), (g.shape, shape)
        return g

    def permutation(self, n, generator, device):
        p = torch.from_numpy(self.perms.pop(0))
        assert p.shape == (n,), (p.shape, n)
        return p


def train_iter_once(state_dict, cfg: dict, draws, mesh=None):
    """One ``train_iter`` of the port's learner (float32 net) over this
    rank's rows of the toy env, the draws replayed.  Returns (the net's
    parameters after it, actions (T, n), ep_acc, metrics as floats,
    optimizer steps)."""
    from procgen_torch.learn import ppo
    from procgen_torch.learn.nets import ImpalaCNN

    start, count = (0, TOY_N) if mesh is None else sharding.env_sharding(mesh, TOY_N)
    replay = Replay(*draws)
    saved = ppo.gumbel, ppo.permutation, ppo.ImpalaCNN
    ppo.gumbel, ppo.permutation = replay.gumbel, replay.permutation
    ppo.ImpalaCNN = functools.partial(ImpalaCNN, dtype=torch.float32)
    try:
        init, train_iter, _ = ppo.make_train_fns(None, None, None, ppo.PPOConfig(**cfg), toy_step,
                                                 toy_render, "cpu", mesh)
        ts = init(torch.Generator().manual_seed(0))
        ts.net.load_state_dict(state_dict)
        fs, ep_acc = toy_start(start, count)
        ts, fs, ep_acc, metrics = train_iter(ts, fs, None, ep_acc)
    finally:
        ppo.gumbel, ppo.permutation, ppo.ImpalaCNN = saved
    assert not replay.gumbels and not replay.perms
    params = {k: v.detach().clone() for k, v in ts.net.state_dict().items()}
    return (params, fs.state.acts.clone(), ep_acc, {k: float(v) for k, v in metrics.items()},
            ts.step)


def learn_rank(rank: int, world: int, init_method: str, out_dir: str, state_dict, cfg, draws):
    """``train_iter_once`` under a gloo mesh of ``world`` ranks; every rank
    writes its result."""
    torch.set_num_threads(1)
    mesh = sharding.init_distributed(init_method, world, rank, device="cpu")
    try:
        params, acts, ep_acc, metrics, steps = train_iter_once(state_dict, cfg, draws, mesh)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"learn{world}-{rank}.pkl"), "wb") as f:
        pickle.dump(dict(params={k: v.numpy() for k, v in params.items()}, acts=acts.numpy(),
                         ep_acc=ep_acc.numpy(), metrics=metrics, steps=steps), f)
