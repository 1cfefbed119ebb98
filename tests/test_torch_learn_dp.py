"""The data-parallel learner (procgen_torch/learn/ppo.py under a sharded
mesh) against the JAX package's ``train_iter`` over a 4-device mesh, on
the CPU.

The toy env of tests/test_torch_learn.py (4 envs, 8 steps, three episodes
ending in the rollout) runs in both frameworks: the JAX side in this
process, its state and the episode accumulators sharded over
``make_env_mesh(4)`` (one env per device); the port's in spawned gloo ranks
(tests/torch_dist_children.py) at W=1 (a one-rank group) and W=4, and
without a group in this process.  The port replays the JAX draws (the
Gumbel noise of the global logits, the permutations of the global batch),
recorded here as numpy.  Checked: the actions bit for bit, every parameter
within 1e-6 absolute and the metrics within rtol 1e-4 / atol 1e-5 of JAX
(the tolerances of test_torch_learn.py's test_train_iter_matches_jax), and
at W=4 the ranks' parameters bitwise equal.
"""

from __future__ import annotations

import functools
import pickle

import numpy as np
import pytest
import torch

from procgen_torch.parallel import sharding

import torch_dist_children as children

torch.set_num_threads(1)

CFG = dict(n_steps=children.TOY_T, n_minibatches=2, n_epochs=2)
METRICS = ("loss", "pg_loss", "v_loss", "entropy", "reward_per_step", "mean_ep_return")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX train_iter over the 4-device mesh, its parameters and
    draws: (state_dict of the initial parameters, draws, JAX results)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import procgen_tpu.learn.ppo as jppo
    from procgen_tpu.learn.nets import ImpalaCNN as JaxImpala
    from procgen_tpu.parallel.sharding import make_env_mesh
    from procgen_torch import convert
    from test_torch_learn import (JaxDraws, flat_np, jax_fns, jax_toy_render, jax_toy_step,
                                  port_net, random_flax_params, toy_start)

    mp = pytest.MonkeyPatch()
    mp.setattr(jppo, "ImpalaCNN", functools.partial(JaxImpala, dtype=jnp.float32))
    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        init_j, iter_j, _ = jax_fns(jppo.PPOConfig(**CFG), jax_toy_step, jax_toy_render)
        ts = init_j(jax.random.PRNGKey(9))
        _, params = random_flax_params(10)
        ts = ts._replace(params=params)
        jfs, _ = toy_start()
        mesh = make_env_mesh(4)

        def shard(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

        s = jfs.state
        jfs = type(jfs)(s._replace(pos=shard(s.pos, P("env")), t=shard(s.t, P("env")),
                                   acts=shard(s.acts, P(None, "env")),
                                   done=shard(s.done, P("env")),
                                   reward=shard(s.reward, P("env"))))
        ep_acc = shard(jnp.asarray(children.TOY_EP_ACC, jnp.float32), P("env"))
        key = jax.random.PRNGKey(11)
        ts2, jfs2, acc, m = jax.jit(iter_j)(ts, jfs, key, ep_acc)
        assert len(acc.sharding.device_set) == 4
        draws = JaxDraws(key)
        gumbels = [draws.gumbel((children.TOY_N, 15), None, None).numpy()
                   for _ in range(children.TOY_T)]
        perms = [draws.permutation(children.TOY_T * children.TOY_N, None, None).numpy()
                 for _ in range(CFG["n_epochs"])]
        want = dict(params=flat_np(ts2.params), acts=np.asarray(jfs2.state.acts),
                    ep_acc=np.asarray(acc), metrics={k: float(v) for k, v in m.items()},
                    steps=int(ts2.step), before=flat_np(params))
        state_dict = port_net(params).state_dict()
    finally:
        jax.config.update("jax_enable_x64", prev_x64)
        mp.undo()
    return state_dict, (gumbels, perms), want, convert.impala_params_to_numpy


def spawn_learners(tmp_path, world, state_dict, draws) -> list:
    sharding.spawn_ranks(children.learn_rank, world, str(tmp_path),
                         (str(tmp_path), state_dict, CFG, draws))
    out = []
    for r in range(world):
        with open(tmp_path / f"learn{world}-{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def flax_params(params: dict, to_numpy) -> dict:
    from procgen_torch.learn.nets import ImpalaCNN

    net = ImpalaCNN(dtype=torch.float32)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    return to_numpy(net)


def assert_matches_jax(got: dict, want: dict, to_numpy, where: str):
    assert got["steps"] == CFG["n_epochs"] * CFG["n_minibatches"] == want["steps"]
    np.testing.assert_array_equal(got["acts"], want["acts"], err_msg=where)
    np.testing.assert_array_equal(got["ep_acc"], want["ep_acc"], err_msg=where)
    assert got["metrics"]["episodes"] == want["metrics"]["episodes"] > 0
    assert got["metrics"]["episode_ends"] == want["metrics"]["episode_ends"]
    for k in METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{k} {where}")
    params = flax_params(got["params"], to_numpy)
    for k, b in want["params"].items():
        np.testing.assert_allclose(params[k], b, rtol=0, atol=1e-6, err_msg=f"{k} {where}")
        assert not np.array_equal(b, want["before"][k]), k


@pytest.mark.parametrize("world", [1, 4])
def test_data_parallel_train_iter_matches_jax_mesh(jax_run, tmp_path, world):
    state_dict, draws, want, to_numpy = jax_run
    ranks = spawn_learners(tmp_path, world, state_dict, draws)
    start = 0
    for r, got in enumerate(ranks):
        n = children.TOY_N // world
        sl = slice(start, start + n)
        start += n
        rank_want = dict(want, acts=want["acts"][:, sl], ep_acc=want["ep_acc"][sl])
        assert_matches_jax(got, rank_want, to_numpy, f"rank {r} of {world}")
        # the replicas bit for bit (train_iter also checks their checksum)
        for k, v in got["params"].items():
            np.testing.assert_array_equal(v.view(np.int32), ranks[0]["params"][k].view(np.int32))
        assert got["metrics"] == ranks[0]["metrics"]
    if world == 1:
        # the one-rank group against the learner with no group
        alone = children.train_iter_once(state_dict, CFG, draws)
        np.testing.assert_array_equal(alone[1].numpy(), ranks[0]["acts"])
        for k, v in alone[0].items():
            np.testing.assert_allclose(ranks[0]["params"][k], v.numpy(), rtol=0, atol=1e-6)
        for k in METRICS:
            np.testing.assert_allclose(ranks[0]["metrics"][k], alone[3][k], rtol=1e-4, atol=1e-5)
