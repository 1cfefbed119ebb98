"""procgen_torch.learn against procgen_tpu.learn on the CPU.

The same numpy-seeded parameters and inputs go through the flax net and the
port's ``ImpalaCNN`` (float32 and bf16), the JAX package's ``loss_fn``,
``gae`` and ``episode_stats`` (reached through the closures of its
``train_iter``) and the port's module-level functions, and one whole
``train_iter`` of each package over a small deterministic toy env written
in both frameworks.  The port's draws (``ppo.gumbel``, ``ppo.permutation``)
replay JAX's key chain there, so actions are compared bit for bit.  Every
tolerance is stated where it is used.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from functools import partial
from typing import NamedTuple

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import procgen_tpu.learn.ppo as jppo
from procgen_tpu.learn.nets import ImpalaCNN as JaxImpala
from procgen_torch import convert
from procgen_torch.learn import nets, ppo
from procgen_torch.learn.nets import ImpalaCNN
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)

F32_RTOL = 1e-5
# bf16 keeps 8 significant bits (eps 2**-7): the two packages round the
# same ops in different orders, so their bf16 logits may differ by a few
# eps of the largest logit (measured: about 0.5 eps)
BF16_EPS = 2.0 ** -7


def random_flax_params(seed: int, dtype=jnp.float32):
    """The flax net's parameter tree, every leaf drawn from numpy: kernels
    normal with variance 1 / fan_in, biases normal with std 0.1 (non-zero,
    so that the bias path is compared too)."""
    net = JaxImpala(dtype=dtype)
    tmpl = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.uint8))
    rs = np.random.RandomState(seed)

    def draw(x):
        x = np.asarray(x)
        if x.ndim == 1:
            return (rs.randn(*x.shape) * 0.1).astype(np.float32)
        return (rs.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)

    return net, jax.tree_util.tree_map(lambda x: jnp.asarray(draw(x)), tmpl)


def port_net(params, dtype=torch.float32) -> ImpalaCNN:
    net = ImpalaCNN(dtype=dtype)
    flat = convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(params)[0])
    net.load_state_dict(convert.impala_params_from_numpy(flat))
    return net


def flat_np(tree) -> dict:
    return convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(tree)[0])


def grads_np(net: ImpalaCNN) -> dict:
    """The port's gradients in flax's paths and layouts."""
    g = copy.deepcopy(net)
    for p, q in zip(g.parameters(), net.parameters()):
        p.data = q.grad
    return convert.impala_params_to_numpy(g)


def jax_closures(fn, found=None) -> dict:
    """Every function reachable through ``fn``'s closure cells, by name:
    the JAX package's ``make_train_fns`` keeps ``rollout``, ``gae``,
    ``update``, ``loss_fn`` and ``episode_stats`` there."""
    found = {} if found is None else found
    for cell in fn.__closure__ or ():
        v = cell.cell_contents
        if inspect.isfunction(v) and v.__name__ not in found:
            found[v.__name__] = v
            jax_closures(v, found)
    return found


@pytest.fixture
def jax_f32_net(monkeypatch):
    """The JAX package's learner with a float32 net (its module global
    ``ImpalaCNN`` is read when ``make_train_fns`` runs)."""
    monkeypatch.setattr(jppo, "ImpalaCNN", partial(JaxImpala, dtype=jnp.float32))


def jax_fns(cfg: jppo.PPOConfig, fast_step=None, render_fn=None):
    init, train_iter, _ = jppo.make_train_fns(None, None, None, cfg, fast_step, render_fn)
    return init, train_iter, jax_closures(train_iter)


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------


def test_param_count_and_round_trip(jax_x64_off):
    _, params = random_flax_params(0)
    net = port_net(params)
    assert sum(p.numel() for p in net.parameters()) == 626_256
    assert len(list(net.parameters())) == 36
    back = convert.impala_params_to_numpy(net)
    flat = flat_np(params)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_net_matches_flax(precision, jax_x64_off):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[precision]
    net, params = random_flax_params(1, jd)
    obs = np.random.RandomState(2).randint(0, 256, size=(6, 64, 64, 3)).astype(np.uint8)
    lj, vj = (np.asarray(a) for a in net.apply(params, obs))
    with torch.no_grad():
        lt, vt = port_net(params, td)(torch.from_numpy(obs))
    assert lt.dtype == vt.dtype == torch.float32
    assert lt.shape == (6, 15) and vt.shape == (6,)
    if precision == "float32":
        # rtol 1e-5, plus an atol of 1e-5 of the largest value for entries
        # near zero (measured: at most 2.2e-6 of it)
        for a, b in ((lt.numpy(), lj), (vt.numpy(), vj)):
            np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_RTOL * np.abs(b).max())
    else:
        # within 2 bf16 eps of the largest logit / value (measured: 0.5 eps
        # on the logits, 0.85 eps on the values)
        for a, b in ((lt.numpy(), lj), (vt.numpy(), vj)):
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * BF16_EPS * np.abs(b).max())


def test_max_pool_pads_after_with_neg_inf(jax_x64_off):
    """XLA's SAME pooling pads (0, 1) on an even side; every value is
    negative here, so a zero or a (1, 1) pad would show."""
    x = -np.random.RandomState(3).rand(2, 16, 16, 5).astype(np.float32) - 1.0
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = nets.max_pool_same(t).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    shifted = F.max_pool2d(t, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(shifted, want)


def test_init_statistics_match_flax(jax_x64_off):
    """Kernels: std of the truncated normal within 4 / sqrt(2 n) of
    1 / sqrt(fan_in), on both sides, nothing beyond 2 truncation stds;
    biases zero."""
    jparams = flat_np(JaxImpala().init(jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, 3), jnp.uint8)))
    port = convert.impala_params_to_numpy(ImpalaCNN(generator=torch.Generator().manual_seed(4)))
    assert port.keys() == jparams.keys()
    for k, a in port.items():
        b = jparams[k]
        assert a.shape == b.shape
        if k.endswith("bias"):
            assert not a.any() and not b.any(), k
            continue
        fan_in = int(np.prod(a.shape[:-1]))
        target = fan_in ** -0.5
        tol = 4 / np.sqrt(2 * a.size)
        for w in (a, b):
            assert abs(w.std() / target - 1) < tol, (k, w.std(), target)
            assert abs(w.mean()) < 4 * target / np.sqrt(a.size), k
            assert np.abs(w).max() <= 2 * target / nets._TRUNC_STD * (1 + 1e-6), k


# ---------------------------------------------------------------------------
# loss, GAE, episode statistics
# ---------------------------------------------------------------------------


def minibatch(seed: int, n: int):
    rs = np.random.RandomState(seed)
    return (
        rs.randint(0, 256, size=(n, 64, 64, 3)).astype(np.uint8),
        rs.randint(0, 15, size=n).astype(np.int32),
        (np.log(rs.rand(n)) - 1.0).astype(np.float32),
        rs.randn(n).astype(np.float32),
        rs.randn(n).astype(np.float32),
        rs.randn(n).astype(np.float32),
    )


def test_loss_and_grad_match_jax(jax_f32_net, jax_x64_off):
    cfg = jppo.PPOConfig()
    _, _, fns = jax_fns(cfg)
    _, params = random_flax_params(5)
    mb = minibatch(6, 12)
    (lj, auxj), gj = jax.value_and_grad(fns["loss_fn"], has_aux=True)(
        params, tuple(jnp.asarray(x) for x in mb))
    net = port_net(params)
    lt, auxt = ppo.loss_fn(net, ppo.PPOConfig(), [torch.from_numpy(x) for x in mb])
    lt.backward()
    # losses in float32 within rtol 1e-5 (plus 1e-6 absolute: pg_loss
    # sums terms of both signs)
    for a, b in zip((lt, *auxt), (lj, *auxj)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=F32_RTOL, atol=1e-6)
    # gradients: within 1e-4 of each tensor's largest entry (the convolution
    # routes sum in different orders; measured 3e-6)
    gt = grads_np(net)
    for k, b in flat_np(gj).items():
        np.testing.assert_allclose(gt[k], b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=k)


def jax_transition(reward, value, done, obs=None):
    T, N = reward.shape
    return jppo.Transition(
        obs=jnp.zeros((T, N, 1), jnp.uint8) if obs is None else obs,
        action=jnp.zeros((T, N), jnp.int32), logp=jnp.zeros((T, N)),
        value=jnp.asarray(value), reward=jnp.asarray(reward), done=jnp.asarray(done))


@pytest.mark.parametrize("case", ["random_dones", "no_dones"])
def test_gae_and_episode_stats_match_jax(case, jax_x64_off):
    T, N = 16, 5
    rs = np.random.RandomState(7)
    reward = (rs.rand(T, N) * (rs.rand(T, N) < 0.3) * 10).astype(np.float32)
    value = rs.randn(T, N).astype(np.float32)
    done = rs.rand(T, N) < (0.2 if case == "random_dones" else 0.0)
    last_value = rs.randn(N).astype(np.float32)
    last_done = rs.rand(N) < (0.5 if case == "random_dones" else 0.0)
    ep_acc = (rs.rand(N) * 3).astype(np.float32)
    cfg = jppo.PPOConfig()
    _, _, fns = jax_fns(cfg)
    traj = jax_transition(reward, value, done)
    adv_j, ret_j = fns["gae"](traj, jnp.asarray(last_value), jnp.asarray(last_done))
    acc_j, mean_j, n_j = fns["episode_stats"](jnp.asarray(ep_acc), traj)

    t = torch.from_numpy
    adv_t, ret_t = ppo.gae(ppo.PPOConfig(), t(reward), t(value), t(done), t(last_value),
                           t(last_done))
    acc_t, mean_t, n_t = ppo.episode_stats(t(ep_acc), t(reward), t(done))
    # float32 recursions in the same order: within rtol 1e-5 (atol 1e-5
    # for entries near zero)
    np.testing.assert_allclose(adv_t.numpy(), adv_j, rtol=F32_RTOL, atol=1e-5)
    np.testing.assert_allclose(ret_t.numpy(), ret_j, rtol=F32_RTOL, atol=1e-5)
    np.testing.assert_array_equal(acc_t.numpy(), acc_j)
    assert int(n_t) == int(n_j)
    if case == "no_dones":
        assert int(n_t) == 0 and np.isnan(float(mean_t)) and np.isnan(float(mean_j))
    else:
        assert int(n_t) > 0
        np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=F32_RTOL)


def test_clip_by_global_norm_matches_optax(jax_x64_off):
    import optax

    rs = np.random.RandomState(8)
    for scale in (1e-3, 10.0):  # below and above the limit
        gs = [(rs.randn(*s) * scale).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
        want, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        ppo.clip_by_global_norm(got, 0.5)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_RTOL, atol=0)


# ---------------------------------------------------------------------------
# one whole train_iter over a toy env in both frameworks
# ---------------------------------------------------------------------------

TOY_N, TOY_T = 4, 8
TOY_EP_LEN = (3, 5, 7, 100)  # per-env episode lengths: three end in the rollout


class JaxToyState(NamedTuple):
    pos: jax.Array  # (N,) int32
    t: jax.Array  # (N,) int32
    k: jax.Array  # () int32: steps taken
    acts: jax.Array  # (T, N) int32: every action taken
    done: jax.Array
    reward: jax.Array


class JaxToyFS(NamedTuple):
    state: JaxToyState


def jax_toy_step(fs, action):
    s = fs.state
    t = s.t + 1
    reward = (action == s.pos % 15).astype(jnp.float32) + 0.25 * (action % 3).astype(jnp.float32)
    done = t >= jnp.asarray(TOY_EP_LEN, jnp.int32)
    pos = jnp.where(done, (s.pos * 7 + action + 1) % 251, s.pos + action)
    return JaxToyFS(JaxToyState(pos, jnp.where(done, 0, t), s.k + 1,
                                s.acts.at[s.k].set(action), done, reward))


def jax_toy_render(s):
    yy, xx, cc = jnp.meshgrid(jnp.arange(64), jnp.arange(64), jnp.arange(3), indexing="ij")
    v = s.pos[:, None, None, None] * 13 + s.t[:, None, None, None] * 29 + xx * 3 + yy * 5 + cc * 71
    return (v % 256).astype(jnp.uint8)


@dataclasses.dataclass
class ToyState:
    pos: torch.Tensor
    t: torch.Tensor
    k: int
    acts: torch.Tensor
    done: torch.Tensor
    reward: torch.Tensor


@dataclasses.dataclass
class ToyFS:
    state: ToyState


def toy_step(fs, action):
    s = fs.state
    t = s.t + 1
    reward = (action == s.pos % 15).float() + 0.25 * (action % 3).float()
    done = t >= torch.tensor(TOY_EP_LEN, dtype=torch.int32)
    pos = torch.where(done, (s.pos * 7 + action + 1) % 251, s.pos + action)
    acts = s.acts.clone()
    acts[s.k] = action
    return ToyFS(ToyState(pos, torch.where(done, 0, t), s.k + 1, acts, done, reward))


def toy_render(s):
    yy, xx, cc = torch.meshgrid(torch.arange(64), torch.arange(64), torch.arange(3), indexing="ij")
    v = s.pos[:, None, None, None] * 13 + s.t[:, None, None, None] * 29 + xx * 3 + yy * 5 + cc * 71
    return (v % 256).to(torch.uint8)


def toy_start():
    pos = np.array([3, 40, 77, 150], np.int32)
    t = np.array([0, 2, 0, 90], np.int32)
    done = np.array([True, False, False, False])
    z = np.zeros(TOY_N, np.float32)
    acts = np.zeros((TOY_T, TOY_N), np.int32)
    jfs = JaxToyFS(JaxToyState(*(jnp.asarray(a) for a in (pos, t)), jnp.int32(0),
                               jnp.asarray(acts), jnp.asarray(done), jnp.asarray(z)))
    tfs = ToyFS(ToyState(*(torch.from_numpy(a) for a in (pos, t)), 0,
                         torch.from_numpy(acts), torch.from_numpy(done), torch.from_numpy(z)))
    return jfs, tfs


class JaxDraws:
    """The port's ``gumbel`` and ``permutation`` replaying the JAX
    package's key chain through one train_iter: per rollout step ``rng, sub
    = split(rng)`` and ``gumbel(sub, logits.shape)`` (ppo.py:80, as
    ``jax.random.categorical``); then ``rng, sub = split(rng)`` (ppo.py:209)
    and per epoch ``sub, p = split(sub)``, ``permutation(p, T * N)``
    (ppo.py:147-148)."""

    def __init__(self, key):
        self.rng, self.upd = key, None

    def gumbel(self, shape, generator, device):
        self.rng, sub = jax.random.split(self.rng)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape), jnp.float32)))

    def permutation(self, n, generator, device):
        if self.upd is None:
            self.rng, self.upd = jax.random.split(self.rng)
        self.upd, sub = jax.random.split(self.upd)
        return torch.from_numpy(np.asarray(jax.random.permutation(sub, n)).astype(np.int64))


def test_train_iter_matches_jax(jax_f32_net, jax_x64_off, monkeypatch):
    cfg = dict(n_steps=TOY_T, n_minibatches=2, n_epochs=2)
    init_j, iter_j, _ = jax_fns(jppo.PPOConfig(**cfg), jax_toy_step, jax_toy_render)
    ts_j = init_j(jax.random.PRNGKey(9))
    _, params = random_flax_params(10)  # numpy-drawn, so biases are non-zero
    ts_j = ts_j._replace(params=params)
    # the optimizer state was built from the init params' shapes: unchanged
    jfs, tfs = toy_start()
    ep_acc = np.array([0.5, 1.0, 0.0, 2.0], np.float32)
    key = jax.random.PRNGKey(11)
    ts_j2, jfs2, acc_j, m_j = jax.jit(iter_j)(ts_j, jfs, key, jnp.asarray(ep_acc))

    draws = JaxDraws(key)
    monkeypatch.setattr(ppo, "gumbel", draws.gumbel)
    monkeypatch.setattr(ppo, "permutation", draws.permutation)
    monkeypatch.setattr(ppo, "ImpalaCNN", partial(ImpalaCNN, dtype=torch.float32))
    init_t, iter_t, _ = ppo.make_train_fns(None, None, None, ppo.PPOConfig(**cfg), toy_step,
                                           toy_render, "cpu")
    ts_t = init_t(torch.Generator().manual_seed(0))
    ts_t.net.load_state_dict(port_net(params).state_dict())
    ts_t, tfs2, acc_t, m_t = iter_t(ts_t, tfs, None, torch.from_numpy(ep_acc))
    assert ts_t.step == cfg["n_epochs"] * cfg["n_minibatches"] == int(ts_j2.step)

    # the actions (and so the toy env's path) bit for bit
    np.testing.assert_array_equal(tfs2.state.acts.numpy(), np.asarray(jfs2.state.acts))
    np.testing.assert_array_equal(tfs2.state.pos.numpy(), np.asarray(jfs2.state.pos))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert int(m_t["episodes"]) == int(m_j["episodes"]) > 0
    assert int(m_t["episode_ends"]) == int(m_j["episode_ends"])
    # metrics: float32 means over 4 updates, within rtol 1e-4 (atol 1e-5
    # for pg_loss, a mean of terms of both signs; measured: at most 7.6e-6
    # relative, on v_loss and loss)
    for k in ("loss", "pg_loss", "v_loss", "entropy", "reward_per_step", "mean_ep_return"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    # every parameter after 4 Adam steps: within 1e-6 absolute (each step
    # moves a parameter by up to lr = 5e-4; measured at most 1.5e-7)
    after_t = convert.impala_params_to_numpy(ts_t.net)
    after_j = flat_np(ts_j2.params)
    before = flat_np(params)
    for k, b in after_j.items():
        np.testing.assert_allclose(after_t[k], b, rtol=0, atol=1e-6, err_msg=k)
        assert not np.array_equal(b, before[k]), k
