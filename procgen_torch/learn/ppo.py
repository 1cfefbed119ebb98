"""PPO over the port's fast env path: rollouts, GAE, clipped updates
(counterpart of ``procgen_tpu/learn/ppo.py``).

Hyperparameters default to the Procgen paper / train-procgen settings
(ppo2: nsteps 256, nminibatches 8, 3 epochs, gamma .999, lam .95, clip .2,
lr 5e-4, ent .01, vf .5).  The rollout is a host loop of ``n_steps`` env
steps into buffers on the device; the update runs ``n_epochs`` passes of
``n_minibatches`` contiguous slices of one permutation each.  Losses stay on
the device: the caller reads the metrics once per iteration.

Random draws go through ``gumbel`` (action sampling, Gumbel-max as
``jax.random.categorical``) and ``permutation`` (minibatch order), both on
the caller's ``torch.Generator``; a test can replace the two to replay
another package's draws.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from procgen_torch import resolve_device
from procgen_torch.learn.nets import ImpalaCNN


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_steps: int = 256
    n_minibatches: int = 8
    n_epochs: int = 3
    gamma: float = 0.999
    lam: float = 0.95
    clip_eps: float = 0.2
    lr: float = 5e-4
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5


@dataclasses.dataclass
class TrainState:
    net: ImpalaCNN  # the parameters, float32
    opt: torch.optim.Adam
    step: int  # optimizer steps taken


@dataclasses.dataclass
class Transition:
    obs: torch.Tensor  # (T, N, 64, 64, 3) uint8
    action: torch.Tensor  # (T, N) int32
    logp: torch.Tensor  # (T, N)
    value: torch.Tensor  # (T, N)
    reward: torch.Tensor  # (T, N)
    done: torch.Tensor  # (T, N) bool: episode boundary BEFORE this obs


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(U))`` with U uniform on [tiny, 1)
    (``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def permutation(n: int, generator: torch.Generator, device) -> torch.Tensor:
    return torch.randperm(n, generator=generator, device=device)


def sample_actions(logits: torch.Tensor, generator: torch.Generator):
    """``jax.random.categorical``: argmax of logits plus Gumbel noise.
    Returns (action int32, its log-probability)."""
    action = torch.argmax(logits + gumbel(logits.shape, generator, logits.device), dim=-1)
    logp = F.log_softmax(logits, dim=-1).gather(1, action[:, None])[:, 0]
    return action.to(torch.int32), logp


def gae(ppo: PPOConfig, reward, value, done, last_value, last_done):
    """Generalised advantage estimates over (T, N) tensors.  ``done[t]``
    marks a boundary before obs ``t``, so step ``t`` bootstraps from
    ``value[t + 1]`` unless ``done[t + 1]`` (``last_done`` after the last
    step).  Returns (advantages, returns)."""
    value_tp1 = torch.cat([value[1:], last_value[None]])
    nonterm = 1.0 - torch.cat([done[1:], last_done[None]]).to(torch.float32)
    adv = torch.empty_like(reward)
    g = torch.zeros_like(last_value)
    for t in reversed(range(reward.shape[0])):
        delta = reward[t] + ppo.gamma * value_tp1[t] * nonterm[t] - value[t]
        g = delta + ppo.gamma * ppo.lam * nonterm[t] * g
        adv[t] = g
    return adv, adv + value


def loss_fn(net, ppo: PPOConfig, mb):
    """The ppo2 loss of one minibatch ``(obs, action, old_logp, old_value,
    adv, ret)``: clipped surrogate, clipped value loss, entropy bonus.
    Returns (total, (pg_loss, v_loss, entropy))."""
    obs, action, old_logp, old_value, adv, ret = mb
    logits, value = net(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, action.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)  # numpy's std
    pg1 = -adv_n * ratio
    pg2 = -adv_n * torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps)
    pg_loss = torch.maximum(pg1, pg2).mean()
    v_clip = old_value + torch.clamp(value - old_value, -ppo.clip_eps, ppo.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg_loss + ppo.vf_coef * v_loss - ppo.ent_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def clip_by_global_norm(grads, max_norm: float) -> None:
    """``optax.clip_by_global_norm``, in place and without a host read:
    gradients are left alone when their global norm is below ``max_norm``,
    else each becomes ``g / norm * max_norm`` (torch's ``clip_grad_norm_``
    divides by ``norm + 1e-6`` instead)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def episode_stats(ep_acc, reward, done):
    """Fold a rollout into completed-episode returns.  ``done[t]`` marks a
    boundary before obs ``t``, so at a marked step the accumulator holds the
    finished episode's return.  Returns (ep_acc, mean return, episodes): the
    mean is NaN, not 0, when no episode ended, so that a dashboard can tell
    "none completed" from "episodes returned 0"."""
    sums = torch.empty_like(reward[:, 0])
    for t in range(reward.shape[0]):
        d = done[t]
        sums[t] = torch.where(d, ep_acc, 0.0).sum()
        ep_acc = torch.where(d, 0.0, ep_acc) + reward[t]
    n = done.sum()
    mean = torch.where(n > 0, sums.sum() / n.clamp(min=1).to(sums.dtype), float("nan"))
    return ep_acc, mean, n


def policy(net, obs, generator):
    """(action int32, logp, value) for a batch of observations."""
    logits, value = net(obs)
    action, logp = sample_actions(logits, generator)
    return action, logp, value


def rollout(net, fs, generator, ppo: PPOConfig, fast_step, render_fn):
    """``n_steps`` env steps under the current policy.  Returns (fs,
    Transition, bootstrap value of the state after the last step)."""
    done0 = fs.state.done
    n, dev = done0.shape[0], done0.device
    T = ppo.n_steps
    traj = Transition(
        obs=torch.empty((T, n, 64, 64, 3), dtype=torch.uint8, device=dev),
        action=torch.empty((T, n), dtype=torch.int32, device=dev),
        logp=torch.empty((T, n), device=dev),
        value=torch.empty((T, n), device=dev),
        reward=torch.empty((T, n), device=dev),
        done=torch.empty((T, n), dtype=torch.bool, device=dev),
    )
    with torch.no_grad():
        for t in range(T):
            obs = render_fn(fs.state)
            traj.obs[t] = obs
            traj.done[t] = fs.state.done
            traj.action[t], traj.logp[t], traj.value[t] = policy(net, obs, generator)
            fs = fast_step(fs, traj.action[t])
            traj.reward[t] = fs.state.reward
        _, last_value = net(render_fn(fs.state))
    return fs, traj, last_value


def update(ts: TrainState, ppo: PPOConfig, batch, generator):
    """``n_epochs`` passes over the flattened batch, each in
    ``n_minibatches`` contiguous slices of one permutation.  Returns the
    means of (loss, pg_loss, v_loss, entropy) over all updates, on the
    device."""
    total = batch[1].numel()
    flat = [x.reshape((total,) + x.shape[2:]) for x in batch]
    mb_size = total // ppo.n_minibatches
    params = list(ts.net.parameters())
    metrics = []
    for _ in range(ppo.n_epochs):
        perm = permutation(total, generator, flat[0].device)
        for i in range(ppo.n_minibatches):
            idx = perm[i * mb_size:(i + 1) * mb_size]
            loss, aux = loss_fn(ts.net, ppo, [x[idx] for x in flat])
            ts.opt.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm([p.grad for p in params], ppo.max_grad_norm)
            ts.opt.step()
            ts.step += 1
            metrics.append(torch.stack([loss.detach(), *(a.detach() for a in aux)]))
    return torch.stack(metrics).mean(0)


def make_train_fns(gd, cfg, pack, ppo: PPOConfig, fast_step, render_fn, device="cuda"):
    """Returns (init_train_state(generator), train_iter(ts, fs, generator,
    ep_acc), policy).

    ``fast_step(fs, actions) -> fs`` and ``render_fn(state) -> obs`` come
    from parallel.fast / render.fast2; the learner treats them as black
    boxes, so the same code drives any game.  ``gd``, ``cfg`` and ``pack``
    are not read (the JAX package's signature)."""
    device = resolve_device(device)

    def init_train_state(generator: torch.Generator) -> TrainState:
        """Parameters drawn from ``generator`` on its device, then moved to
        ``device``; Adam as optax's (eps outside the root, eps_root 0)."""
        net = ImpalaCNN(device=generator.device, generator=generator).to(device)
        opt = torch.optim.Adam(net.parameters(), lr=ppo.lr, betas=(0.9, 0.999), eps=1e-5)
        return TrainState(net, opt, 0)

    def train_iter(ts: TrainState, fs, generator: torch.Generator, ep_acc):
        """One PPO iteration: an ``n_steps`` rollout, then the minibatched
        updates.  ``ep_acc`` is the (num_envs,) running episode return,
        carried across iterations so that an episode spanning a rollout
        boundary is scored once, in full.  Returns (ts, fs, ep_acc, metrics
        dict of 0-d device tensors)."""
        fs, traj, last_value = rollout(ts.net, fs, generator, ppo, fast_step, render_fn)
        adv, ret = gae(ppo, traj.reward, traj.value, traj.done, last_value, fs.state.done)
        batch = (traj.obs, traj.action, traj.logp, traj.value, adv, ret)
        loss, pg, vf, ent = update(ts, ppo, batch, generator)
        ep_acc, mean_ep_ret, n_eps = episode_stats(ep_acc, traj.reward, traj.done)
        metrics = {
            "loss": loss, "pg_loss": pg, "v_loss": vf, "entropy": ent,
            "reward_per_step": traj.reward.mean(),
            "episode_ends": traj.done.sum(),
            "mean_ep_return": mean_ep_ret,
            "episodes": n_eps,
        }
        return ts, fs, ep_acc, metrics

    return init_train_state, train_iter, policy
