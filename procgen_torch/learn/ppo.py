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

Data parallel over a sharded ``mesh`` (parallel/sharding.py), as the
reference package's program over an ``env`` mesh: each rank holds its rows
of the env batch and a replica of the parameters, and draws what the
unsharded program draws, with the same generator state on every rank (the
Gumbel noise of the global logits, the permutation of the global batch),
keeping its own rows.  A minibatch is the global one; each rank evaluates
the rows it holds, the advantage statistics and the loss terms are global
sums, and one all-reduce of the gradients per update leaves every replica
the same gradient, so the clipped Adam steps keep the replicas bitwise
equal (checked once per iteration).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from procgen_torch import resolve_device, telemetry
from procgen_torch.learn.nets import ImpalaCNN
from procgen_torch.parallel import sharding


# spans of the iteration's parts (procgen_torch.telemetry)
ROLLOUT_SPAN = "procgen_torch.rollout"
POLICY_SPAN = "procgen_torch.policy"
GAE_SPAN = "procgen_torch.gae"
UPDATE_SPAN = "procgen_torch.update"


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


def _place(mesh):
    """(rank, world) of a mesh; (0, 1) without one."""
    return (0, 1) if mesh is None else (mesh.rank, mesh.world)


def sample_actions(logits: torch.Tensor, generator: torch.Generator, mesh=None):
    """``jax.random.categorical``: argmax of logits plus Gumbel noise.
    Under a mesh the noise is drawn for the global batch and this rank
    keeps its rows.  Returns (action int32, its log-probability)."""
    rank, world = _place(mesh)
    n = logits.shape[0]
    noise = gumbel((n * world,) + tuple(logits.shape[1:]), generator, logits.device)
    action = torch.argmax(logits + noise[rank * n:(rank + 1) * n], dim=-1)
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


def loss_fn(net, ppo: PPOConfig, mb, stats=None):
    """The ppo2 loss of one minibatch ``(obs, action, old_logp, old_value,
    adv, ret)``: clipped surrogate, clipped value loss, entropy bonus.
    ``stats`` = (mean, std, size) of the advantages of a global minibatch
    of which ``mb`` holds this rank's rows: each term is then this rank's
    sum over ``size``, so the ranks' losses and gradients sum to the
    global ones.  Returns (total, (pg_loss, v_loss, entropy))."""
    obs, action, old_logp, old_value, adv, ret = mb
    logits, value = net(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, action.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    mean, std, size = (adv.mean(), adv.std(correction=0), None) if stats is None else stats

    def avg(x):
        return x.mean() if size is None else x.sum() / size

    adv_n = (adv - mean) / (std + 1e-8)  # numpy's (population) std
    pg1 = -adv_n * ratio
    pg2 = -adv_n * torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps)
    pg_loss = avg(torch.maximum(pg1, pg2))
    v_clip = old_value + torch.clamp(value - old_value, -ppo.clip_eps, ppo.clip_eps)
    v_loss = 0.5 * avg(torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2))
    entropy = -avg((torch.exp(logp_all) * logp_all).sum(-1))
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


def episode_sums(ep_acc, reward, done):
    """Fold a rollout into completed-episode returns.  ``done[t]`` marks a
    boundary before obs ``t``, so at a marked step the accumulator holds the
    finished episode's return.  Returns (ep_acc, sum of the finished
    returns, episodes)."""
    sums = torch.empty_like(reward[:, 0])
    for t in range(reward.shape[0]):
        d = done[t]
        sums[t] = torch.where(d, ep_acc, 0.0).sum()
        ep_acc = torch.where(d, 0.0, ep_acc) + reward[t]
    return ep_acc, sums.sum(), done.sum()


def mean_return(total, n):
    """The mean finished return: NaN, not 0, when no episode ended, so that
    a dashboard can tell "none completed" from "episodes returned 0"."""
    return torch.where(n > 0, total / n.clamp(min=1).to(total.dtype), float("nan"))


def episode_stats(ep_acc, reward, done):
    """``episode_sums`` with the mean return: (ep_acc, mean return,
    episodes)."""
    ep_acc, total, n = episode_sums(ep_acc, reward, done)
    return ep_acc, mean_return(total, n), n


def policy(net, obs, generator, mesh=None):
    """(action int32, logp, value) for a batch of observations."""
    logits, value = net(obs)
    action, logp = sample_actions(logits, generator, mesh)
    return action, logp, value


def rollout(net, fs, generator, ppo: PPOConfig, fast_step, render_fn, mesh=None):
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
    with telemetry.span(ROLLOUT_SPAN), torch.no_grad():
        for t in range(T):
            obs = render_fn(fs.state)
            traj.obs[t] = obs
            traj.done[t] = fs.state.done
            with telemetry.span(POLICY_SPAN):
                traj.action[t], traj.logp[t], traj.value[t] = policy(net, obs, generator, mesh)
            fs = fast_step(fs, traj.action[t])
            traj.reward[t] = fs.state.reward
        _, last_value = net(render_fn(fs.state))
    return fs, traj, last_value


def local_minibatches(perm, adv, n: int, mesh, n_minibatches: int, mb_size: int):
    """This rank's part of each global minibatch of one epoch: the indices
    into its flattened (T * n) rows of the minibatch entries whose env
    column ``idx % N`` it owns, in minibatch order, and each minibatch's
    advantage statistics (mean, population std, size) over the global
    minibatch, from two all-reduces: the sums, then the sums of squared
    deviations."""
    N, start = n * mesh.world, mesh.rank * n
    g = perm[:n_minibatches * mb_size].reshape(n_minibatches, mb_size)
    env = g % N
    mine = (env >= start) & (env < start + n)
    local = torch.where(mine, (g // N) * n + (env - start), 0)
    a = torch.where(mine, adv[local], 0.0)
    mean = sharding.all_reduce(a.sum(1), mesh) / mb_size
    dev2 = torch.where(mine, (a - mean[:, None]) ** 2, 0.0)
    std = torch.sqrt(sharding.all_reduce(dev2.sum(1), mesh) / mb_size)
    return ([local[i][mine[i]] for i in range(n_minibatches)],
            [(mean[i], std[i], mb_size) for i in range(n_minibatches)])


def _reduce_grads(params, terms, mesh):
    """Sum the gradients and the loss terms over the ranks in one flat
    all-reduce; returns the summed terms."""
    bucket = sharding.all_reduce(torch.cat([p.grad.reshape(-1) for p in params] + [terms]), mesh)
    off = 0
    for p in params:
        p.grad.copy_(bucket[off:off + p.numel()].view_as(p.grad))
        off += p.numel()
    return bucket[off:]


def update(ts: TrainState, ppo: PPOConfig, batch, generator, mesh=None):
    """``n_epochs`` passes over the flattened batch, each in
    ``n_minibatches`` contiguous slices of one permutation (of the global
    batch under a mesh).  Returns the means of (loss, pg_loss, v_loss,
    entropy) over all updates, on the device."""
    rank, world = _place(mesh)
    T, n = batch[1].shape
    total = T * n * world
    flat = [x.reshape((T * n,) + x.shape[2:]) for x in batch]
    mb_size = total // ppo.n_minibatches
    params = list(ts.net.parameters())
    metrics = []
    for _ in range(ppo.n_epochs):
        perm = permutation(total, generator, flat[0].device)
        if mesh is None:
            mbs = [perm[i * mb_size:(i + 1) * mb_size] for i in range(ppo.n_minibatches)]
            stats = [None] * ppo.n_minibatches
        else:
            mbs, stats = local_minibatches(perm, flat[4], n, mesh, ppo.n_minibatches, mb_size)
        for idx, st in zip(mbs, stats):
            loss, aux = loss_fn(ts.net, ppo, [x[idx] for x in flat], st)
            ts.opt.zero_grad(set_to_none=True)
            loss.backward()
            terms = torch.stack([loss.detach(), *(a.detach() for a in aux)])
            if mesh is not None:
                terms = _reduce_grads(params, terms, mesh)
            clip_by_global_norm([p.grad for p in params], ppo.max_grad_norm)
            ts.opt.step()
            ts.step += 1
            metrics.append(terms)
    return torch.stack(metrics).mean(0)


def param_checksum(net) -> torch.Tensor:
    """Two int64 sums over the parameters' bytes (plain and position
    weighted): equal on replicas whose parameters are bitwise equal."""
    b = torch.cat([p.detach().reshape(-1).view(torch.uint8) for p in net.parameters()])
    b = b.to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return torch.stack([b.sum(), (b * w).sum()])


def check_replicas(net, mesh) -> None:
    """Raise on every rank unless every rank's parameters equal rank 0's
    bit for bit (rank 0's checksum broadcast, the mismatches summed)."""
    mine = param_checksum(net)
    root = sharding.broadcast(mine.clone(), mesh, 0)
    bad = sharding.all_reduce((mine != root).any().to(torch.int64).reshape(1), mesh)
    telemetry.count("host_reads.ppo.replica_check")
    if int(bad):
        raise RuntimeError(f"parameters differ from rank 0's on {int(bad)} rank(s)")


def make_train_fns(gd, cfg, pack, ppo: PPOConfig, fast_step, render_fn, device="cuda",
                   mesh=None):
    """Returns (init_train_state(generator), train_iter(ts, fs, generator,
    ep_acc), policy).

    ``fast_step(fs, actions) -> fs`` and ``render_fn(state) -> obs`` come
    from parallel.fast / render.fast2; the learner treats them as black
    boxes, so the same code drives any game.  ``gd``, ``cfg`` and ``pack``
    are not read (the JAX package's signature).  With a sharded ``mesh``
    the env state and ``ep_acc`` are this rank's rows and the update is
    data parallel (module docstring); the metrics are the global ones on
    every rank."""
    device = resolve_device(device)
    if mesh is not None and not mesh.sharded:
        mesh = None

    def init_train_state(generator: torch.Generator) -> TrainState:
        """Parameters drawn from ``generator`` on its device, then moved to
        ``device`` (under a mesh, rank 0's broadcast); Adam as optax's (eps
        outside the root, eps_root 0)."""
        net = ImpalaCNN(device=generator.device, generator=generator).to(device)
        if mesh is not None:
            params = list(net.parameters())
            flat = sharding.broadcast(torch.cat([p.detach().reshape(-1) for p in params]), mesh)
            with torch.no_grad():
                for p, q in zip(params, torch.split(flat, [p.numel() for p in params])):
                    p.copy_(q.view_as(p))
        opt = torch.optim.Adam(net.parameters(), lr=ppo.lr, betas=(0.9, 0.999), eps=1e-5)
        return TrainState(net, opt, 0)

    def train_iter(ts: TrainState, fs, generator: torch.Generator, ep_acc):
        """One PPO iteration: an ``n_steps`` rollout, then the minibatched
        updates.  ``ep_acc`` is the (num_envs,) running episode return,
        carried across iterations so that an episode spanning a rollout
        boundary is scored once, in full.  Returns (ts, fs, ep_acc, metrics
        dict of 0-d device tensors)."""
        fs, traj, last_value = rollout(ts.net, fs, generator, ppo, fast_step, render_fn, mesh)
        with telemetry.span(GAE_SPAN):
            adv, ret = gae(ppo, traj.reward, traj.value, traj.done, last_value, fs.state.done)
        batch = (traj.obs, traj.action, traj.logp, traj.value, adv, ret)
        with telemetry.span(UPDATE_SPAN):
            loss, pg, vf, ent = update(ts, ppo, batch, generator, mesh)
        metrics = {"loss": loss, "pg_loss": pg, "v_loss": vf, "entropy": ent}
        if mesh is None:
            ep_acc, mean_ep_ret, n_eps = episode_stats(ep_acc, traj.reward, traj.done)
            metrics.update(reward_per_step=traj.reward.mean(), episode_ends=traj.done.sum(),
                           mean_ep_return=mean_ep_ret, episodes=n_eps)
            return ts, fs, ep_acc, metrics
        ep_acc, ep_total, n_eps = episode_sums(ep_acc, traj.reward, traj.done)
        sums = torch.stack([x.to(torch.float64) for x in (
            traj.reward.sum(), traj.done.sum(), ep_total, n_eps)])
        sums = sharding.all_reduce(sums, mesh)
        metrics.update(reward_per_step=(sums[0] / (traj.reward.numel() * mesh.world)).float(),
                       episode_ends=sums[1].long(), mean_ep_return=mean_return(sums[2], sums[3]),
                       episodes=sums[3].long())
        check_replicas(ts.net, mesh)
        return ts, fs, ep_acc, metrics

    return init_train_state, train_iter, policy
