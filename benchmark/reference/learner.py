"""The plain reference of the training cell's learner, and the comparison
that decides its ``correct``.

PPO as the Procgen paper trains it (ppo2 with the IMPALA CNN, Espeholt et
al. 2018), written here in plain PyTorch over a list of parameters:

- the net: three stacks of a 3x3 convolution, a 3x3 max-pool of stride 2
  (XLA's SAME padding: one pad row and column after the input) and two
  residual blocks, then a 256-wide dense layer and the policy and value
  heads; the convolutions and the dense layer compute in bfloat16 as
  flax's ``dtype=`` does (input, weight and bias cast, the product rounded
  before the bias is added), the heads in float32;
- actions by Gumbel-max over the logits (``-log(-log(U))``, U uniform on
  [tiny, 1)), drawn from the run's generator;
- GAE (gamma, lambda), 3 epochs of 8 contiguous minibatches of one
  permutation each, the clipped surrogate and value losses and the entropy
  bonus, the gradient clipped by its global norm (optax's rule), Adam.

It starts from the initial parameters the benchmark made and the generator
state before the first iteration, and reads the rollout's observations,
actions, rewards and episode boundaries: the program's, which the env
check judges on its sampled envs.  It follows every optimizer step of the
first iteration.

Numbers compared (``check``):

- ``logit_gap``, ``value_gap``: the widest gap between the program's and
  the reference's policy logits and values over every rollout forward;
- ``action_gap``: the widest gap by which the program's action's logit plus
  its Gumbel noise (replayed from the generator) lies below the
  reference's best;
- ``loss_gap``: per optimizer step, the loss of the program's forward on
  the step's minibatch against the reference's, over the reference's (1
  where the program's forward saw another number of rows);
- ``grad_gap``: per leaf, the norm of the program's first gradient as Adam
  got it (its first moment after one step over 1 - beta1) against the
  reference's clipped gradient, over the larger of the reference's norm of
  that leaf and of the median leaf; the worst leaf;
- ``update_gap``: the same for each leaf's change over the iteration,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (their change under Adam is round-off).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-5
NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm
DEPTHS, HIDDEN, N_ACTIONS = (16, 32, 32), 256, 15
BF16 = torch.bfloat16


def param_shapes() -> list:
    """The parameters in the net's order: per stack its convolution and
    the two convolutions of each residual block (weight, bias), then the
    dense layer and the two heads."""
    shapes, c = [], 3
    for d in DEPTHS:
        for cin in (c, d, d, d, d):
            shapes += [(d, cin, 3, 3), (d,)]
        c = d
    side = 64 // 2 ** len(DEPTHS)
    shapes += [(HIDDEN, side * side * c), (HIDDEN,), (N_ACTIONS, HIDDEN), (N_ACTIONS,),
               (1, HIDDEN), (1,)]
    return shapes


def _conv(x, w, b):
    return F.conv2d(x.to(BF16), w.to(BF16), padding=1) + b.to(BF16)[:, None, None]


def _dense(x, w, b):
    return F.linear(x.to(BF16), w.to(BF16)) + b.to(BF16)


_layers = {"conv": _conv, "dense": _dense}  # the control swaps these


def forward(params, obs):
    """obs (N, 64, 64, 3) uint8 -> (logits (N, 15), value (N,)) float32."""
    conv, dense = _layers["conv"], _layers["dense"]
    x = obs.to(BF16) / torch.full((), 255.0, dtype=BF16, device=obs.device)
    x = x.permute(0, 3, 1, 2)
    it = iter(params)
    for _ in DEPTHS:
        x = conv(x, next(it), next(it))
        x = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        for _ in range(2):
            y = conv(F.relu(x), next(it), next(it))
            y = conv(F.relu(y), next(it), next(it))
            x = x + y
    x = F.relu(x).permute(0, 2, 3, 1).flatten(1)
    x = F.relu(dense(x, next(it), next(it))).float()
    wl, bl, wv, bv = (next(it) for _ in range(4))
    return F.linear(x, wl, bl), F.linear(x, wv, bv)[:, 0]


def gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def gae(cfg, reward, value, done, last_value, last_done):
    value_tp1 = torch.cat([value[1:], last_value[None]])
    nonterm = 1.0 - torch.cat([done[1:], last_done[None]]).float()
    adv = torch.empty_like(reward)
    g = torch.zeros_like(last_value)
    for t in reversed(range(reward.shape[0])):
        delta = reward[t] + cfg.gamma * value_tp1[t] * nonterm[t] - value[t]
        g = delta + cfg.gamma * cfg.lam * nonterm[t] * g
        adv[t] = g
    return adv, adv + value


def loss_of(outputs, cfg, mb):
    """The ppo2 loss of one minibatch (obs, action, old logp, old value,
    advantage, return) given the net's (logits, value) on it."""
    _, action, old_logp, old_value, adv, ret = mb
    logits, value = outputs
    logp_all = F.log_softmax(logits, dim=-1)
    ratio = torch.exp(logp_all.gather(1, action.long()[:, None])[:, 0] - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = torch.maximum(-adv_n * ratio, -adv_n * ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps))
    v_clip = old_value + (value - old_value).clamp(-cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
    entropy = -(logp_all.exp() * logp_all).sum(-1).mean()
    return pg.mean() + cfg.vf_coef * v_loss - cfg.ent_coef * entropy


def leaf_gaps(program, reference, keep=None) -> float:
    """Worst leaf of |norm(program) - norm(reference)| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    pn = torch.stack([p.double().norm() for p in program])
    rn = torch.stack([r.double().norm() for r in reference])
    keep = torch.ones_like(rn, dtype=torch.bool) if keep is None else keep
    gaps = (pn - rn).abs() / torch.maximum(rn, rn[keep].median())
    return float(gaps[keep].max())


def check(capture, batch, params0, gen_state, cfg, device):
    """The numbers compared, as (name, value) pairs.  ``capture``: the
    program's rollout forwards, its update forwards, its first gradient and
    its parameters after the iteration's last step; ``batch``: the
    rollout's obs (T + 1 frames), actions, rewards, dones and the last
    done."""
    if [tuple(p.shape) for p in params0] != param_shapes():
        return [("shape_mismatches", 1.0)]
    params = [p.detach().clone().requires_grad_(True) for p in params0]
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    obs, actions, rewards, dones, last_done = batch
    T = actions.shape[0]
    logit_gap = value_gap = action_gap = 0.0
    values, logps = [], []
    with torch.no_grad():
        for t in range(T + 1):
            logits, value = forward(params, obs[t])
            plog, pval = capture.rollout[t]
            logit_gap = max(logit_gap, float((plog - logits).abs().max()))
            value_gap = max(value_gap, float((pval - value).abs().max()))
            if t == T:
                last_value = value
                break
            score = logits + gumbel(tuple(logits.shape), gen, device)
            act = actions[t].long()[:, None]
            action_gap = max(action_gap,
                             float((score.max(-1).values - score.gather(1, act)[:, 0]).max()))
            logps.append(F.log_softmax(logits, dim=-1).gather(1, act)[:, 0])
            values.append(value)
    adv, ret = gae(cfg, rewards, torch.stack(values), dones, last_value, last_done)
    flat = [x.reshape((-1,) + x.shape[2:])
            for x in (obs[:T], actions, torch.stack(logps), torch.stack(values), adv, ret)]
    total = flat[1].shape[0]
    mb_size = total // cfg.n_minibatches
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(BETA1, BETA2), eps=ADAM_EPS)
    loss_gap, grad1, k = 0.0, None, 0
    for _ in range(cfg.n_epochs):
        perm = torch.randperm(total, generator=gen, device=device)
        for i in range(cfg.n_minibatches):
            mb = [x[perm[i * mb_size:(i + 1) * mb_size]] for x in flat]
            loss = loss_of(forward(params, mb[0]), cfg, mb)
            out = capture.update[k] if k < len(capture.update) else None
            if out is None or out[0].shape[0] != mb_size:
                loss_gap = max(loss_gap, 1.0)  # the program's forward saw other rows
            else:
                with torch.no_grad():
                    loss_prog = loss_of(out, cfg, mb)
                loss_gap = max(loss_gap, float((loss_prog - loss.detach()).abs()
                                               / loss.detach().abs()))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            with torch.no_grad():
                norm = torch.sqrt(sum((p.grad * p.grad).sum() for p in params))
                if norm >= cfg.max_grad_norm:
                    for p in params:
                        p.grad.copy_(p.grad / norm * cfg.max_grad_norm)
            if k == 0:
                grad1 = [p.grad.detach().clone() for p in params]
            opt.step()
            k += 1
    rn = torch.stack([g.double().norm() for g in grad1])
    moved = rn >= NEGLIGIBLE_GRAD * rn.median()
    if capture.params is None or capture.n != k:
        update_gap = 1.0  # the program took another number of steps
    else:
        update_gap = leaf_gaps([a - b for a, b in zip(capture.params, params0)],
                               [p.detach() - b for p, b in zip(params, params0)], moved)
    return [
        ("logit_gap", logit_gap),
        ("value_gap", value_gap),
        ("action_gap", action_gap),
        ("loss_gap", loss_gap),
        ("grad_gap", leaf_gaps(capture.grad1, grad1)),
        ("update_gap", update_gap),
    ]


@contextlib.contextmanager
def layers_in_fp8():
    """The control's precision: every convolution and the dense layer take
    their input and weight rounded to float8 (e4m3), the step below the
    bfloat16 the configuration states (the gradient passed straight
    through)."""

    def fp8(x):
        x = x.to(BF16)
        return x + (x.to(torch.float8_e4m3fn).to(BF16) - x).detach()

    saved = dict(_layers)
    _layers["conv"] = lambda x, w, b: F.conv2d(fp8(x), fp8(w), padding=1) + b.to(BF16)[:, None, None]
    _layers["dense"] = lambda x, w, b: F.linear(fp8(x), fp8(w)) + b.to(BF16)
    try:
        yield
    finally:
        _layers.update(saved)
