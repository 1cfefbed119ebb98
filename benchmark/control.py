"""The control of ``correct`` and the faults it must catch: a run whose timed
path computes below the configuration's precision, or carries a fault,
must come out not correct.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 5 [--fault F]

For each seed it runs the cell's driver over a short window with a
stand-in for the program and prints the numbers compared beside their
limits.

- Env cells: the program's env batch with its frames kept to 4 bits a
  sample (int4 for the uint8 frame the configuration states).  The
  reference, which plays one env at a time on the host, cannot take the
  place of 4096 envs in a window; every number it compares is exact.
- The training cell: the reference learner (``reference/learner.py``) put
  in the program's place over the program's envs, its convolutions and
  dense layer fed float8 (e4m3) instead of bfloat16.

``--fault`` plants a fault instead, in the program's envs or in the
reference learner: ``unchanged`` (a step returns the state it was given;
the learner steps with a learning rate of 0), ``half`` (only the first
half of the envs is stepped; the loss is taken over the first half of
each minibatch), ``answer`` (one byte of one env's frame flipped, the env
moving on each step; env 0's action altered where the policy hands it
over).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from benchmark import envloop, harness
from benchmark.reference import learner as ref_learner

FAULTS = ("precision", "unchanged", "half", "answer")


def _select(pred, a, b):
    """Per env, ``a``'s fields where ``pred``, else ``b``'s (containers of
    batched tensors: dataclasses and dicts)."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: _select(pred, getattr(a, f.name), getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: _select(pred, a[k], b[k]) for k in a}
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


class FaultyEnvs(envloop.EnvBatch):
    """The program's env batch with one fault (module docstring)."""

    def __init__(self, cell, seeds, root, device, fault="precision"):
        super().__init__(cell.config, cell.traffic, device)
        self.fault, self.frames_drawn = fault, 0
        self._step = self.step
        self.step = self.faulty_step

    def faulty_step(self, fs, actions):
        if self.fault == "unchanged":
            return fs
        out = self._step(fs, actions)
        if self.fault == "half":
            n = actions.shape[0]
            out = _select(torch.arange(n, device=actions.device) < n // 2, out, fs)
        return out

    def frame(self, env_state):
        out = super().frame(env_state)
        if self.fault == "precision":
            out = out & 0xF0
        elif self.fault == "answer":
            out = out.clone()
            out[self.frames_drawn % out.shape[0], 31, 31, 0] ^= 1
        self.frames_drawn += 1
        return out


class RefNet(torch.nn.Module):
    """The reference learner's net as a module, so that the driver's hooks
    and parameter loading see it as the program's."""

    def __init__(self, device):
        super().__init__()
        self.params = torch.nn.ParameterList(
            torch.nn.Parameter(torch.zeros(s, device=device)) for s in ref_learner.param_shapes())

    def forward(self, obs):
        return ref_learner.forward(list(self.params), obs)


def learner_stand_in(cell, seeds, root, device, fault="precision"):
    """The reference learner in the program's place, over the program's envs."""
    envs = envloop.EnvBatch(cell.config, cell.traffic, device)

    def make_train_fns(cfg, fast_step, render_fn):
        def init(gen):
            net = RefNet(device)
            lr = 0.0 if fault == "unchanged" else cfg.lr
            opt = torch.optim.Adam(net.parameters(), lr=lr,
                                   betas=(ref_learner.BETA1, ref_learner.BETA2),
                                   eps=ref_learner.ADAM_EPS)
            return SimpleNamespace(net=net, opt=opt)

        def train_iter(ts, fs, gen, ep_acc):
            if fault == "precision":
                with ref_learner.layers_in_fp8():
                    return _iteration(ts, fs, gen, ep_acc)
            return _iteration(ts, fs, gen, ep_acc)

        def _iteration(ts, fs, gen, ep_acc):
            cols = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done")}
            with torch.no_grad():
                for _ in range(cfg.n_steps):
                    obs = render_fn(fs.state)
                    logits, value = ts.net(obs)
                    noise = ref_learner.gumbel(tuple(logits.shape), gen, logits.device)
                    action = torch.argmax(logits + noise, -1)
                    logp = F.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
                    cols["done"].append(fs.state.done)
                    handed = action.to(torch.int32)
                    if fault == "answer":
                        handed = handed.clone()
                        handed[0] = (handed[0] + 1) % 15
                    fs = fast_step(fs, handed)
                    for k, v in zip(("obs", "action", "logp", "value", "reward"),
                                    (obs, action.to(torch.int32), logp, value, fs.state.reward)):
                        cols[k].append(v)
                _, last_value = ts.net(render_fn(fs.state))
            b = {k: torch.stack(v) for k, v in cols.items()}
            adv, ret = ref_learner.gae(cfg, b["reward"], b["value"], b["done"], last_value,
                                       fs.state.done)
            flat = [x.reshape((-1,) + x.shape[2:])
                    for x in (b["obs"], b["action"], b["logp"], b["value"], adv, ret)]
            total = flat[1].shape[0]
            size = total // cfg.n_minibatches
            params = list(ts.net.parameters())
            for _ in range(cfg.n_epochs):
                perm = torch.randperm(total, generator=gen, device=flat[0].device)
                for i in range(cfg.n_minibatches):
                    mb = [x[perm[i * size:(i + 1) * size]] for x in flat]
                    if fault == "half":
                        mb = [x[:size // 2] for x in mb]
                    loss = ref_learner.loss_of(ts.net(mb[0]), cfg, mb)
                    ts.opt.zero_grad(set_to_none=True)
                    loss.backward()
                    with torch.no_grad():
                        norm = torch.sqrt(sum((p.grad * p.grad).sum() for p in params))
                        if norm >= cfg.max_grad_norm:
                            for p in params:
                                p.grad.copy_(p.grad / norm * cfg.max_grad_norm)
                    ts.opt.step()
            return ts, fs, ep_acc, {}

        return init, train_iter

    from procgen_torch.learn import ppo

    return SimpleNamespace(envs=envs, ppo=ppo, make_train_fns=make_train_fns)


STAND_INS = {"random_actions": FaultyEnvs, "ppo": learner_stand_in}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=FAULTS, default="precision",
                    help="precision (the control) or a fault planted in the stand-in")
    args = ap.parse_args(argv)

    cell = harness.find_cell(args.workload, harness.HERE.parent)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.seconds, False, time.perf_counter(), dev)
        stand_in = STAND_INS[cell.traffic["driver"]]
        out = harness.run_cell(ctx, lambda *a: stand_in(*a, fault=args.fault))
        correct = all(v <= lim for _, v, lim in out.checks)
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault,
                          "correct": correct,
                          "checks": {n: [v, lim] for n, v, lim in out.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    harness.set_cache_dirs()
    raise SystemExit(main())
