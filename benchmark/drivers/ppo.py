"""PPO training on the envs, as ``learn/train.py:main`` builds it: the
program's learner (``learn.ppo.make_train_fns``'s ``train_iter``, the
trainer's defaults) over the fast path with the traffic's refill bucket,
every env reset and its phase staggered.

Set-up writes the asset root, builds the envs and the learner, loads the
initial parameters the benchmark draws from the traffic's fixed seed (on
the device, in one call), and runs one whole iteration with the program's forwards, Adam's
steps and the rollout recorded (hooks of the net and the optimizer, removed
after it): the iteration the reference learner follows, and the warm-up of
every shape.  The window starts at the next iteration's start and runs
iterations for ``--seconds``.  It reports the device time of a PPO update
(``train_update_s``): on CUDA events, from the end of a rollout's last env
step to the start of the next rollout's first (the bootstrap forward, GAE,
the minibatch updates, the next rollout's first frame and policy forward),
the mean over the updates that finish in the window.  Beside it, read per
layer, the rate: the env steps of the rollout steps completed in the
window over its length, the updates inside it counted in its time.  The
first env step called after the window closes ends the run.
For env slots chosen from the seed, every step and frame of the set-up
iteration and of the window is recorded and replayed by the reference
(``reference/envs.py``).
"""

from __future__ import annotations

import contextlib
import random
import shutil
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import envloop, inputs, yardstick
from benchmark.harness import Outcome
from benchmark.reference import learner as ref_learner
from benchmark.trace import traced

STEP_SPAN = "benchmark.fast_step"
FRAME_SPAN = "benchmark.frame"
PROGRAM_SPANS = ("procgen_torch.refill",)


class WindowClosed(Exception):
    pass


def port_learner(cell, seeds, root, device):
    """The program: its envs and its learner's ``make_train_fns``."""
    from procgen_torch.learn import ppo

    envs = envloop.EnvBatch(cell.config, cell.traffic, device)

    def make_train_fns(cfg, fast_step, render_fn):
        init, train_iter, _ = ppo.make_train_fns(envs.gd, envs.cfg, envs.pack, cfg, fast_step,
                                                 render_fn, device)
        return init, train_iter

    return SimpleNamespace(envs=envs, ppo=ppo, make_train_fns=make_train_fns)


def initial_params(net, seed: int, device) -> list:
    """The initial parameters, drawn from ``seed`` on the device in one
    call: a normal clamped to two standard deviations scaled to variance
    about 1 / fan_in for each weight (lecun's scale), zero biases."""
    shapes = [p.shape for p in net.parameters()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(s.numel() for s in shapes), generator=gen, device=device).clamp_(-2, 2)
    out = []
    for shape, chunk in zip(shapes, torch.split(flat, [s.numel() for s in shapes])):
        if len(shape) == 1:
            out.append(torch.zeros(shape, device=device))
        else:
            fan_in = shape[1:].numel()
            out.append(chunk.view(shape) * (1.0 / fan_in) ** 0.5 / 0.8796256610342398)
    return out


class Envs:
    """The learner's env callables over the program's fast path.  They
    count the steps and frames done inside the window, mark on the device
    where each of its updates starts and ends (the steps either side of
    it), end the run when called after it, hand the sampled slots' steps
    and frames to the recorder and, while ``record`` is set, keep the whole
    rollout batch the reference learner reads."""

    def __init__(self, envs, recorder, span, n_steps: int, device):
        self.envs, self.rec, self.span = envs, recorder, span
        self.n_steps, self.device = n_steps, device
        self.closes_at = float("inf")
        self.steps = self.frames = 0
        self.record = None
        self.calls = []  # the host's clock at each env step called in the window
        self.updates = []  # [end of a rollout, start of the next] marks

    def mark(self):
        """A point on the device's clock (the host's on the CPU)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def update_s(self) -> list:
        """Each update's time between its two marks, in seconds."""
        done = [u for u in self.updates if len(u) == 2]
        if self.device.type != "cuda":
            return [b - a for a, b in done]
        return [a.elapsed_time(b) / 1e3 for a, b in done]

    def step(self, fs, actions):
        now = time.perf_counter()
        if now >= self.closes_at:
            raise WindowClosed
        k = len(self.calls)  # this step's index in the window
        windowed = self.closes_at < float("inf")
        if windowed:
            self.calls.append(now)
            if k % self.n_steps == 0 and self.updates:
                self.updates[-1].append(self.mark())
        with self.span(STEP_SPAN):
            out = self.envs.step(fs, actions)
        in_window = time.perf_counter() < self.closes_at
        self.steps += in_window
        self.rec.step(out.state, actions)
        if self.record is not None:
            r = self.record
            r["actions"].append(actions)
            r["rewards"].append(out.state.reward)
            r["dones"].append(fs.state.done)
            r["last_done"] = out.state.done
        if windowed and in_window and k % self.n_steps == self.n_steps - 1:
            self.updates.append([self.mark()])
        return out

    def frame(self, state):
        with self.span(FRAME_SPAN):
            obs = self.envs.frame(state)
        self.frames += 1
        self.rec.frame(obs)
        if self.record is not None:
            self.record["obs"].append(obs)
        return obs


class Capture:
    """The program's rollout forwards, its update forwards, its first
    gradient as Adam got it and its parameters after the iteration's ``k``
    optimizer steps, through hooks of the net and the optimizer."""

    def __init__(self, ts, k: int):
        self.k, self.rollout, self.update = k, [], []
        self.grad1 = self.params = None
        self.n = 0
        self.hooks = [ts.net.register_forward_hook(self.on_forward),
                      ts.opt.register_step_post_hook(self.on_step)]

    def on_forward(self, module, args, out):
        if not torch.is_grad_enabled():
            self.rollout.append(out)
        else:
            self.update.append(tuple(o.detach() for o in out))

    def on_step(self, opt, args, kwargs):
        self.n += 1
        params = [p for g in opt.param_groups for p in g["params"]]
        if self.n == 1:
            self.grad1 = [opt.state[p]["exp_avg"] / (1 - ref_learner.BETA1) for p in params]
        if self.n == self.k:
            self.params = [p.detach().clone() for p in params]

    def remove(self):
        for h in self.hooks:
            h.remove()


def pace(calls: list, t0: float, seconds: float, n_steps: int) -> str:
    """Where the window's time went, by the host's clock at each env step
    called in it: the gaps across an iteration's boundary (the update, GAE
    and the bootstrap forward), the rollout's median gap (a frame, the
    policy and a step) and its slow gaps, over three times the median (the
    steps that refill)."""
    if len(calls) < 2:
        return "window pace: fewer than two env steps"
    gaps = [(i, b - a) for i, (a, b) in enumerate(zip(calls, calls[1:]), 1)]
    update = [g for i, g in gaps if i % n_steps == 0]
    rollout = sorted(g for i, g in gaps if i % n_steps)
    med = rollout[len(rollout) // 2] if rollout else float("nan")
    slow = [g for g in rollout if g > 3 * med]
    return (f"window pace: {len(calls)} env steps called in {seconds} s; {len(update)} updates "
            f"{sum(update):.3f} s; rollout gaps median {1e3 * med:.2f} ms, {len(slow)} slow "
            f"(over 3x) {sum(slow):.3f} s, the rest {sum(rollout) - sum(slow):.3f} s; "
            f"first call {calls[0] - t0:.3f} s in, last {t0 + seconds - calls[-1]:.3f} s "
            f"before the close")


def run(ctx, system=None) -> Outcome:
    cell, dev = ctx.cell, ctx.device
    traffic = cell.traffic
    n = traffic["num_envs"]
    seeds = inputs.sub_seeds(ctx.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    root = envloop.write_assets(traffic["fixed"]["assets"])  # the policy sees them
    learner = (system or port_learner)(cell, seeds, root, dev)
    order = inputs.order(seeds["order"], n)
    phases = inputs.phases(traffic["fixed"]["phases"], n, learner.envs.timeout)[order]
    fs0 = learner.envs.start(phases, order)
    slots = envloop.sample_slots(traffic["check"], phases, learner.envs.timeout,
                                 random.Random(seeds["sample"]))
    rec = envloop.Recorder(slots, dev)
    span = torch.profiler.record_function if ctx.trace else (lambda _: contextlib.nullcontext())
    cfg = learner.ppo.PPOConfig(**traffic["ppo"])
    envs = Envs(learner.envs, rec, span, cfg.n_steps, dev)
    init_ts, train_iter = learner.make_train_fns(cfg, envs.step, envs.frame)
    gen = torch.Generator(device=dev)
    gen.manual_seed(traffic["fixed"]["policy"])
    ts = init_ts(gen)
    params0 = initial_params(ts.net, traffic["fixed"]["params"], dev)
    with torch.no_grad():
        for p, q in zip(ts.net.parameters(), params0):
            p.copy_(q)
    ep_acc = torch.zeros((n,), dtype=torch.float32, device=dev)

    # the set-up iteration: the steps the reference follows, and the warm-up
    capture = Capture(ts, cfg.n_epochs * cfg.n_minibatches)
    gen_state = gen.get_state()
    envs.record = {"obs": [], "actions": [], "rewards": [], "dones": []}
    ts, fs, ep_acc, _ = train_iter(ts, fs0, gen, ep_acc)
    del fs0
    capture.remove()
    record, envs.record = envs.record, None
    sync()

    flops = [0]

    def count(module, args, out):
        rows = args[0].shape[0]
        flops[0] += rows * per_obs * (3 if torch.is_grad_enabled() else 1)

    per_obs = yardstick.impala_forward_flops()
    counter = ts.net.register_forward_hook(count) if ctx.trace else None
    window = traced((STEP_SPAN, FRAME_SPAN) + PROGRAM_SPANS) if ctx.trace else contextlib.nullcontext()
    setup_s = time.perf_counter() - ctx.t_start
    envs.steps = envs.frames = 0
    with window as tr:
        t0 = time.perf_counter()
        envs.closes_at = t0 + ctx.seconds
        try:
            while True:
                ts, fs, ep_acc, _ = train_iter(ts, fs, gen, ep_acc)
        except WindowClosed:
            pass
        sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if counter is not None:
        counter.remove()
    updates = envs.update_s()
    metrics = {"setup_s": setup_s,
               "train_update_s": sum(updates) / len(updates) if updates else float("nan"),
               "env_steps_per_s.train": n * envs.steps / ctx.seconds}
    counts = {"frames": envs.frames, "num_envs": n, "flops": flops[0],
              "record_bytes": rec.bytes()}
    steps, calls = envs.steps, envs.calls
    if ctx.trace:
        work = yardstick.composite_work(yardstick.entity_records(fs.state),
                                        yardstick.atlas_bytes(cell.config["game"]))
        counts["composite_bytes"], counts["composite_flops"] = work
    env_record = rec.host()
    del ts, fs, train_iter, envs, rec
    checks, notes = envloop.check_envs(cell, root, order, phases, env_record)
    batch = (torch.stack(record["obs"]), torch.stack(record["actions"]),
             torch.stack(record["rewards"]), torch.stack(record["dones"]), record["last_done"])
    del record
    gaps = ref_learner.check(capture, batch, params0, gen_state, cfg, dev)
    limits = traffic["limits"]
    checks += [(name, value, limits.get(name, 0)) for name, value in gaps]
    notes.append(f"the check's record held {counts['record_bytes']} bytes on the device")
    notes.append(pace(calls, t0, ctx.seconds, cfg.n_steps)
                 + f"; updates on the device {', '.join(f'{u:.4f}' for u in updates)} s")
    for line in notes:
        print(line, file=sys.stderr)
    shutil.rmtree(root, ignore_errors=True)
    return Outcome(metrics=metrics, attempted=n * steps, failed=0,
                   memory_peak_bytes=peak, checks=checks,
                   trace=tr.summary if ctx.trace else None, counts=counts)
