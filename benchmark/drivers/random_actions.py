"""Random actions over a staggered batch of envs: the fast path's step with
its refill, then the frame, in a closed loop for the window.

Set-up writes the synthetic asset root under ``TMPDIR``, builds the game,
its pack and the fast path with the traffic's refill bucket, starts every
env reset with its phase staggered uniformly over the game's timeout (so
refills arrive at their steady rate) and fills the queue, then warms up one
step and one frame.  The window steps with actions uniform over the 15,
drawn on the device, and records a CUDA event after each frame, read once
after the window: no host synchronisation is added to the loop.

What the window produced is checked after it closes: for env slots chosen
from the seed before the window (``envloop.sample_slots``), the recorder
copies each step's actions and state fields and each frame on the device,
and the reference replays those slots from their first level through every
step of the run (``reference/envs.py``).
"""

from __future__ import annotations

import contextlib
import random
import shutil
import sys
import time

import numpy as np
import torch

from benchmark import envloop, inputs, yardstick
from benchmark.harness import Outcome
from benchmark.trace import traced

STEP_SPAN = "benchmark.fast_step"
FRAME_SPAN = "benchmark.frame"
PROGRAM_SPANS = ("procgen_torch.refill",)


def default_system(cell, seeds, root, device):
    """The program under test: its env batch."""
    return envloop.EnvBatch(cell.config, cell.traffic, device)


def run(ctx, system=None) -> Outcome:
    cell, dev = ctx.cell, ctx.device
    traffic = cell.traffic
    n = traffic["num_envs"]
    seeds = inputs.sub_seeds(ctx.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    root = envloop.write_assets(seeds["assets"])
    envs = (system or default_system)(cell, seeds, root, dev)
    order = inputs.order(seeds["order"], n)
    phases = inputs.phases(traffic["fixed"]["phases"], n, envs.timeout)[order]
    fs0 = envs.start(phases, order)
    gen = inputs.action_generator(traffic["fixed"]["actions"], dev)
    by_slot = torch.as_tensor(order, device=dev)

    def actions_now():  # slot j takes env order[j]'s action of the fixed stream
        return inputs.random_actions(gen, n)[by_slot]

    slots = envloop.sample_slots(traffic["check"], phases, envs.timeout,
                                 random.Random(seeds["sample"]))
    rec = envloop.Recorder(slots, dev)
    actions = actions_now()
    fs = envs.step(fs0, actions)  # warm-up: a step and a frame
    rec.step(fs.state, actions)
    rec.frame(envs.frame(fs.state))
    del fs0
    sync()

    span = torch.profiler.record_function if ctx.trace else (lambda _: contextlib.nullcontext())
    timing = dev.type == "cuda"
    events = []
    window = traced((STEP_SPAN, FRAME_SPAN) + PROGRAM_SPANS) if ctx.trace else contextlib.nullcontext()
    steps, nxt, frame = 0, None, None
    setup_s = time.perf_counter() - ctx.t_start
    with window as tr:
        if timing:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        t0 = time.perf_counter()
        if not timing:  # the CPU: each step's end on the host clock
            events.append(t0)
        while time.perf_counter() - t0 < ctx.seconds:
            actions = actions_now()
            with span(STEP_SPAN):
                nxt = envs.step(fs, actions)
            with span(FRAME_SPAN):
                frame = envs.frame(nxt.state)
            if timing:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            else:
                events.append(time.perf_counter())
            rec.step(nxt.state, actions)
            rec.frame(frame)
            fs = nxt
            steps += 1
        sync()
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if timing else 0
    step_ms = [a.elapsed_time(b) if timing else 1e3 * (b - a) for a, b in zip(events, events[1:])]
    metrics = {
        "setup_s": setup_s,
        "env_steps_per_s": n * steps / window_s,
        "step_ms_p95": float(np.percentile(step_ms, 95)) if step_ms else float("nan"),
    }
    counts = {"frames": steps, "num_envs": n, "record_bytes": rec.bytes()}
    if ctx.trace:
        work = yardstick.composite_work(yardstick.entity_records(fs.state),
                                        yardstick.atlas_bytes(cell.config["game"]))
        counts["composite_bytes"], counts["composite_flops"] = work
    record = rec.host()
    del fs, nxt, frame, envs, rec
    checks, notes = envloop.check_envs(cell, root, order, phases, record)
    notes.append(f"the check's record held {counts['record_bytes']} bytes on the device")
    for line in notes:
        print(line, file=sys.stderr)
    shutil.rmtree(root, ignore_errors=True)
    return Outcome(metrics=metrics, attempted=n * steps, failed=0, memory_peak_bytes=peak,
                   checks=checks, trace=tr.summary if ctx.trace else None, counts=counts)
