#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build every CUDA kernel from procgen_torch/csrc (one nvcc each, started
   together) into procgen_torch/_build;
2. each kernel against its plain PyTorch version on synthetic inputs
   (compositor: N=512, E=40, every z_filter, binary and fractional alpha;
   E=513, coinrun's table, with kmax 60 and kmax = E; and edge records:
   box edges on pixel centres and one ulp off, sizes of 1e-6, boxes at
   +-1e6 and off screen, tiled boxes, overlapping records of different z,
   a canvas half exactly 0, kmax 0, 1 and E, every z_filter): bitwise equal;
3. for each main path (maze hard: static grid; miner hard and chaser hard:
   grid-dynamic, two compositor passes per frame with the grid drawn
   between them; coinrun hard: center-agent view, entity push, 513 records;
   leaper hard: static view, tiled and axis-rotated sprites, a pre-roll in
   every reset):
   a. the port on the card against the port on the CPU (whose plain
      versions the CPU tests hold against the JAX package): 8 envs, 40
      steps with forced resets, every state field and frame bitwise equal;
   b. the main path: 4096 envs, refill bucket 512, generated assets, seed
      123: cold start, then 110 rendered steps with random actions (leaper
      50: its resets pre-roll 300 physics steps); the compositor kernel's
      launches counted from 0 just before and read just after (launches ==
      frames, or 2 x frames for grid-dynamic games), frames not black;
   c. the final frames through the kernel and through the plain version,
      in each z pass, bitwise equal, each pass's input canvas >= +0 (the
      kernel skips pixels outside a record's box, which is exact only
      without -0.0);
   d. timing (CUDA events / synchronized host clock): env-steps/s, the
      kernel's ms per launch at the path's shapes beside its plain version
      and its bound, the step's split (game step, refill, frame; miner's
      gravity sweep; leaper's pre-roll), torch ops per refill from one
      profiled refill at the bucket size, and device time by kernel from a
      short profiler window;
4. the gym3 surface: ``ProcgenTorchEnv(..., device="cuda")`` on miner, a
   few act/observe rounds with its state on the card.

The last three lines are the card's name and power limit, the kernels line,
and ``{"ok": true, "device": {...}}``.  The script needs CUDA; without it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

from procgen_torch import convert, cuda_build
from procgen_torch.bench.profiling import profiled
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import step_env_no_reset
from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.games import make_game
from procgen_torch.games.leaper import PREROLL_SPAN
from procgen_torch.games.miner import SWEEP_SPAN
from procgen_torch.parallel.fast import REFILL_SPAN, make_fast_fns
from procgen_torch.render import compositor, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate
# outside the tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 ops per pixel inside a drawn record's box in the compositor: col/row
# sub+div, tiling, texel scale, premultiply, 3 channels of mul+add+sub
FLOPS_PER_PIXEL_RECORD = 20

FRAME_SPAN = "chip_smoke.frame"
N_ENVS = 4096
BUCKET = 512
WARMUP = 10
# (game, mode, timed steps) of each main path: maze is the static-grid
# class, miner and chaser the grid-dynamic one, coinrun the center-agent
# view with entity push, leaper the static view with tiled and rotated
# sprites.  Leaper runs fewer steps: each of its resets pre-rolls 300
# physics steps.
PATHS = (
    ("maze", "hard", 100), ("miner", "hard", 100), ("chaser", "hard", 100),
    ("coinrun", "hard", 100), ("leaper", "hard", 40),
)


T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **kw, "t": time.perf_counter() - T0}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def game_cfg(game: str, mode: str, n: int) -> EnvConfig:
    return EnvConfig(
        env_name=game, num_envs=n, distribution_mode=DistributionMode[mode],
        rand_seed=123, use_generated_assets=True,
    )


def passes(gd) -> int:
    """Compositor launches per frame."""
    return 2 if gd.grid_dynamic else 1


def host_ms(fn, iters: int, warmup: bool = True) -> float:
    """Mean wall ms per call, synchronized, after one warm-up call unless
    the caller has just run the same work."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# profiler spans read by the timing phase (procgen_torch/bench/profiling.py
# sums host ns, count and torch ops per span, and device ns by kernel)
SPANS = (REFILL_SPAN, FRAME_SPAN, SWEEP_SPAN, PREROLL_SPAN)


def phase_kernels_vs_plain(dev):
    """Compositor kernel vs plain version on synthetic records."""
    checks = []
    for binary in (True, False):
        rec, atlas, canvas = compositor.synthetic_case(512, 40, 20, 32, seed=5, binary_alpha=binary)
        tables = types.SimpleNamespace(var_mips=torch.as_tensor(atlas, device=dev))
        rec_t = torch.as_tensor(rec, device=dev)
        canvas_t = torch.as_tensor(canvas, device=dev)
        for z_filter in ("all", "neg", "nonneg"):
            for kmax in (40, 17):
                k = compositor.composite_entities(tables, rec_t, kmax, canvas_t, z_filter)
                p = compositor.composite_entities_ref(tables, rec_t, kmax, canvas_t, z_filter)
                torch.cuda.synchronize()
                eq = bitwise_equal(k, p)
                drew = float((k != canvas_t).float().mean())
                checks.append(dict(binary_alpha=binary, z_filter=z_filter, kmax=kmax,
                                   bitwise_equal=eq, drawn_share=drew,
                                   max_abs_err=float((k - p).abs().max())))
                if not eq or drew < 0.01:
                    raise AssertionError(f"compositor kernel vs plain failed: {checks[-1]}")
    # coinrun's table: 512 slots and the pad record, few or all drawn (the
    # kernel stages only the first kmax records)
    E = 513
    rec, atlas, canvas = compositor.synthetic_case(256, E, 20, 32, seed=7, binary_alpha=True)
    tables = types.SimpleNamespace(var_mips=torch.as_tensor(atlas, device=dev))
    canvas_t = torch.as_tensor(canvas, device=dev)
    for kmax in (60, E):
        r = rec.copy()
        r[:, kmax:, 7] = 0.0  # non-drawable records sort last
        rec_t = torch.as_tensor(r, device=dev)
        kmax_t = torch.full((), kmax, dtype=torch.int32, device=dev)
        k = compositor.composite_entities(tables, rec_t, kmax_t, canvas_t)
        p = compositor.composite_entities_ref(tables, rec_t, kmax, canvas_t)
        torch.cuda.synchronize()
        checks.append(dict(records=E, binary_alpha=True, z_filter="all", kmax=kmax,
                           bitwise_equal=bitwise_equal(k, p),
                           drawn_share=float((k != canvas_t).float().mean()),
                           max_abs_err=float((k - p).abs().max())))
        if not checks[-1]["bitwise_equal"]:
            raise AssertionError(f"compositor kernel vs plain failed: {checks[-1]}")
    # edge records (compositor.edge_case): the clipping to each record's
    # pixel span must change no bit
    E = 24
    rec, atlas, canvas = compositor.edge_case(512, E, seed=9)
    tables = types.SimpleNamespace(var_mips=torch.as_tensor(atlas, device=dev))
    rec_t = torch.as_tensor(rec, device=dev)
    canvas_t = torch.as_tensor(canvas, device=dev)
    for z_filter in ("all", "neg", "nonneg"):
        for kmax in (0, 1, E):
            kmax_t = torch.full((), kmax, dtype=torch.int32, device=dev)
            k = compositor.composite_entities(tables, rec_t, kmax_t, canvas_t, z_filter)
            p = compositor.composite_entities_ref(tables, rec_t, kmax, canvas_t, z_filter)
            torch.cuda.synchronize()
            checks.append(dict(records=E, edge=True, z_filter=z_filter, kmax=kmax,
                               bitwise_equal=bitwise_equal(k, p),
                               drawn_share=float((k != canvas_t).float().mean()),
                               max_abs_err=float((k - p).abs().max())))
            if not checks[-1]["bitwise_equal"] or (kmax == 0 and not bitwise_equal(k, canvas_t)):
                raise AssertionError(f"compositor kernel vs plain failed: {checks[-1]}")
    emit("kernel_vs_plain", kernel="composite_entities", shapes=[[512, 40], [256, 513], [512, E]],
         cases=checks)


def phase_card_vs_cpu(dev, game, mode):
    """The port on the card against the port on the CPU, small input, with
    forced resets (action -1) so that levels are swapped in."""
    n, steps = 8, 40
    cfg = game_cfg(game, mode, n)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    runs = {}
    # leaper refills all 8 envs at once: each of its levels pre-rolls 300
    # physics steps (the other paths compact the refill into buckets of 4)
    bucket = n if game == "leaper" else 4
    for d in ("cpu", dev):
        init, step = make_fast_fns(gd, cfg, pack, refill_bucket=bucket)
        fs = init.cold(seeded_template(gd, cfg, n, device=d))
        rs = np.random.RandomState(9)
        frames, states = [], []
        for t in range(steps):
            a = rs.randint(0, 15, size=n).astype(np.int32)
            if t in (12, 13, 30):  # forced resets run the queue swap
                a[:] = -1
            acts = torch.as_tensor(a, device=d)
            fs = step(fs, acts)
            frames.append(fast2.render_frames2(gd, cfg, fs.state, pack).cpu())
            states.append(convert.fast_state_to_numpy(fs))
        runs[d] = (frames, states)
    (f_cpu, s_cpu), (f_gpu, s_gpu) = runs["cpu"], runs[dev]
    dones = rewards = 0
    for t in range(steps):
        if not torch.equal(f_cpu[t], f_gpu[t]):
            raise AssertionError(f"{game}: card frame differs from CPU frame at step {t}")
        for k, a in s_cpu[t].items():
            b = s_gpu[t][k]
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            if not np.array_equal(a, b):
                raise AssertionError(f"{game}: card state {k} differs from CPU at step {t}")
        dones += int(s_cpu[t]["state.done"].sum())
        rewards += int((s_cpu[t]["state.reward"] != 0).sum())
    emit("card_vs_cpu", game=game, mode=mode, envs=n, steps=steps, episodes_ended=dones,
         rewarded_steps=rewards, fields=len(s_cpu[0]), bitwise_equal=True)


def phase_main_path(dev, game, mode, timed_steps):
    steps = WARMUP + timed_steps
    cfg = game_cfg(game, mode, N_ENVS)
    gd = make_game(cfg)
    t0 = time.perf_counter()
    pack = RenderPack(gd, cfg)
    pack_s = time.perf_counter() - t0
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=BUCKET)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)

    compositor.launches = 0  # counts start here: this main path's run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = init.cold(seeded_template(gd, cfg, N_ENVS, device=dev))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    black, frames_rendered = [], 0
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    reward_sum = torch.zeros((), dtype=torch.float64, device=dev)
    refills = torch.zeros((), dtype=torch.int64, device=dev)  # timed steps only
    for t in range(steps):
        if t == WARMUP:
            torch.cuda.synchronize()
            t_loop = time.perf_counter()
        acts = torch.randint(0, 15, (N_ENVS,), generator=gen, device=dev, dtype=torch.int32)
        valid_before = fs.queue_valid
        fs = step(fs, acts)
        if t >= WARMUP:
            # the step's refill loop ran ceil(need / bucket) bucket refills,
            # need = envs that finished with an empty queue entry
            need = (fs.state.done & ~valid_before).sum()
            refills += torch.div(need + BUCKET - 1, BUCKET, rounding_mode="floor")
        obs = fast2.render_frames2(gd, cfg, fs.state, pack)
        frames_rendered += 1
        checksum += obs[:, 31, 31, :].to(torch.int64).sum()
        episodes += fs.state.done.sum()
        reward_sum += fs.state.reward.to(torch.float64).sum()
        if t % 50 == 0 or t == steps - 1:
            black.append(float((obs > 0).float().mean()))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    launches = compositor.launches  # counts read here
    if launches != passes(gd) * frames_rendered:
        raise AssertionError(
            f"{game}: compositor launches {launches} != {passes(gd)} x {frames_rendered} frames"
        )
    if min(black) < 0.9:
        raise AssertionError(f"{game}: frames look black: non-zero share {black}")
    if not torch.isfinite(fs.state.ents.x).all() or not torch.isfinite(fs.state.reward).all():
        raise AssertionError(f"{game}: non-finite state")
    sps = N_ENVS * timed_steps / loop_s
    emit("main_path", game=game, mode=mode, num_envs=N_ENVS, steps=steps,
         refill_bucket=BUCKET, pack_build_s=pack_s, cold_start_s=cold_s,
         timed_steps=timed_steps, env_steps_per_s=sps, launches=launches,
         launches_per_frame=passes(gd), frames=frames_rendered,
         episodes_ended=int(episodes), reward_sum=float(reward_sum),
         nonzero_pixel_share=black, checksum=int(checksum))
    refills_per_step = int(refills) / timed_steps
    return types.SimpleNamespace(
        game=game, mode=mode, gd=gd, cfg=cfg, pack=pack, fs=fs, init=init, step=step,
        gen=gen, launches=launches, sps=sps, refills_per_step=refills_per_step,
    )


def phase_final_frames(run, dev):
    """The final state through the kernel and through the plain version, in
    each z pass of the frame (the grid drawn between them for grid-dynamic
    games), and through render_frames2."""
    gd, cfg, states = run.gd, run.cfg, run.fs.state
    tables = fast2.get_tables(gd, cfg, run.pack, dev)
    records, kmax = fast2.entity_records(gd, cfg, states, tables)
    records = fast2._pad_records(records).contiguous()
    canvas = states.static_layer.to(torch.float32)
    if gd.center_agent(cfg):  # the moving view draws bg (and grid) per frame
        canvas = fast2.bg_pass(gd, cfg, states, tables, canvas)
        if not gd.grid_dynamic:
            canvas = fast2.grid_pass(gd, cfg, states, tables, canvas)
    before = compositor.launches
    filters = ("neg", "nonneg") if gd.grid_dynamic else ("all",)
    k, err, inputs = canvas, 0.0, []
    for z_filter in filters:
        if torch.signbit(k).any() or not torch.isfinite(k).all():
            raise AssertionError(f"{run.game}: pass {z_filter}'s canvas holds -0.0, < 0 or non-finite")
        inputs.append((k, z_filter))
        out_k = compositor.composite_entities(tables, records, kmax, k, z_filter)
        out_p = compositor.composite_entities_ref(tables, records, kmax, k, z_filter)
        torch.cuda.synchronize()
        if not bitwise_equal(out_k, out_p):
            raise AssertionError(f"{run.game}: final frames, pass {z_filter}: kernel != plain")
        err = max(err, float((out_k - out_p).abs().max()))
        k = out_k
        if z_filter == "neg":
            k = fast2.grid_pass(gd, cfg, states, tables, k)
    frames = fast2.render_frames2(gd, cfg, states, run.pack)
    torch.cuda.synchronize()
    if compositor.launches != before + 2 * len(filters):
        raise AssertionError(f"{run.game}: final-frame check did not launch the kernel")
    if not torch.equal(frames, fast2.to_frames(k)):
        raise AssertionError(f"{run.game}: final frames: kernel passes and render_frames2 disagree")
    emit("final_frames", game=run.game, passes=list(filters), bitwise_equal=True,
         max_abs_err=err, shape=list(records.shape))
    run.tables, run.records, run.kmax, run.inputs, run.err = tables, records, kmax, inputs, err


def drawn_pixels(records, z_filter) -> int:
    """Pixels inside the boxes of the records a pass draws, clipped to the
    screen: the exact box test of the plain version, per axis."""
    ok = records[..., 7] > 0
    if z_filter == "neg":
        ok &= records[..., 10] < 0
    elif z_filter == "nonneg":
        ok &= records[..., 10] >= 0
    d = records[ok]
    px = torch.arange(64, dtype=torch.float32, device=d.device) + 0.5

    def inside(lo, size):
        t = (px[None, :] - lo[:, None]) / size[:, None]
        return ((t >= 0) & (t < 1)).sum(1)

    return int((inside(d[:, 0], d[:, 2]) * inside(d[:, 1], d[:, 3])).sum())


def phase_timing(run, dev):
    gd, cfg, tables, records, kmax = run.gd, run.cfg, run.tables, run.records, run.kmax
    N, E, _ = records.shape
    n_pass = len(run.inputs)

    def frame_passes(fn):
        def call():
            for canvas, z_filter in run.inputs:
                fn(tables, records, kmax, canvas, z_filter)
        return call

    kern_ms = cuda_ms(frame_passes(compositor.composite_entities), 50) / n_pass
    plain_ms = cuda_ms(frame_passes(compositor.composite_entities_ref), 3) / n_pass
    # bound of one launch: each input read once, each output written once,
    # counting the records the kernel reads (the first kmax of each env);
    # operations on the pixels inside the boxes this run actually draws,
    # clipped to the screen (over the passes)
    drawn = int((records[..., 7] > 0).sum())
    read = min(E, int(kmax))
    nbytes = (N * read * records.shape[-1] * 4 + tables.var_mips.numel() + 4
              + run.inputs[0][0].numel() * 4 * 2)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    pixels = sum(drawn_pixels(records[:, :read], z) for _, z in run.inputs) / n_pass
    ops_ms = pixels * FLOPS_PER_PIXEL_RECORD / PEAK_F32_FLOPS * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))

    # where a step's time goes.  Unprofiled: the whole step and the refills
    # per step (from the main path), then the game step alone, one frame and
    # one refill at the bucket size (and miner's gravity sweep), each timed
    # alone on a synchronized host clock.  Profiled: one refill at the bucket
    # size (host activity only: torch ops per refill, leaper's pre-roll
    # span), then a short window of steps with spans for the refill (inside
    # make_fast_fns), miner's sweep (inside its game step) and the frame
    # (here), for device time by kernel and torch ops per span.
    fs = run.fs
    step_ms = N / run.sps * 1e3
    acts = torch.randint(0, 15, (N,), generator=run.gen, device=dev, dtype=torch.int32)
    game_step_ms = host_ms(lambda: step_env_no_reset(gd, cfg, fs.state, acts), 3)
    frame_ms = host_ms(lambda: fast2.render_frames2(gd, cfg, fs.state, run.pack), 10)
    bucket_states = seeded_template(gd, cfg, BUCKET, device=dev)
    # leaper's refill pre-rolls 300 physics steps per level: one timed call,
    # warm from the main path's refills
    if run.game == "leaper":
        refill_ms = host_ms(lambda: run.init.cold(bucket_states), 1, warmup=False)
    else:
        refill_ms = host_ms(lambda: run.init.cold(bucket_states), 3)
    extra = {}
    if run.game == "miner":
        s = fs.state
        W = gd.world_dim
        ax, ay = s.ents.x[:, 0], s.ents.y[:, 0]
        free = ay.to(torch.int64) * W + ax.to(torch.int64)
        flat = s.grid.reshape(N, W * W)
        sweep_ms = host_ms(lambda: gd.gravity_sweep(flat, ay, ax, free), 3)
        extra = dict(sweep_ms=sweep_ms)

    _, rp = profiled(lambda: run.init.cold(bucket_states), SPANS, cuda=False)
    if rp["count"][REFILL_SPAN] != 1:
        raise AssertionError(f"{run.game}: the profiled refill ran {rp['count'][REFILL_SPAN]} times")
    if rp["count"][PREROLL_SPAN]:
        extra.update(preroll_profiled_share_of_refill=rp["ns"][PREROLL_SPAN] / rp["ns"][REFILL_SPAN],
                     torch_ops_per_preroll=rp["ops"][PREROLL_SPAN] / rp["count"][PREROLL_SPAN])

    window = 5
    box = [fs]

    def steps_and_frames():
        for _ in range(window):
            a = torch.randint(0, 15, (N,), generator=run.gen, device=dev, dtype=torch.int32)
            box[0] = run.step(box[0], a)
            with torch.profiler.record_function(FRAME_SPAN):
                fast2.render_frames2(gd, cfg, box[0].state, run.pack)

    wall_ns, w = profiled(steps_and_frames, SPANS)
    dev_ns = sum(w["kernels"].values())
    comp_ns = sum(v for k, v in w["kernels"].items() if "composite_kernel" in k)
    top = sorted(w["kernels"].items(), key=lambda kv: -kv[1])[:6]
    spans = {k: v for k, v in w["ns"].items() if w["count"][k]}
    if SWEEP_SPAN in spans:
        # the sweep inside the profiled steps themselves, against the
        # window's wall time and against that time less the refill and
        # frame spans (the game step and the queue bookkeeping)
        rest_ns = wall_ns - sum(spans.get(k, 0) for k in (REFILL_SPAN, FRAME_SPAN))
        extra.update(sweep_profiled_share_of_step=spans[SWEEP_SPAN] / wall_ns,
                     sweep_profiled_share_of_game_step=spans[SWEEP_SPAN] / rest_ns,
                     torch_ops_per_sweep=w["ops"][SWEEP_SPAN] / window)
    emit("timing", game=run.game, mode=run.mode, kernel_ms=kern_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, bytes_bound_ms=bytes_ms,
         ops_bound_ms=ops_ms, records=[N, E], kmax=read, drawn_records=drawn,
         drawn_pixels_per_launch=pixels,
         launches_per_step=n_pass, env_steps_per_s=run.sps,
         step_ms=step_ms, game_step_ms=game_step_ms, frame_ms=frame_ms,
         refill_ms=refill_ms, refills_per_step=run.refills_per_step,
         refill_share_est=run.refills_per_step * refill_ms / step_ms,
         frame_share_est=frame_ms / step_ms,
         game_step_share_est=game_step_ms / step_ms, **extra,
         torch_ops_per_refill=rp["ops"][REFILL_SPAN],
         profiled_steps=window, profiled_refills=w["count"][REFILL_SPAN],
         profiled_wall_ms=wall_ns / 1e6,
         profiled_span_share={k: v / wall_ns for k, v in spans.items()},
         profiled_device_busy_share=dev_ns / wall_ns,
         compositor_device_ms_per_step=comp_ns / 1e6 / window,
         torch_ops_per_frame=w["ops"][FRAME_SPAN] / window,
         torch_ops_per_step_outside_spans=w["ops_outside"] / window,
         top_device_kernels=[[k[:60], v / 1e6] for k, v in top])
    return dict(ms=kern_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                launches=run.launches, launches_per_step=n_pass, max_abs_err=run.err,
                records=[N, E])


def phase_env(dev):
    """The gym3 surface on the card: a few act/observe rounds on miner."""
    env = ProcgenTorchEnv(64, "miner", rand_seed=7, distribution_mode="hard",
                          use_generated_assets=True, device=dev)
    leaves = [env.state.grid, env.state.ents.x, env.state.rng.key, env.state.static_layer,
              env.state.extra["diamonds_remaining"]]
    if any(t.device.type != "cuda" for t in leaves):
        raise AssertionError("ProcgenTorchEnv state is not on the card")
    rs = np.random.RandomState(1)
    firsts = 0
    for _ in range(8):
        env.act(rs.randint(0, 15, size=64))
        rew, ob, first = env.observe()
        firsts += int(first.sum())
    if ob["rgb"].shape != (64, 64, 64, 3) or not np.isfinite(rew).all():
        raise AssertionError("ProcgenTorchEnv observe returned bad shapes or values")
    if env._obs.device.type != "cuda" or env.state.done.device.type != "cuda":
        raise AssertionError("ProcgenTorchEnv frames or state left the card")
    emit("env", game="miner", num=64, rounds=8, firsts=firsts,
         nonzero_pixel_share=float((ob["rgb"] > 0).mean()), state_device=str(env.state.grid.device),
         infos=len(env.get_info()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = "cuda"
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=card, torch_device=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    built = cuda_build.build_all()
    emit("build", kernels={n: {"seconds": r["seconds"], "ptxas": [
        ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]}
        for n, r in built.items()}, compositor_blocks_per_sm=compositor.blocks_per_sm())

    phase_kernels_vs_plain(dev)
    per_path = {}
    for game, mode, timed_steps in PATHS:
        phase_card_vs_cpu(dev, game, mode)
        run = phase_main_path(dev, game, mode, timed_steps)
        phase_final_frames(run, dev)
        per_path[f"{game}-{mode}"] = phase_timing(run, dev)
        del run
        torch.cuda.empty_cache()
    phase_env(dev)

    first = per_path[f"{PATHS[0][0]}-{PATHS[0][1]}"]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "composite_entities",
        "route": "cuda",
        "source": "procgen_torch/csrc/compositor.cu",
        "replaces": "procgen_tpu/render/pallas_compositor.py:53",
        "tpu_source": "procgen_tpu/render/pallas_compositor.py:_kernel",
        # launches summed over the main paths; each path's own count, times
        # and bound at its shapes are in per_path (the top-level times are
        # the first path's)
        "launches": sum(p["launches"] for p in per_path.values()),
        "bitwise_equal": True,
        "max_abs_err": max(p["max_abs_err"] for p in per_path.values()),
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "library_ms": None,
        "per_path": per_path,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
