#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. build every library from procgen_torch/csrc into procgen_torch/_build,
   one compiler process each, started together (the CUDA kernels with
   nvcc, the PNG decoder's unfilter with g++);
2. each kernel against its plain PyTorch version on synthetic inputs
   (compositor: N=512, E=40, every z_filter, binary and fractional alpha;
   E=513, coinrun's table, with kmax 60 and kmax = E; and edge records:
   box edges on pixel centres and one ulp off, sizes of 1e-6, boxes at
   +-1e6 and off screen, tiled boxes, overlapping records of different z,
   a canvas half exactly 0, kmax 0, 1 and E, every z_filter): bitwise equal;
   the maze kernels (``generate_kernel``, ``place_kernel`` of
   ``csrc/mazegen.cu``) against ``mazegen.generate_maze_ref`` and
   ``place_objects_ref`` on the same card tensors at 512 and 4096 rows,
   max_dim 25 (maze hard) and 31 (maze memory): grid, free cells, their
   count and the cursor bitwise equal; each kernel's device ms per launch
   (profiler), the plain version's ms per call, one env of the largest
   size alone (the kernel's dependent chain, measured) and the bytes it
   moves; miner's gravity sweep (``sweep_kernel`` of
   ``csrc/miner_sweep.cu``) against ``MinerGame.gravity_sweep_ref`` on the
   same card tensors at 4096 rows of easy, hard and memory levels after 5
   random steps: grid, diamond count and crush flag bitwise equal; its
   device ms per launch, the wrapper's host ms, the plain version's ms,
   one env alone, the bytes, and ptxas's registers, stack and spills;
3. the double cos/sin of a float angle (caveflyer's ship), ``fmath.dsincos``:
   on 2^24 float32 angles in [-300, 300] the card's bits against the CPU's
   (must be equal), and the count of angles where torch's own float64
   cos/sin, narrowed, differ between the two; glibc's ``atan2f`` as float32
   ops (``fmath.atan2f``, starpilot's aimed bullets) and the correctly
   rounded square roots (``fmath.sqrt32``; ``fmath.dsqrt`` in parity mode,
   float64, also against numpy's IEEE root) on 2^22 inputs, card against
   CPU (must be equal);
   Then the same over a pack atlas: bigfish's, from a synthetic asset root
   whose agent sprite has fractional alpha (1-254), at the records of a
   few steps of 512 envs: bitwise equal;
4. for each of the sixteen main paths (maze hard: static grid; miner hard and
   chaser hard: grid-dynamic, two compositor passes per frame with the
   grid drawn between them; coinrun hard: center-agent view, entity push,
   513 records; leaper hard: static view, tiled and axis-rotated sprites, a
   pre-roll in every reset; ninja hard and jumper hard: center-agent views
   with a HUD drawn after the compositor, ninja's smart throwing stars,
   jumper's cave levelgen; caveflyer hard: center-agent view, free
   rotation, pair collisions, the cave room generator; dodgeball hard:
   static view, free rotation, pair collisions, the entity-reflect sweep,
   tiled lava walls; bigfish hard: static view, fish spawned on the step
   stream with their sprites' aspect ratios, a sequential collision sweep;
   climber hard: center-agent view up a tall world, wall themes, patrolling
   enemies; heist hard: the maze with keys and locked doors, doors blocking
   through the entity push, free rotation; fruitbot hard: a vertical
   scroller under a center-agent view, walls with locked doors, pair
   collisions; plunder hard: lanes of ships spawned on the step stream, a
   sequential pair sweep, HUD bars; starpilot hard: a spawner timeline
   rolled at reset, aimed enemy bullets, the scrolling background pass;
   bossfight hard: 257 records, shields, attack patterns with trails, the
   two-phase pair sweep):
   a. the port on the card against the port on the CPU (whose plain
      versions the CPU tests hold against the JAX package; the CPU half
      in a worker process, beside the card's): 8 envs, 40
      steps with forced resets, every state field and frame
      bitwise equal; bossfight's levels staged so that the boss takes hits
      and rounds are won (its random agents never reach the boss in 40
      steps); also coinrun (center-agent) and maze (static) in the PNG
      configuration;
   b. the main path: 4096 envs, refill bucket 512, seed 123, generated
      assets on the nine earliest paths and PNG assets from the asset root
      on the seven asset games: cold start, then 13 rendered steps with
      random actions (leaper 5: its resets pre-roll 300 physics steps),
      untimed (the benchmark times the program); the kernel's
      launches counted from 0 just before and read just after (launches ==
      frames, or 2 x frames for grid-dynamic games), frames not black; the
      maze kernels' launches counted the same way (2 per refill pass on
      maze, 1 on chaser, jumper and heist, 0 elsewhere; the passes are the
      cold start's and ceil(need / bucket) a step), and the miner sweep
      kernel's (one a step on miner, 0 elsewhere);
   c. the final frames through the kernel and through the plain version,
      in each z pass, bitwise equal, each pass's input canvas >= +0 (the
      kernel skips pixels outside a record's box, which is exact only
      without -0.0), and render_frames2 equal to the kernel's canvas with
      the velocity patch and the HUD painted over it;
   d. timing, of the compositor alone (CUDA events): its ms per launch at
      the final frame's records beside its plain version's and its bound
      (the kernels line's ``per_path``).  The step's split and the torch
      ops per span are the program's own spans, read by the benchmark and
      by ``python3 -m procgen_torch.bench.op_counts GAME MODE --device
      cuda``;
5. the gym3 surface in its default configuration (PNG assets):
   ``ProcgenTorchEnv(..., device="cuda")`` on miner and
   ``ProcgenTorchEnv(64, "bigfish")`` (the card by default), a few
   act/observe rounds each with the state on the card;
6. ``state``: for all 16 games (hard, PNG assets, 8 envs), ``get_state``
   on the card after 20 random steps equals the CPU env's bytes for the
   same seed and actions; ``set_state`` into a fresh card env with another
   seed, 20 more steps beside the CPU env's uninterrupted run: rewards,
   firsts and frames equal at every step, and the bytes equal at the end;
   the blob size per env; then ``get_state`` and ``set_state`` timed once
   at 4096 envs on maze hard.  The CPU envs of this phase and the next run
   in one spawned worker process, beside the card's half;
7. ``render_mode``: ``render_mode="rgb_array"`` at 4 envs for maze, miner,
   coinrun, jumper, starpilot and caveflyer, 5 steps: the card's ms per
   ``get_info`` (the info-frame batch), and ``info["rgb"]`` of the last
   step (4, 512, 512, 3) uint8 and equal on the card and the CPU;
7b. ``sharded``: the env axis over processes (``procgen_torch.parallel.
   sharding``), in spawned ranks: (1) ``entry.dryrun_multichip(1)`` (maze
   easy, dodgeball hard, miner and bigfish easy, one sharded step over one
   NCCL rank) against the same steps with no group; (2) two ranks sharing
   the card over gloo (NCCL refuses two ranks on one GPU), maze easy and
   dodgeball hard at 512 global envs, refill bucket 64, 20 random steps
   with deaths staged unevenly across the ranks: every field of the
   gathered state at every step, rewards, dones and frames equal to one
   process's; (3) one data-parallel PPO iteration over the two ranks at
   the trainer's width (coinrun easy, 256 global envs, 32-step rollout):
   the replicas' parameters bitwise equal, losses finite, the summed
   float32 gradient against a float64 pass within ``F32_GRAD_TOL``; the
   sharded step's ms, the iteration's seconds and its collectives' share,
   the compositor's launches on every rank, and the kernel against plain
   at a rank's shapes;
8. ``oracle``: for all 16 games, 16 envs after 12 random steps on the card,
   ``oracle.oracle_obs`` and ``oracle.oracle_static`` (plain torch) equal
   ``render_frames2`` (the compositor kernel) and ``render_static2`` on the
   card, and the oracle on the CPU, bit for bit;
9. ``ref_parity``: the port in parity mode on the card against the
   reference C++ (``native/refharness/refdump``, as a copy that reads this
   run's asset root: ``procgen_torch/bench/ref_parity.py``): all 16 games,
   hard, seed 23, 16 envs, 40 steps, and the two fault witnesses (plunder
   hard seed 1, 60 steps; starpilot hard seed 7, 360 steps; 2 envs): state
   bytes, rewards, first flags and info ints equal at the reset and after
   every step; the cases run in three spawned processes on the card while
   the oracle phase runs in this one;
10. ``bench``: ``python -m procgen_torch.bench_cli --games maze --num-envs
   4096 --chunk 8 --chunks 1`` in a subprocess started before the
   ref_parity phase: its exit and its one JSON line, whose checksum the
   same loop run in this process repeats; the kernel's
   launches in that loop (one per frame), its final frame kernel against
   plain, and its device time from a profiler window; its ``per_path``
   record is ``bench-maze-hard``;
11. ``train``: ``python -m procgen_torch.learn.train`` (its ``main``) for 2
   PPO iterations at full width on coinrun easy, PNG assets: 256 envs,
   256-step rollouts, 3 epochs of 8 minibatches of 8,192 observations, the
   bf16 IMPALA CNN at depths (16, 32, 32) (the benchmark's
   ``maze-hard.ppo-256`` times the update): the compositor's launches in
   the phase (one per frame, 257 per iteration) and, at the
   last rollout's final frame (256 envs), the kernel against its plain
   version bitwise and its ms per launch; ``max_memory_allocated``; loss
   and entropy finite, parameters changed; and on one minibatch of the
   rollout the float32 net's logits and gradients card against CPU (TF32
   off) and the bf16 logits against the float32 CPU ones, within the
   tolerances stated at ``F32_LOGITS_TOL``, and each float32 side against a
   float64 copy of the net on the CPU (computed in the worker process
   while phases 8-10 run; the phase's line comes last).  Its ``per_path`` record is
   ``train-coinrun-easy``, whose ms per launch is the kernel's device time
   from a profiler window (at 256 envs the event-timed loop measures the
   host).

The asset root: ``PROCGEN_TORCH_ASSET_ROOT`` when it is set (the script
prints which root it used), else a synthetic root
(``procgen_torch.bench.synth_assets``) written into a temporary directory
at the start; the fractional-alpha root of phase 2 goes there too, and the
directory is removed at the end.

The last three lines are the card's name and power limit, the kernels line
(the compositor, the two maze kernels, then the miner sweep), and ``{"ok": true, "device": {...}}``.  The script needs CUDA; without it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from procgen_torch import convert, cuda_build
from procgen_torch import fmath as fm
from procgen_torch import rng as R
from procgen_torch.bench import ref_parity, synth_assets, throughput
from procgen_torch.bench.profiling import profiled
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.game import reset_env, step_env
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.games import bossfight as BF
from procgen_torch.games import make_game
from procgen_torch.games import miner
from procgen_torch.learn import ppo as learn_ppo
from procgen_torch.learn import train
from procgen_torch.learn.nets import ImpalaCNN
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render import assets, compositor, fast2, oracle
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template, tree_map

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate
# outside the tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 ops per pixel inside a drawn record's box in the compositor: col/row
# sub+div, tiling, texel scale, premultiply, 3 channels of mul+add+sub
FLOPS_PER_PIXEL_RECORD = 20

N_ENVS = 4096
BUCKET = 512
# (game, mode, rendered steps, generated assets) of each main path: maze is
# the static-grid class, miner and chaser the grid-dynamic one, coinrun the
# center-agent view with entity push, leaper the static view with tiled and
# rotated sprites, ninja and jumper center-agent views with a HUD,
# caveflyer (a center-agent view) and dodgeball (a static one) with free
# rotation and pair collisions; the seven games that read their sprites'
# aspect ratios from the PNG assets (bigfish, climber, heist, fruitbot,
# plunder, starpilot, bossfight) run in the default configuration, PNG
# assets.  The paths check the program and time nothing (the benchmark
# times it): 13 steps, 5 on leaper (each of its resets pre-rolls 300
# physics steps).
PATHS = (
    ("maze", "hard", 13, True), ("miner", "hard", 13, True), ("chaser", "hard", 13, True),
    ("coinrun", "hard", 13, True), ("leaper", "hard", 5, True), ("ninja", "hard", 13, True),
    ("jumper", "hard", 13, True), ("caveflyer", "hard", 13, True),
    ("dodgeball", "hard", 13, True), ("bigfish", "hard", 13, False),
    ("climber", "hard", 13, False), ("heist", "hard", 13, False),
    ("fruitbot", "hard", 13, False), ("plunder", "hard", 13, False),
    ("starpilot", "hard", 13, False), ("bossfight", "hard", 13, False),
)
# earlier games also held card vs CPU in the PNG configuration
PNG_CARD_VS_CPU = (("coinrun", "hard"), ("maze", "hard"))
# the sprite drawn with fractional alpha in the pack-atlas kernel case
FRACTIONAL_SPRITES = ("misc_assets/fishTile_072.png",)
TRIG_ANGLES = 1 << 24
# the maze kernels' cases (rows, max_dim): maze hard's refill bucket and
# its main path's cold start, and maze memory's max_dim, the kernels' largest
MAZEGEN_CASES = ((BUCKET, 25), (N_ENVS, 25), (BUCKET, 31), (N_ENVS, 31))
MAZE_GOAL = 2  # games/maze.py: GOAL, the object maze places
# the miner sweep kernel's cases (rows, world width): the main path's 4096
# envs at easy, hard and memory; the random steps its inputs take first
MINER_MODES = {10: "easy", 20: "hard", 35: "memory"}
MINER_SWEEP_CASES = tuple((N_ENVS, W) for W in MINER_MODES)
MINER_SWEEP_STEPS = 5
# maze kernel launches per refill pass of the main paths that generate a
# maze: maze's maze and goal, chaser's and jumper's through
# generate_maze_no_dead_ends, heist's through generate_maze_with_doors
MAZEGEN_PER_PASS = {"maze": 2, "chaser": 1, "jumper": 1, "heist": 1}


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


def game_cfg(game: str, mode: str, n: int, generated: bool = True) -> EnvConfig:
    return EnvConfig(
        env_name=game, num_envs=n, distribution_mode=DistributionMode[mode],
        rand_seed=123, use_generated_assets=generated,
    )


def asset_kind(generated: bool) -> str:
    return "generated" if generated else "png"


def phase_assets(tmp: str):
    """The asset root: PROCGEN_TORCH_ASSET_ROOT if set, else a synthetic
    root written under ``tmp``."""
    t0 = time.perf_counter()
    given = bool(os.environ.get(assets.ROOT_ENV))
    if given:
        root = assets.asset_root()
    else:
        root = synth_assets.write_root(os.path.join(tmp, "binary"), seed=0)
        os.environ[assets.ROOT_ENV] = str(root)
    emit("assets", root=str(root), source="environment" if given else "synthetic",
         sprites=len(synth_assets.sprite_names()), backgrounds=len(synth_assets.background_names()),
         seconds=time.perf_counter() - t0)


def passes(gd) -> int:
    """Compositor launches per frame."""
    return 2 if gd.grid_dynamic else 1


def host_ms(fn, iters: int) -> float:
    """Mean wall ms per call, synchronized, after one warm-up call."""
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


def phase_kernels_vs_plain_fractional(dev, tmp):
    """The compositor over a pack atlas with fractional alpha: bigfish's,
    from a synthetic root whose agent sprite has alpha 1-254, at the records
    of 512 envs after a few steps (through the kernel and the plain
    version, bitwise)."""
    saved = os.environ[assets.ROOT_ENV]
    root = synth_assets.write_root(os.path.join(tmp, "fractional"), seed=0,
                                   fractional=FRACTIONAL_SPRITES)
    os.environ[assets.ROOT_ENV] = str(root)
    try:
        n = 512
        cfg = game_cfg("bigfish", "hard", n, generated=False)
        gd = make_game(cfg)
        pack = RenderPack(gd, cfg)
        init, step = make_fast_fns(gd, cfg, pack, refill_bucket=n)
        fs = init.cold(seeded_template(gd, cfg, n, device=dev))
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        for _ in range(5):
            fs = step(fs, torch.randint(0, 15, (n,), generator=gen, device=dev, dtype=torch.int32))
        tables = fast2.get_tables(gd, cfg, pack, dev)
        records, kmax = fast2.entity_records(gd, cfg, fs.state, tables)
        records = fast2._pad_records(records).contiguous()
        canvas = fs.state.static_layer.to(torch.float32)
        k = compositor.composite_entities(tables, records, kmax, canvas)
        p = compositor.composite_entities_ref(tables, records, kmax, canvas)
        torch.cuda.synchronize()
        alpha = tables.var_mips[..., 3]
        frac = int(((alpha > 0) & (alpha < 255)).sum())
        eq = bitwise_equal(k, p)
        emit("kernel_vs_plain_fractional", kernel="composite_entities", game="bigfish",
             envs=n, records=list(records.shape), kmax=int(kmax), fractional_texels=frac,
             bitwise_equal=eq, drawn_share=float((k != canvas).float().mean()),
             max_abs_err=float((k - p).abs().max()))
        if not eq or frac == 0:
            raise AssertionError("compositor kernel vs plain over fractional alpha failed")
    finally:
        os.environ[assets.ROOT_ENV] = saved
        assets.clear_caches()


def maze_levels(dev, rows: int, max_dim: int, seed: int):
    """A batch of maze levels' draws as maze's reset makes them: a block of
    ``reset_max_draws`` per row and odd sizes 3..max_dim, row 0 the
    largest."""
    rs = np.random.RandomState(seed)
    seeds = torch.as_tensor(rs.randint(0, 2**31 - 1, size=rows).astype(np.int32), device=dev)
    dims = rs.randint(0, (max_dim - 1) // 2, size=rows) * 2 + 3
    dims[0] = max_dim
    draws = make_game(game_cfg("maze", "hard", rows)).reset_max_draws
    return R.mt_block_open(R.mt_seed(seeds), draws), torch.as_tensor(dims, dtype=torch.int32,
                                                                     device=dev)


PROFILED_LAUNCHES = 20


def kernel_device_ms_of(fn, kernel: str, counter=None) -> float:
    """The device ms per launch of ``kernel`` over PROFILED_LAUNCHES calls of
    ``fn`` (after a warm-up), from a profiler window: the kernel's own time,
    where events would time the host's pace of a short launch.  With
    ``counter`` (the kernel's launch count, read before and after the
    window) the divisor is the launches counted, else one per call."""
    fn()

    def calls():
        for _ in range(PROFILED_LAUNCHES):
            fn()

    before = counter() if counter else 0
    _, w = profiled(calls, ())
    launched = counter() - before if counter else PROFILED_LAUNCHES
    device_ns = [v for k, v in w["kernels"].items() if kernel in k]
    if not device_ns or not launched:
        raise AssertionError(f"the profiler saw no {kernel} launch ({launched} counted)")
    return sum(device_ns) / 1e6 / launched


def mazegen_timing(gen, place, plain_gen, plain_place, one_gen, one_place, nbytes) -> dict:
    """Each maze kernel's device ms per launch, its plain version's ms per
    call (its eager ops, on CUDA events), and its floor: the larger of one
    env of the largest size alone (its dependent chain, measured) and its
    bytes at the card's bandwidth."""
    out = {}
    for name, kern, plain, one in (("generate", gen, plain_gen, one_gen),
                                   ("place", place, plain_place, one_place)):
        chain_ms = kernel_device_ms_of(one, f"{name}_kernel")
        bytes_ms = nbytes[name] / PEAK_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (chain_ms, "chain"))
        out[name] = dict(kernel_ms=kernel_device_ms_of(kern, f"{name}_kernel"),
                         plain_ms=cuda_ms(plain, 1), bound_ms=bound_ms, bound_by=bound_by,
                         chain_ms=chain_ms, bytes=nbytes[name], bytes_bound_ms=bytes_ms)
    return out


def phase_mazegen_vs_plain(dev) -> dict:
    """The maze kernels against their plain versions on the same card
    tensors at MAZEGEN_CASES: grid, free cells, their count and the cursor
    after ``generate_maze`` and after ``place_objects`` (maze's goal),
    bitwise, in two launches; then ``mazegen_timing``.  Returns each case's
    timings by kernel."""
    cases = {}
    for rows, max_dim in MAZEGEN_CASES:
        blk, dims = maze_levels(dev, rows, max_dim, seed=rows + max_dim)
        before = mazegen.launches
        k = mazegen.generate_maze(blk, dims, max_dim)
        k_rs, k_placed = mazegen.place_objects(k.rng, k, MAZE_GOAL, 1, dims, max_dim)
        launched = mazegen.launches - before
        p = mazegen.generate_maze_ref(blk, dims, max_dim)
        p_rs, p_placed = mazegen.place_objects_ref(p.rng, p, MAZE_GOAL, 1, dims, max_dim)
        torch.cuda.synchronize()
        pairs = dict(grid=(k.grid, p.grid), free_cells=(k.free_cells, p.free_cells),
                     num_free_cells=(k.num_free_cells, p.num_free_cells),
                     cursor=(k.rng.cursor, p.rng.cursor), placed_grid=(k_placed.grid, p_placed.grid),
                     placed_free_cells=(k_placed.free_cells, p_placed.free_cells),
                     placed_cursor=(k_rs.cursor, p_rs.cursor))
        differ = [name for name, (a, b) in pairs.items() if not torch.equal(a, b)]
        if differ or launched != 2:
            raise AssertionError(f"maze kernels vs plain at ({rows}, {max_dim}): {differ} differ, "
                                 f"{launched} launches")
        one_blk, one_dims = maze_levels(dev, 1, max_dim, seed=max_dim)
        one = mazegen.generate_maze(one_blk, one_dims, max_dim)
        # bytes each kernel moves at least: the draws it reads and 16 bytes
        # of size, count and cursors a row; generate writes the whole grid
        # and free-cell rows, place reads a free cell a draw and writes the
        # goal's cell
        drawn = int((k.rng.cursor - blk.cursor).sum()), int((k_rs.cursor - k.rng.cursor).sum())
        AD = max_dim + 2
        nbytes = dict(generate=drawn[0] * 8 + rows * (16 + (AD * AD + max_dim * max_dim) * 4),
                      place=drawn[1] * 12 + rows * 20)
        t = mazegen_timing(
            lambda: mazegen.generate_maze(blk, dims, max_dim),
            lambda: mazegen.place_objects(k.rng, k, MAZE_GOAL, 1, dims, max_dim),
            lambda: mazegen.generate_maze_ref(blk, dims, max_dim),
            lambda: mazegen.place_objects_ref(k.rng, k, MAZE_GOAL, 1, dims, max_dim),
            lambda: mazegen.generate_maze(one_blk, one_dims, max_dim),
            lambda: mazegen.place_objects(one.rng, one, MAZE_GOAL, 1, one_dims, max_dim),
            nbytes)
        for rec in t.values():
            rec.update(records=[rows, max_dim])
        cases[f"{rows}x{max_dim}"] = t
        emit("mazegen_vs_plain", rows=rows, max_dim=max_dim, bitwise_equal=True,
             checked=list(pairs), draws_read=list(drawn), **t)
    return cases


def miner_sweep_inputs(dev, rows: int, W: int):
    """The sweep's inputs as miner's game step makes them, at ``rows`` envs
    of the mode whose world is W wide: levels reset and stepped
    MINER_SWEEP_STEPS times with random actions (dug cells, moving
    objects), the agent where it stands."""
    cfg = game_cfg("miner", MINER_MODES[W], rows)
    gd = make_game(cfg)
    state = reset_env(gd, cfg, seeded_template(gd, cfg, rows, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(W)
    for _ in range(MINER_SWEEP_STEPS):
        acts = torch.randint(0, 15, (rows,), generator=gen, device=dev, dtype=torch.int32)
        state = step_env(gd, cfg, state, acts)
    ax, ay = state.ents.x[:, 0], state.ents.y[:, 0]
    free = ay.to(torch.int64) * W + ax.to(torch.int64)
    return gd, (state.grid.reshape(rows, W * W), ay, ax, free)


def phase_miner_sweep_vs_plain(dev, ptxas: list) -> dict:
    """Miner's sweep kernel against ``gravity_sweep_ref`` on the same card
    tensors at MINER_SWEEP_CASES: grid, diamond count and crush flag
    bitwise, in one launch; then its device ms per launch (profiler), the
    wrapper's host ms per call, the plain version's ms per call (events),
    one env alone (the kernel's dependent chain, measured) and the bytes it
    moves.  Returns each case's record."""
    cases = {}
    for rows, W in MINER_SWEEP_CASES:
        gd, args = miner_sweep_inputs(dev, rows, W)
        before = miner.launches
        k = gd.gravity_sweep(*args)
        launched = miner.launches - before
        p = gd.gravity_sweep_ref(*args)
        torch.cuda.synchronize()
        differ = [name for name, a, b in zip(("grid", "diamonds", "crushed"), k, p)
                  if not torch.equal(a.to(b.dtype), b)]
        if differ or launched != 1 or k[0].dtype != torch.int32:
            raise AssertionError(f"miner sweep kernel vs plain at ({rows}, {W}): {differ} "
                                 f"differ, {launched} launches, grid {k[0].dtype}")
        one = tuple(a[:1] for a in args)
        chain_ms = kernel_device_ms_of(lambda: gd.gravity_sweep(*one), "sweep_kernel")
        # each grid read and written once as int32, the agent's two cells
        # read, the count and the flag written
        nbytes = rows * (2 * W * W * 4 + 4 + 8 + 4 + 1)
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (chain_ms, "chain"))
        rec = dict(kernel_ms=kernel_device_ms_of(lambda: gd.gravity_sweep(*args), "sweep_kernel"),
                   host_ms=host_ms(lambda: gd.gravity_sweep(*args), 50),
                   plain_ms=cuda_ms(lambda: gd.gravity_sweep_ref(*args), 1),
                   bound_ms=bound_ms, bound_by=bound_by, chain_ms=chain_ms, bytes=nbytes,
                   bytes_bound_ms=bytes_ms, records=[rows, W])
        cases[f"{rows}x{W}"] = rec
        moved = int((k[0] != args[0]).any(1).sum())
        emit("miner_sweep_vs_plain", rows=rows, world_dim=W, bitwise_equal=True,
             envs_moved=moved, envs_crushed=int(k[2].sum()), ptxas=ptxas, **rec)
    return cases


def phase_trig(dev):
    """fmath.dsincos (caveflyer's double cos/sin, narrowed) on the card
    against the CPU, bit for bit, on TRIG_ANGLES float32 angles in [-300,
    300]; beside it, how often torch's own float64 cos/sin, narrowed,
    differ between the two (the route this one replaces)."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(TRIG_ANGLES, generator=gen, dtype=torch.float64) * 600 - 300).float()
    cfg = types.SimpleNamespace(parity_mode=False)
    xd = x.to(dev)
    differ, torch_differ = 0, 0
    for part, part_d in zip(x.split(1 << 22), xd.split(1 << 22)):
        want = fm.dsincos(cfg, part)
        got = fm.dsincos(cfg, part_d)
        differ += sum(int((g.cpu().view(torch.int32) != w.view(torch.int32)).sum())
                      for g, w in zip(got, want))
        for fn in (torch.sin, torch.cos):
            a = fn(part.double()).float().view(torch.int32)
            b = fn(part_d.double()).float().cpu().view(torch.int32)
            torch_differ += int((a != b).sum())
    ms = cuda_ms(lambda: fm.dsincos(cfg, xd), 5)
    if differ:
        raise AssertionError(f"dsincos: {differ} card results differ from the CPU's")
    emit("trig", function="fmath.dsincos", angles=TRIG_ANGLES, range=[-300, 300],
         card_vs_cpu_differ=differ, torch_float64_trig_card_vs_cpu_differ=torch_differ,
         card_ms_all_angles=ms)
    # atan2f (starpilot's aimed bullets) and sqrt32 (the sub-step count,
    # the aimed bullets' speed), card against CPU, and how often torch's own
    # float32 sqrt differs between the two (the route sqrt32 replaces)
    n = TRIG_ANGLES // 4
    y, x = (torch.randn(n, generator=gen) * torch.exp(torch.rand(n, generator=gen) * 20 - 10)
            for _ in range(2))
    y[:16], x[:16] = 0.0, 0.0  # signed zeros and the axes
    y[:8] = -y[:8]
    s2 = x * x + y * y
    checks = {}
    parity = types.SimpleNamespace(parity_mode=True)
    for name, fn, args in (("fmath.atan2f", fm.atan2f, (y, x)), ("fmath.sqrt32", fm.sqrt32, (s2,)),
                           ("fmath.dsqrt", lambda v: fm.dsqrt(parity, v), (s2,))):
        want = fn(*args)
        got = fn(*(a.to(dev) for a in args)).cpu()
        bits = torch.int64 if want.dtype == torch.float64 else torch.int32
        checks[name] = int((got.view(bits) != want.view(bits)).sum())
    # parity mode's double root against the IEEE one (numpy's float64 sqrt)
    ieee = torch.from_numpy(np.sqrt(s2.double().numpy()))
    dsqrt_vs_ieee = int((fm.dsqrt(parity, s2.to(dev)).cpu().view(torch.int64)
                         != ieee.view(torch.int64)).sum())
    torch_sqrt_differ = int((torch.sqrt(s2).view(torch.int32)
                             != torch.sqrt(s2.to(dev)).cpu().view(torch.int32)).sum())
    if any(checks.values()) or dsqrt_vs_ieee:
        raise AssertionError(f"card results differ from the CPU's: {checks}, "
                             f"dsqrt against the IEEE root: {dsqrt_vs_ieee}")
    emit("trig_atan2f_sqrt", inputs=n, card_vs_cpu_differ=checks,
         dsqrt_card_vs_ieee_differ=dsqrt_vs_ieee,
         torch_float32_sqrt_card_vs_cpu_differ=torch_sqrt_differ)


def stage_bossfight(state):
    """Every env's shields down, each hit a round (round health 1), and one
    of the agent's bullets just under the boss, flying up: the next step
    damages the boss and ends a round (the boss prepared for the next, its
    shields raised) or the level.  Random agents do not reach the boss in
    40 steps."""
    ex = dict(state.extra)
    ex["shields_are_up"] = torch.zeros_like(ex["shields_are_up"])
    ex["round_health"] = torch.ones_like(ex["round_health"])
    b = BF.BOSS_SLOT
    ents = eo.write_slot(state.ents, b, health=ex["num_rounds"].to(torch.float32))
    bullet = eo.make_entity(ents.x[:, b], ents.y[:, b] - ents.ry[:, b] - 0.5, 0.0,
                            BF.PLAYER_BULLET_VEL, 0.25, 0.25, BF.PLAYER_BULLET)
    bullet.update(image_theme=ex["player_laser_theme"], collides_with_entities=True,
                  expire_time=25)
    ents, _ = eo.append_entity(ents, bullet)
    return state.replace(ents=ents, extra=ex)


# bossfight's card-vs-CPU levels are staged (the same edit on both
# devices) before these steps: the first and after the forced resets
BOSSFIGHT_STAGED_STEPS = (0, 14, 31)


def card_vs_cpu_run(d, game, mode, generated):
    """One device's half of the card_vs_cpu phase: 8 envs, 40 steps of
    seeded actions with forced resets (action -1) so that levels are
    swapped in (leaper's pre-rolls 300 physics steps in every reset),
    bossfight's levels staged; returns each step's frames and state.  The
    CPU half runs in the worker process."""
    if torch.device(d).type == "cpu":
        torch.set_num_threads(CPU_WORKER_THREADS)
    n, steps = 8, 40
    cfg = game_cfg(game, mode, n, generated)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    # leaper refills all 8 envs at once: each of its levels pre-rolls 300
    # physics steps (the other paths compact the refill into buckets of 4)
    bucket = n if game == "leaper" else 4
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=bucket)
    fs = init.cold(seeded_template(gd, cfg, n, device=d))
    rs = np.random.RandomState(9)
    frames, states = [], []
    for t in range(steps):
        a = rs.randint(0, 15, size=n).astype(np.int32)
        if t in (12, 13, 30):  # forced resets run the queue swap
            a[:] = -1
        if game == "bossfight" and t in BOSSFIGHT_STAGED_STEPS:
            fs = dataclasses.replace(fs, state=stage_bossfight(fs.state))
        acts = torch.as_tensor(a, device=d)
        fs = step(fs, acts)
        frames.append(fast2.render_frames2(gd, cfg, fs.state, pack).cpu())
        states.append(convert.fast_state_to_numpy(fs))
    return frames, states


def phase_card_vs_cpu(dev, game, mode, worker, generated=True):
    """The port on the card against the port on the CPU, small input, with
    forced resets (``card_vs_cpu_run``; the CPU half in the worker process,
    beside the card's).  Bossfight's staged levels must score: the boss
    takes hits and rounds are won."""
    steps = 40
    cpu = worker.submit(card_vs_cpu_run, "cpu", game, mode, generated)
    runs = {dev: card_vs_cpu_run(dev, game, mode, generated), "cpu": cpu.result()}
    (f_cpu, s_cpu), (f_gpu, s_gpu) = runs["cpu"], runs[dev]
    dones = rewards = rounds_won = 0
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
        if game == "bossfight" and t > 0:  # a round won and the next prepared
            rose = s_cpu[t]["state.extra.round_num"] - s_cpu[t - 1]["state.extra.round_num"]
            rounds_won += int(np.clip(rose, 0, None).sum())
    staged = {}
    if game == "bossfight":
        staged = dict(staged_steps=list(BOSSFIGHT_STAGED_STEPS), rounds_won=rounds_won)
        if rewards == 0 or rounds_won == 0:
            raise AssertionError(f"{game}: the staged levels never scored: {staged}")
    emit("card_vs_cpu", game=game, mode=mode, assets=asset_kind(generated), envs=8,
         steps=steps, episodes_ended=dones,
         rewarded_steps=rewards, fields=len(s_cpu[0]), bitwise_equal=True, **staged)


def phase_main_path(dev, game, mode, steps, generated=True):
    """The main path at N_ENVS envs: ``steps`` rendered steps from a cold
    start, with each kernel's launches counted, the frames not black and
    the state finite."""
    cfg = game_cfg(game, mode, N_ENVS, generated)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=BUCKET)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)

    compositor.launches = 0  # counts start here: this main path's run
    mazegen.launches = 0
    miner.launches = 0
    fs = init.cold(seeded_template(gd, cfg, N_ENVS, device=dev))
    black, frames_rendered = [], 0
    episodes = torch.zeros((), dtype=torch.int64, device=dev)
    first_step_ends = torch.zeros((), dtype=torch.int64, device=dev)  # episodes of 1 step
    reward_sum = torch.zeros((), dtype=torch.float64, device=dev)
    step_refills = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(steps):
        acts = torch.randint(0, 15, (N_ENVS,), generator=gen, device=dev, dtype=torch.int32)
        valid_before, fresh = fs.queue_valid, fs.state.cur_time == 0
        fs = step(fs, acts)
        first_step_ends += (fs.state.done & fresh).sum()
        # the step's refill loop ran ceil(need / bucket) bucket refills,
        # need = envs that finished with an empty queue entry
        need = (fs.state.done & ~valid_before).sum()
        step_refills += torch.div(need + BUCKET - 1, BUCKET, rounding_mode="floor")
        obs = fast2.render_frames2(gd, cfg, fs.state, pack)
        frames_rendered += 1
        checksum += obs[:, 31, 31, :].to(torch.int64).sum()
        episodes += fs.state.done.sum()
        reward_sum += fs.state.reward.to(torch.float64).sum()
        if t % 50 == 0 or t == steps - 1:
            black.append(float((obs > 0).float().mean()))
    torch.cuda.synchronize()
    launches = compositor.launches  # counts read here
    maze_launches = mazegen.launches
    sweep_launches = miner.launches
    if launches != passes(gd) * frames_rendered:
        raise AssertionError(
            f"{game}: compositor launches {launches} != {passes(gd)} x {frames_rendered} frames"
        )
    # the cold start's refill passes, then the steps'
    refill_passes = -(-N_ENVS // BUCKET) + int(step_refills)
    if maze_launches != MAZEGEN_PER_PASS.get(game, 0) * refill_passes:
        raise AssertionError(f"{game}: maze kernel launches {maze_launches} != "
                             f"{MAZEGEN_PER_PASS.get(game, 0)} x {refill_passes} refill passes")
    if sweep_launches != (steps if game == "miner" else 0):
        raise AssertionError(f"{game}: miner sweep launches {sweep_launches} over {steps} steps")
    if min(black) < 0.9:
        raise AssertionError(f"{game}: frames look black: non-zero share {black}")
    if not torch.isfinite(fs.state.ents.x).all() or not torch.isfinite(fs.state.reward).all():
        raise AssertionError(f"{game}: non-finite state")
    emit("main_path", game=game, mode=mode, assets=asset_kind(generated), num_envs=N_ENVS,
         steps=steps, refill_bucket=BUCKET, launches=launches,
         launches_per_frame=passes(gd), frames=frames_rendered,
         mazegen_launches=maze_launches, refill_passes=refill_passes,
         miner_sweep_launches=sweep_launches, episodes_ended=int(episodes),
         episodes_ended_on_first_step=int(first_step_ends), reward_sum=float(reward_sum),
         nonzero_pixel_share=black, checksum=int(checksum))
    return types.SimpleNamespace(
        game=game, mode=mode, gd=gd, cfg=cfg, pack=pack, fs=fs, launches=launches,
        mazegen=dict(launches=maze_launches, refill_passes=refill_passes,
                     launches_per_pass=MAZEGEN_PER_PASS.get(game, 0)),
        sweep_launches=sweep_launches,
    )


def phase_final_frames(run, dev):
    """The final state through the kernel and through the plain version, in
    each z pass of the frame (the grid drawn between them for grid-dynamic
    games), and through render_frames2, which paints the velocity patch and
    the HUD over the composited canvas."""
    gd, cfg, states = run.gd, run.cfg, run.fs.state
    tables = fast2.get_tables(gd, cfg, run.pack, dev)
    records, kmax = fast2.entity_records(gd, cfg, states, tables)
    records = fast2._pad_records(records).contiguous()
    # the background (scrolling, or a moving view's with its grid) or the
    # baked static layer
    canvas = fast2.base_canvas(gd, cfg, states, tables)
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
    painted = fast2._paint_hud(gd, cfg, states, fast2._paint_vel_info(gd, cfg, states, k))
    if not torch.equal(frames, fast2.to_frames(painted)):
        raise AssertionError(f"{run.game}: final frames: kernel passes and render_frames2 disagree")
    emit("final_frames", game=run.game, passes=list(filters), bitwise_equal=True,
         max_abs_err=err, shape=list(records.shape), hud=gd.has_hud(cfg),
         hud_pixel_share=float((painted != k).any(-1).float().mean()))
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


def kernel_timing(run) -> dict:
    """The kernel's and its plain version's ms per launch at the final
    frame's records of ``run`` (after ``phase_final_frames``), and the
    launch's bound."""
    tables, records, kmax = run.tables, run.records, run.kmax
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
    return dict(kernel_ms=kern_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, records=[N, E],
                kmax=read, drawn_records=drawn, drawn_pixels_per_launch=pixels,
                launches_per_step=n_pass)


def kernel_device_ms(run) -> float:
    """The compositor's device ms per launch at ``run``'s final state, from
    a profiler window of PROFILED_LAUNCHES frames, over the launches counted
    in that window."""
    def frame():
        fast2.render_frames2(run.gd, run.cfg, run.fs.state, run.pack)

    return kernel_device_ms_of(frame, "composite_kernel", lambda: compositor.launches)


def phase_timing(run):
    """The compositor alone at the final frame's records of ``run``
    (``kernel_timing``); returns the path's ``per_path`` record."""
    kern = kernel_timing(run)
    emit("timing", game=run.game, mode=run.mode, **kern)
    return path_record(kern, run.launches, run.err)


def path_record(k: dict, launches: int, err: float) -> dict:
    """A path's entry in the kernels line's ``per_path``."""
    return dict(ms=k["kernel_ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                bound_by=k["bound_by"], launches=launches,
                launches_per_step=k["launches_per_step"], max_abs_err=err, records=k["records"])


def phase_env(dev):
    """The gym3 surface on the card, in the default configuration (PNG
    assets): a few act/observe rounds on miner (``device`` given) and on
    bigfish (``device`` left at its default, the card)."""
    for game, extra, kw in (("miner", "diamonds_remaining", {"device": dev}),
                            ("bigfish", "fish_eaten", {})):
        env = ProcgenTorchEnv(64, game, rand_seed=7, distribution_mode="hard", **kw)
        leaves = [env.state.grid, env.state.ents.x, env.state.rng.key, env.state.static_layer,
                  env.state.extra[extra]]
        if any(t.device.type != "cuda" for t in leaves):
            raise AssertionError(f"{game}: ProcgenTorchEnv state is not on the card")
        rs = np.random.RandomState(1)
        firsts = 0
        for _ in range(8):
            env.act(rs.randint(0, 15, size=64))
            rew, ob, first = env.observe()
            firsts += int(first.sum())
        if ob["rgb"].shape != (64, 64, 64, 3) or not np.isfinite(rew).all():
            raise AssertionError(f"{game}: ProcgenTorchEnv observe returned bad shapes or values")
        if env._obs.device.type != "cuda" or env.state.done.device.type != "cuda":
            raise AssertionError(f"{game}: ProcgenTorchEnv frames or state left the card")
        emit("env", game=game, assets="png", num=64, rounds=8, firsts=firsts,
             nonzero_pixel_share=float((ob["rgb"] > 0).mean()),
             state_device=str(env.state.grid.device), infos=len(env.get_info()))


GAMES = tuple(sorted(game for game, _, _, _ in PATHS))
STATE_ENVS, STATE_STEPS, STATE_TIMED_ENVS = 8, 20, 4096
RENDER_MODE_GAMES = ("maze", "miner", "coinrun", "jumper", "starpilot", "caveflyer")
# torch threads of the worker process that computes the CPU references
CPU_WORKER_THREADS = 4


def _acts(rs, n):
    return rs.randint(0, 15, size=n).astype(np.int32)


def cpu_state_reference(game):
    """The CPU half of the state phase for one game, in the worker process:
    the bytes after STATE_STEPS steps (action seed 2), then STATE_STEPS more (seed 3)
    with each step's rewards, firsts and frames, and the bytes at the end."""
    torch.set_num_threads(CPU_WORKER_THREADS)
    env = ProcgenTorchEnv(STATE_ENVS, game, rand_seed=5, device="cpu", distribution_mode="hard",
                          render=False)
    rs = np.random.RandomState(2)
    for _ in range(STATE_STEPS):
        env.act(_acts(rs, STATE_ENVS))
    blobs = env.get_state()
    rs = np.random.RandomState(3)
    steps = []
    for _ in range(STATE_STEPS):
        env.act(_acts(rs, STATE_ENVS))
        steps.append((env.state.reward.numpy(), env.state.done.numpy(),
                      env.render_fn(env.state).numpy()))
    return blobs, steps, env.get_state()


def cpu_info_frame(game):
    """The CPU half of the render_mode phase for one game, in the worker
    process: the info frames after 5 steps (action seed 4)."""
    torch.set_num_threads(CPU_WORKER_THREADS)
    env = ProcgenTorchEnv(4, game, rand_seed=5, device="cpu", distribution_mode="hard",
                          render=False, render_mode="rgb_array")
    rs = np.random.RandomState(4)
    for _ in range(5):
        env.act(_acts(rs, 4))
    return np.stack([info["rgb"] for info in env.get_info()])


def cpu_worker():
    """One spawned process for the CPU halves of the card_vs_cpu, state and
    render_mode phases, so that they run beside the card's half (the asset
    root reaches it through the environment)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))


def phase_state(dev, worker):
    """get_state/set_state on every game (PNG assets, hard): the card's
    bytes after STATE_STEPS steps equal the CPU env's for the same seed and
    actions; a fresh card env with another seed restores them and takes as
    many steps beside the CPU env's uninterrupted run (the card's own, by the
    first check and the card_vs_cpu phases): rewards, firsts and frames
    equal at every step, the bytes equal at the end.  The CPU env runs in
    the worker process.  Then both calls are timed at the main path's
    width on maze."""
    refs = {game: worker.submit(cpu_state_reference, game) for game in GAMES}
    sizes, seconds = {}, {}
    t_phase = time.perf_counter()
    for game in GAMES:
        t0 = time.perf_counter()
        kw = dict(distribution_mode="hard", render=False)
        card = ProcgenTorchEnv(STATE_ENVS, game, rand_seed=5, device=dev, **kw)
        rs = np.random.RandomState(2)
        for _ in range(STATE_STEPS):
            card.act(_acts(rs, STATE_ENVS))
        blobs = card.get_state()
        restored = ProcgenTorchEnv(STATE_ENVS, game, rand_seed=99, device=dev, **kw)
        restored.set_state(blobs)
        rs = np.random.RandomState(3)
        got = []
        for _ in range(STATE_STEPS):
            restored.act(_acts(rs, STATE_ENVS))
            s = restored.state
            got.append((s.reward.cpu().numpy(), s.done.cpu().numpy(),
                        restored.render_fn(s).cpu().numpy()))
        final = restored.get_state()
        seconds[game] = time.perf_counter() - t0
        cpu_blobs, want, cpu_final = refs[game].result()
        if blobs != cpu_blobs:
            raise AssertionError(f"{game}: get_state on the card differs from the CPU's")
        for t, (g, w) in enumerate(zip(got, want)):
            if not (np.array_equal(g[0].view(np.int32), w[0].view(np.int32))
                    and np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])):
                raise AssertionError(f"{game}: the restored env differs at step {t}")
        if final != cpu_final:
            raise AssertionError(f"{game}: the bytes differ after the replay")
        sizes[game] = [min(map(len, blobs)), max(map(len, blobs))]
    games_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    env = ProcgenTorchEnv(STATE_TIMED_ENVS, "maze", rand_seed=5, device=dev,
                          distribution_mode="hard")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blobs = env.get_state()
    get_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    env.set_state(blobs)
    torch.cuda.synchronize()
    set_s = time.perf_counter() - t0
    emit("state", games=len(GAMES), envs=STATE_ENVS, steps=[STATE_STEPS, STATE_STEPS],
         card_vs_cpu_bytes_equal=True, resumed_bitwise=True,
         blob_bytes_per_env_min_max=sizes, card_seconds_per_game=seconds,
         games_seconds=games_s, timed_game="maze", timed_envs=STATE_TIMED_ENVS,
         timed_env_build_s=build_s,
         get_state_ms_per_env=get_s * 1e3 / STATE_TIMED_ENVS,
         set_state_ms_per_env=set_s * 1e3 / STATE_TIMED_ENVS,
         blob_bytes_total=sum(len(b) for b in blobs))


def phase_render_mode(dev, worker):
    """render_mode="rgb_array": the card's ms per get_info (the 512x512
    info-frame batch) over 5 steps, and the last step's frames equal on the
    card and the CPU (the CPU env runs in the worker process)."""
    refs = {game: worker.submit(cpu_info_frame, game) for game in RENDER_MODE_GAMES}
    out = {}
    for game in RENDER_MODE_GAMES:
        env = ProcgenTorchEnv(4, game, rand_seed=5, device=dev, distribution_mode="hard",
                              render=False, render_mode="rgb_array")
        rs = np.random.RandomState(4)
        card_s = 0.0
        for _ in range(5):
            env.act(_acts(rs, 4))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infos = env.get_info()
            card_s += time.perf_counter() - t0
        got = np.stack([info["rgb"] for info in infos])
        if got.shape != (4, 512, 512, 3) or got.dtype != np.uint8:
            raise AssertionError(f"{game}: info rgb is {got.shape} {got.dtype}")
        if not np.array_equal(got, refs[game].result()):
            raise AssertionError(f"{game}: the card's info frame differs from the CPU's")
        out[game] = dict(get_info_ms=card_s * 1e3 / 5, nonzero_pixel_share=float((got > 0).mean()))
    emit("render_mode", envs=4, steps=5, shape=[4, 512, 512, 3], card_vs_cpu_bitwise=True,
         per_game=out)


def phase_oracle(dev):
    """The observation oracle (plain torch, record by record) against the
    compositor kernel's frames and the static bake on the card, and against
    itself on the CPU: bit for bit, every game."""
    out, seconds = {}, {}
    for game in GAMES:
        t0 = time.perf_counter()
        env = ProcgenTorchEnv(16, game, rand_seed=5, device=dev, distribution_mode="hard",
                              render=False)
        rs = np.random.RandomState(6)
        for _ in range(12):
            env.act(_acts(rs, 16))
        gd, cfg, pack, state = env.gd, env.cfg, env.pack, env.state
        launched = compositor.launches
        frames = fast2.render_frames2(gd, cfg, state, pack)
        if compositor.launches == launched:
            raise AssertionError(f"{game}: render_frames2 did not launch the kernel")
        static = fast2.render_static2(gd, cfg, state, pack)
        obs = oracle.oracle_obs(gd, cfg, state, pack)
        st = oracle.oracle_static(gd, cfg, state, pack)
        host = tree_map(lambda t: t.cpu(), state)
        if not (torch.equal(obs, frames) and torch.equal(st, static)):
            raise AssertionError(f"{game}: the oracle differs from the card's frames")
        if not (torch.equal(oracle.oracle_obs(gd, cfg, host, pack), obs.cpu())
                and torch.equal(oracle.oracle_static(gd, cfg, host, pack), st.cpu())):
            raise AssertionError(f"{game}: the CPU oracle differs from the card's")
        out[game] = int(state.ents.alive.sum(1).max())
        seconds[game] = time.perf_counter() - t0
    emit("oracle", games=len(GAMES), envs=16, steps=12, bitwise_equal=True,
         max_live_entities=out, seconds_per_game=seconds)


# the ref_parity phase: every game in parity mode on the card against the
# reference binary (hard, seed 23), and the two cases that first showed a
# fault of the port (plunder's spawn row, starpilot's append order), in
# REF_WORKERS spawned processes beside the oracle phase (the step is
# host-bound), the longest cases first
REF_ENVS, REF_STEPS, REF_SEED = 16, 40, 23
REF_WITNESSES = (("plunder", 2, 60, 1), ("starpilot", 2, 360, 7))
# the longest cases on the card: leaper's resets, the starpilot witness,
# miner's gravity sweep
REF_FIRST = (("leaper", REF_ENVS, REF_STEPS, REF_SEED), REF_WITNESSES[1],
             ("miner", REF_ENVS, REF_STEPS, REF_SEED))
REF_WORKERS = 3


def card_ref_parity(dev, binary, game, num_envs, steps, seed):
    """One case of the ref_parity phase, in a worker process (one torch
    thread: the host's share of each step is small ops)."""
    torch.set_num_threads(1)
    return ref_parity.check_game(binary, os.path.dirname(binary), game, num_envs, steps, seed,
                                 "hard", device=dev)


def phase_ref_parity(dev, tmp, beside):
    """The port in parity mode on the card against fresh dumps of the
    reference binary (a copy reading this run's asset root): state bytes,
    rewards, first flags and info ints at the reset and after every step;
    each dump deleted after use.  A binary that cannot run fails the
    phase.  The cases run in worker processes while ``beside()`` runs in
    this one."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    binary = str(ref_parity.patched_binary(tmp, assets.asset_root()))
    cases = list(REF_WITNESSES) + [(g, REF_ENVS, REF_STEPS, REF_SEED) for g in GAMES]
    cases = list(REF_FIRST) + [c for c in cases if c not in REF_FIRST]
    with ProcessPoolExecutor(max_workers=REF_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(card_ref_parity, dev, binary, *c) for c in cases]
        beside()
        recs = [f.result() for f in futures]
    bad = [r for r in recs if not r["ok"]]
    emit("ref_parity", cases=len(recs), bitwise_equal=not bad, workers=REF_WORKERS,
         per_case={f"{r['game']}-{r['rand_seed']}": dict(
             envs=r["num_envs"], steps=r["steps"], ok=r["ok"], replay_s=r["replay_s"],
             dump_mb=r["dump_mb"]) for r in recs},
         seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError("ref_parity: " + "; ".join(
            f"{r['game']} seed {r['rand_seed']}: {r['diff']}" for r in bad))


# the bench phase: the port's benchmark entry point as a user runs it
BENCH_GAME, BENCH_ENVS, BENCH_CHUNK, BENCH_CHUNKS = "maze", 4096, 8, 1


def start_bench_cli(dev):
    """``python -m procgen_torch.bench_cli`` on BENCH_GAME, started in a
    subprocess (it runs beside the ref_parity and oracle phases)."""
    cmd = [sys.executable, "-m", "procgen_torch.bench_cli", "--games", BENCH_GAME,
           "--num-envs", str(BENCH_ENVS), "--chunk", str(BENCH_CHUNK),
           "--chunks", str(BENCH_CHUNKS), "--device", str(dev)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return types.SimpleNamespace(proc=proc, cmd=cmd)


def phase_bench(dev, cli):
    """The bench CLI's one JSON line (``cli``: ``start_bench_cli``), whose
    checksum the same loop run here repeats; the compositor's launches
    counted from 0 just before the loop here and read just after (one per
    frame, warm-up chunk included).  Returns the bench path's ``per_path``
    record."""
    stdout, stderr = cli.proc.communicate(timeout=900)
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    if cli.proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench: exit {cli.proc.returncode}, {len(lines)} JSON lines: "
                             f"{stderr[-1500:]}")
    line = lines[0]
    compositor.launches = 0  # counts start here: the bench path's run
    run = throughput.bench_game(BENCH_GAME, BENCH_ENVS, BENCH_CHUNK, BENCH_CHUNKS, device=dev)
    torch.cuda.synchronize()
    launches = compositor.launches  # counts read here
    frames = BENCH_CHUNK * (BENCH_CHUNKS + 1)
    if launches != passes(run.gd) * frames:
        raise AssertionError(f"bench: compositor launches {launches} != {frames} frames")
    here = run.record
    if line["checksum"] != {BENCH_GAME: here["checksum"]}:
        raise AssertionError(f"bench: checksum {line['checksum']} != {here['checksum']} here")
    run.game = f"bench-{BENCH_GAME}"
    phase_final_frames(run, dev)
    kern = kernel_timing(run)
    emit("bench", command=cli.cmd[1:], line=line, in_process_checksum=here["checksum"],
         checksum_repeats=True, launches=launches, frames=frames,
         kernel_device_ms=kernel_device_ms(run), kernel_ms=kern["kernel_ms"])
    return dict(path_record(kern, launches, run.err), assets="png")


# the train phase: the trainer's CLI at full width (its defaults: coinrun
# easy, 256 envs, 256-step rollouts, 8 minibatches of 8,192, 3 epochs, the
# bf16 IMPALA CNN at depths (16, 32, 32)) for TRAIN_ITERS iterations
TRAIN_GAME, TRAIN_MODE, TRAIN_ENVS, TRAIN_STEPS, TRAIN_ITERS = "coinrun", "easy", 256, 256, 2
TRAIN_ARGS = [TRAIN_GAME, "--distribution-mode", TRAIN_MODE, "--num-envs", str(TRAIN_ENVS),
              "--n-steps", str(TRAIN_STEPS), "--iters", str(TRAIN_ITERS)]
# card against CPU on one minibatch of the last rollout, each error taken
# relative to the largest magnitude of the CPU's float32 result.  The
# float32 net (TF32 off): within 1e-4 on the logits (H100, 700 W: 8.2e-7)
# and 3e-3 on each gradient tensor, card against CPU and each against a
# float64 copy of the net on the CPU.  NVIDIA H100 80GB HBM3, 700 W:
# card against CPU at most 9.94e-4 (seqs.1.res0.conv0.weight); against
# float64 the card 1.29e-3 and the CPU 1.25e-3, both on
# seqs.1.res1.conv0.weight: float32's own error on that tensor, neither
# side at fault, so two float32 results may differ by twice it (the
# limit was 1e-2 until the float64 pass read this).  The trained bf16 net
# on the card within 0.05 of the float32 CPU logits (6.4 bf16 eps; H100,
# 700 W: 0.53%).
F32_LOGITS_TOL, F32_GRAD_TOL, BF16_LOGITS_TOL = 1e-4, 3e-3, 0.05


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|, on the host."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=torch.finfo(torch.float32).tiny))


def net_pass(d, dtype, state, ppo, mb):
    """The net with parameters ``state`` in ``dtype`` on device ``d`` over
    one minibatch (its floats in ``dtype``): the logits and each
    parameter's gradient of ``loss_fn``."""
    net = ImpalaCNN(dtype=dtype, device=d)
    net.load_state_dict(state)
    net.to(dtype)
    outs = []

    def recording(obs):
        outs.append(net(obs))
        return outs[-1]

    batch = [x.to(d, dtype) if x.is_floating_point() else x.to(d) for x in mb]
    loss, _ = learn_ppo.loss_fn(recording, ppo, batch)
    loss.backward()
    return outs[0][0].detach(), {k: p.grad for k, p in net.named_parameters()}


def f64_net_pass(state, ppo, mb):
    """The train phase's float64 reference, on the CPU in the worker
    process."""
    torch.set_num_threads(CPU_WORKER_THREADS)
    return net_pass("cpu", torch.float64, state, ppo, mb)


def phase_train(dev, worker):
    """``procgen_torch.learn.train.main`` for TRAIN_ITERS iterations at full
    width, with wrappers of ``ppo.rollout`` and ``ppo.update`` that keep
    the first parameters, the last state and the last batch; the compositor's
    launches counted from 0 just before and read just after (one per
    rendered frame: n_steps + 1 per iteration); then the kernel against its
    plain version at the last rollout's final frame, and the net card
    against CPU on one minibatch, and each against a float64 pass in the
    worker process.  Returns ``finish``, which waits for that pass, checks
    and emits the phase and returns the train path's ``per_path``
    record."""
    rec = {}
    rollout, update = learn_ppo.rollout, learn_ppo.update

    def kept_rollout(net, *args):
        rec.setdefault("params0", [p.detach().clone() for p in net.parameters()])
        out = rollout(net, *args)
        rec["fs"] = out[0]
        return out

    def kept_update(ts, ppo, batch, gen, *mesh):
        rec.update(ts=ts, ppo=ppo, batch=batch)
        return update(ts, ppo, batch, gen, *mesh)

    printed = io.StringIO()
    learn_ppo.rollout, learn_ppo.update = kept_rollout, kept_update
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        compositor.launches = 0  # counts start here: the train path's run
        with contextlib.redirect_stdout(printed):
            rc = train.main(TRAIN_ARGS)
        torch.cuda.synchronize()
        launches = compositor.launches  # counts read here
        peak = torch.cuda.max_memory_allocated()
    finally:
        learn_ppo.rollout, learn_ppo.update = rollout, update
    iters = [json.loads(line) for line in printed.getvalue().splitlines()]
    frames = TRAIN_ITERS * (TRAIN_STEPS + 1)
    if rc != 0 or len(iters) != TRAIN_ITERS:
        raise AssertionError(f"train: exit {rc}, {len(iters)} logged iterations")
    if launches != frames:
        raise AssertionError(f"train: compositor launches {launches} != {frames} frames")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["entropy"]) for m in iters):
        raise AssertionError(f"train: non-finite loss or entropy: {iters}")
    ts, ppo = rec["ts"], rec["ppo"]
    moved = [not torch.equal(a, b) for a, b in zip(rec["params0"], ts.net.parameters())]
    if not any(moved):
        raise AssertionError("train: no parameter changed")

    # the kernel at the train path's shapes: the last rollout's final state
    cfg = EnvConfig(env_name=TRAIN_GAME, num_envs=TRAIN_ENVS,
                    distribution_mode=DistributionMode[TRAIN_MODE]).resolve_exploration()
    gd = make_game(cfg)
    run = types.SimpleNamespace(game=f"train-{TRAIN_GAME}", gd=gd, cfg=cfg,
                                pack=RenderPack(gd, cfg), fs=rec["fs"])
    phase_final_frames(run, dev)
    kern = kernel_timing(run)
    # at 256 envs the event-timed loop measures the host's launches: the
    # path's time is the kernel's device time in a profiler window
    kern.update(kernel_event_ms=kern["kernel_ms"], kernel_ms=kernel_device_ms(run))

    # card against CPU on one minibatch of the last rollout
    mb_size = TRAIN_ENVS * TRAIN_STEPS // ppo.n_minibatches
    mb = [x.reshape((-1,) + x.shape[2:])[:mb_size] for x in rec["batch"]]
    with torch.no_grad():
        bf16_logits = ts.net(mb[0])[0]
    state = {k: v.cpu() for k, v in ts.net.state_dict().items()}
    t0 = time.perf_counter()
    # the float64 reference of both float32 sides runs in the worker
    # process, beside the phases that follow (``finish`` reads it)
    f64 = worker.submit(f64_net_pass, state, ppo, [x.cpu() for x in mb])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        (card_logits, card_grads), (cpu_logits, cpu_grads) = (
            net_pass(d, torch.float32, state, ppo, mb) for d in (dev, "cpu"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check_s = time.perf_counter() - t0

    def worst(grads, ref):
        return sorted(((rel_err(grads[k], b), k) for k, b in ref.items()), reverse=True)

    grad_errs = worst(card_grads, cpu_grads)

    def finish():
        t1 = time.perf_counter()
        f64_logits, f64_grads = f64.result()
        waited_s = time.perf_counter() - t1
        vs_f64 = dict(card_grads=worst(card_grads, f64_grads)[:3],
                      cpu_grads=worst(cpu_grads, f64_grads)[:3],
                      card_logits=rel_err(card_logits, f64_logits),
                      cpu_logits=rel_err(cpu_logits, f64_logits))
        errs = dict(f32_logits=rel_err(card_logits, cpu_logits), f32_grads=grad_errs[0][0],
                    card_vs_f64_grads=vs_f64["card_grads"][0][0],
                    cpu_vs_f64_grads=vs_f64["cpu_grads"][0][0],
                    bf16_logits=rel_err(bf16_logits, cpu_logits))
        tols = dict(f32_logits=F32_LOGITS_TOL, f32_grads=F32_GRAD_TOL,
                    card_vs_f64_grads=F32_GRAD_TOL, cpu_vs_f64_grads=F32_GRAD_TOL,
                    bf16_logits=BF16_LOGITS_TOL)
        if not all(errs[k] <= tols[k] for k in errs):  # NaN fails too
            raise AssertionError(f"train: card against CPU beyond tolerance: {errs} "
                                 f"(limits {tols}); each against float64: {vs_f64}")
        emit("train", game=TRAIN_GAME, mode=TRAIN_MODE, args=TRAIN_ARGS, num_envs=TRAIN_ENVS,
             n_steps=TRAIN_STEPS, n_minibatches=ppo.n_minibatches, minibatch=mb_size,
             n_epochs=ppo.n_epochs, net_dtype=str(ts.net.dtype),
             params=sum(p.numel() for p in ts.net.parameters()),
             launches=launches, frames=frames, kernel_ms=kern["kernel_ms"],
             plain_ms=kern["plain_ms"], bound_ms=kern["bound_ms"], records=kern["records"],
             kmax=kern["kmax"], drawn_records=kern["drawn_records"],
             max_memory_allocated=peak, loss_entropy_finite=True,
             params_changed=f"{sum(moved)}/{len(moved)}", card_vs_cpu_rel_err=errs,
             card_vs_cpu_tol=tols, card_vs_cpu_worst_grads=grad_errs[:3], card_vs_cpu_s=check_s,
             f64_waited_s=waited_s,
             each_vs_f64_rel_err=vs_f64, kernel_event_ms=kern["kernel_event_ms"],
             iterations=iters)
        return dict(path_record(kern, launches, run.err), assets="png")

    return finish


# the sharded phase: (1) the dryrun over one NCCL rank on the card against
# the same steps with no group; (2) two ranks sharing the card over gloo
# (NCCL refuses two ranks on one GPU) on maze easy and dodgeball hard at
# SHARDED_ENVS global envs, a refill bucket smaller than a shard, with
# deaths staged unevenly across the ranks: 160 envs of rank 0 time out at
# step 2 (their queue slots left empty), 40 envs of rank 1 are reset at
# steps 4 and 5 (at 5 with empty slots, so the global bucket also takes
# rank 0's) and 100 of rank 0 at step 8 (more than a bucket); (3) one
# data-parallel training iteration at the trainer's width over the same two
# ranks (coinrun easy, 256 global envs, n_steps cut to 32).
SHARDED_RANKS, SHARDED_ENVS, SHARDED_BUCKET, SHARDED_STEPS = 2, 512, 64, 20
SHARDED_JOBS = [dict(env_name=g, mode=m, num_envs=SHARDED_ENVS, steps=SHARDED_STEPS,
                     refill_bucket=SHARDED_BUCKET, action_seed=11,
                     deaths=tuple((e, 2) for e in range(160)),
                     resets=tuple((t, e) for t in (4, 5) for e in range(300, 340))
                     + tuple((8, e) for e in range(100)))
                for g, m in (("maze", "easy"), ("dodgeball", "hard"))]
DP_ENVS, DP_STEPS = 256, 32


def sync(dev):
    """Wait for the card (nothing on the CPU, where a rank of the sharded
    phase runs when it is rehearsed)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed_collectives(rec: dict, dev):
    """Wrap ``sharding.all_reduce`` and ``sharding.broadcast`` (read at call
    time by their callers) to add each call's synchronized host seconds to
    ``rec["comm_s"]``; returns the function that restores them."""
    from procgen_torch.parallel import sharding

    saved = sharding.all_reduce, sharding.broadcast

    def timed(fn):
        def call(t, mesh, *args):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(t, mesh, *args)
            sync(dev)
            rec["comm_s"] += time.perf_counter() - t0
            rec["comm_calls"] += 1
            return out
        return call

    rec.update(comm_s=0.0, comm_calls=0)
    sharding.all_reduce, sharding.broadcast = timed(saved[0]), timed(saved[1])

    def restore():
        sharding.all_reduce, sharding.broadcast = saved

    return restore


def dp_iteration(dev, mesh=None, num_envs=DP_ENVS, n_steps=DP_STEPS) -> dict:
    """One training iteration of the trainer's learner at ``num_envs``
    global envs (coinrun easy, PNG assets, ``n_steps``; this rank's rows
    under ``mesh``), timed on the host with the card synchronized, its
    collectives timed, the compositor's launches counted from 0 just before
    and read just after; then the float32 net's gradient (TF32 off) of the
    loss over the rollout's first step of every env (under ``mesh`` each
    rank's share, summed over the ranks).  Returns numpy: the global
    actions, the parameters, the gradient, that batch (gathered), metrics
    and times."""
    from procgen_torch.parallel import sharding

    cfg = EnvConfig(env_name=TRAIN_GAME, num_envs=num_envs,
                    distribution_mode=DistributionMode[TRAIN_MODE], rand_seed=0).resolve_exploration()
    env = train.make_env(cfg, dev, mesh=mesh)
    ppo = learn_ppo.PPOConfig(n_steps=n_steps)
    init_ts, train_iter, _ = learn_ppo.make_train_fns(env.gd, cfg, env.pack, ppo, env.fast_step,
                                                      env.render_fn, dev, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ts = init_ts(gen)
    ep_acc = torch.zeros((env.fs.queue_valid.shape[0],), dtype=torch.float32, device=dev)
    rec = {}
    rollout = learn_ppo.rollout

    def keep(*args):
        out = rollout(*args)
        rec["traj"], rec["last_value"] = out[1], out[2]
        return out

    restore = timed_collectives(rec, dev)
    learn_ppo.rollout = keep
    try:
        compositor.launches = 0  # counts start here: the iteration's run
        sync(dev)
        t0 = time.perf_counter()
        ts, fs, ep_acc, metrics = train_iter(ts, env.fs, gen, ep_acc)
        sync(dev)
        iter_s = time.perf_counter() - t0
        launches = compositor.launches  # counts read here
    finally:
        learn_ppo.rollout = rollout
        restore()
    traj = rec["traj"]
    adv, ret = learn_ppo.gae(ppo, traj.reward, traj.value, traj.done, rec["last_value"],
                             fs.state.done)
    batch = (traj.obs, traj.action, traj.logp, traj.value, adv, ret)
    T, n = traj.action.shape
    flat = [x.reshape((T * n,) + x.shape[2:]) for x in batch]
    # the gradient's batch: the rollout's first step over every env (a
    # quarter of a minibatch, for the float64 pass's time), as the first of
    # T minibatches in batch order: this rank's entries of it, and the
    # global batch gathered from the ranks
    order = torch.arange(T * num_envs, device=dev)
    if mesh is None:
        idx, stats = order[:num_envs], None
    else:
        mbs, st = learn_ppo.local_minibatches(order, flat[4], n, mesh, T, num_envs)
        idx, stats = mbs[0], st[0]
    global_mb = [x[0] for x in batch]
    if mesh is not None:
        global_mb = sharding.gather_rows(global_mb, mesh)
    net = ImpalaCNN(dtype=torch.float32, device=dev)
    net.load_state_dict(ts.net.state_dict())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss, _ = learn_ppo.loss_fn(net, ppo, [x[idx] for x in flat], stats)
        loss.backward()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    names = [k for k, _ in net.named_parameters()]
    grad = torch.cat([p.grad.reshape(-1) for p in net.parameters()])
    actions = traj.action.T.contiguous()
    if mesh is not None:
        sharding.all_reduce(grad, mesh)
        (actions,) = sharding.gather_rows([actions], mesh)
    grads = dict(zip(names, torch.split(grad, [p.numel() for p in net.parameters()])))
    return dict(
        iter_s=iter_s, comm_s=rec["comm_s"], comm_calls=rec["comm_calls"], launches=launches,
        metrics={k: float(v) for k, v in metrics.items()},
        actions=actions.cpu().numpy(), checksum=learn_ppo.param_checksum(ts.net).cpu().numpy(),
        params={k: v.detach().cpu() for k, v in ts.net.state_dict().items()},
        grads={k: v.reshape(p.shape).cpu() for (k, v), p in zip(grads.items(), net.parameters())},
        mb=[x.cpu() for x in global_mb], ppo=ppo)


def warm_up(dev, games):
    """A rank's one-time costs outside the timed work: the games' PNG
    decodes (cached per process), the compositor's library and cuDNN's
    first convolutions."""
    for game, mode in games:
        cfg = EnvConfig(env_name=game, num_envs=1, distribution_mode=DistributionMode[mode])
        RenderPack(make_game(cfg), cfg)
    net = ImpalaCNN(device=dev)
    net(torch.zeros((2, 64, 64, 3), dtype=torch.uint8, device=dev))[0].sum().backward()
    sync(dev)


def sharded_rank(rank: int, world: int, init_method: str, out_dir: str, device: str, jobs,
                 dp_envs: int, dp_steps: int, epoch: float):
    """A rank of the sharded phase's parts (2) and (3) on ``device`` (every
    rank on the same card): once the parent's references are done (the
    file ``go`` in ``out_dir``), the ``run_steps`` jobs, then the
    iteration; its rank record in ``out_dir`` (the global runs and the
    iteration on rank 0, and its timeline in seconds since ``epoch``)."""
    from procgen_torch import entry
    from procgen_torch.parallel import sharding

    timeline = dict(started=time.time() - epoch)
    mesh = sharding.init_distributed(init_method, world, rank, device=device, backend="gloo")
    try:
        timeline["joined"] = time.time() - epoch
        warm_up(mesh.device, [(j["env_name"], j["mode"]) for j in jobs] + [(TRAIN_GAME, TRAIN_MODE)])
        timeline["warm"] = time.time() - epoch
        while not os.path.exists(os.path.join(out_dir, "go")):
            time.sleep(0.05)
        timeline["go"] = time.time() - epoch
        runs = []
        for job in jobs:
            runs.append(digested(entry.run_steps(**job, mesh=mesh)))
            timeline[job["env_name"]] = time.time() - epoch
        dp = dp_iteration(mesh.device, mesh, dp_envs, dp_steps)
        timeline["dp"] = time.time() - epoch
    finally:
        torch.distributed.destroy_process_group()
    record = dict(launches=[r.pop("launches") for r in runs] + [dp["launches"]],
                  checksum=dp["checksum"], timeline=timeline, runs=runs if rank == 0 else None,
                  dp=dp if rank == 0 else None)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(record, f)


def digested(run: dict) -> dict:
    """A ``run_steps`` record with its states at every step replaced by each
    field's dtype, shape and SHA-256 (``digests``), and the last state kept
    whole (``final``): at 512 envs the states of a run are about 0.6 GB."""
    states = run.pop("states")
    digests = [{k: (a.dtype.str, a.shape, hashlib.sha256(np.ascontiguousarray(a).data).hexdigest())
                for k, a in state.items()} for state in states]
    return dict(run, digests=digests, final=states[-1])


def runs_equal(want: dict, got: dict, what: str):
    """Two ``run_steps`` records bit for bit: rewards, dones, frames, every
    field of the state at every step (by digest) and the last state."""
    for k in ("reward", "done", "frames"):
        if not np.array_equal(want[k], got[k]):
            raise AssertionError(f"sharded: {what}: {k} differ from one process")
    for t, (a, b) in enumerate(zip(want["digests"], got["digests"], strict=True)):
        for k in a:
            if a[k] != b[k]:
                raise AssertionError(f"sharded: {what}: {k} differs from one process at step {t}")
    for k, a in want["final"].items():
        b = got["final"][k]
        if a.dtype != b.dtype or not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
            raise AssertionError(f"sharded: {what}: {k} differs from one process at the end")


def phase_sharded(dev, worker):
    """The env axis over processes (procgen_torch/parallel/sharding.py):
    (1) ``entry.dryrun_multichip(1)``, one NCCL rank, against the same
    steps with no group; (2) SHARDED_JOBS over two gloo ranks sharing the
    card against one process (states at every step, rewards, dones and
    frames bit for bit), each rank's sharded step timed; (3) one
    data-parallel iteration over the two ranks: the replicas' parameters
    bitwise equal, losses finite, the summed float32 gradient of a batch
    against a float64 pass on the CPU (in the worker) within F32_GRAD_TOL,
    the iteration's time and its collectives' share; reported, not gated:
    the largest relative parameter difference from the one-process
    iteration and the count of differing actions (bf16 convolutions over
    128 and 256 observations may take different cuDNN algorithms).  Returns
    the sharded path's ``per_path`` record: every rank's compositor
    launches, and the kernel against plain and timed at a rank's shapes
    (maze's final state, rank 0's rows)."""
    from procgen_torch import entry
    from procgen_torch.parallel import sharding

    on_card = torch.device(dev).type == "cuda"
    epoch = time.time()
    timeline, refs = {}, {}

    def references(go: str):
        """The one-process references of (1) and (2) while the ranks start
        (they wait for ``go``), beside (1) in a thread (its one NCCL rank's
        work is a few small steps)."""
        def dryrun():
            try:
                refs["dry"] = entry.dryrun_multichip(1, dev)
            except BaseException as e:  # re-raised in this thread below
                refs["dry_error"] = e

        th = threading.Thread(target=dryrun)
        th.start()
        refs["runs"] = [digested(entry.run_steps(**job, device=dev)) for job in SHARDED_JOBS]
        timeline["references"] = time.time() - epoch
        refs["dry_refs"] = [digested(entry.run_steps(**job, device=dev))
                            for job in entry.dryrun_jobs(1)]
        th.join()
        timeline["dryrun"] = time.time() - epoch
        if "dry_error" in refs:
            raise refs["dry_error"]
        open(go, "w").close()

    with tempfile.TemporaryDirectory(prefix="procgen_sharded_") as tmp:
        sharding.spawn_ranks(sharded_rank, SHARDED_RANKS, tmp,
                             (tmp, "cuda:0" if on_card else dev, SHARDED_JOBS, DP_ENVS, DP_STEPS,
                              epoch), timeout=300,
                             beside=lambda: references(os.path.join(tmp, "go")))
        ranks = []
        for r in range(SHARDED_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:  # written by our ranks
                ranks.append(pickle.load(f))
    timeline["ranks"] = [r["timeline"] for r in ranks]
    timeline["ranks_done"] = time.time() - epoch
    # (1): the dryrun's one NCCL rank against the same steps with no group
    dry = refs["dry"]
    for job, got, want in zip(entry.dryrun_jobs(1), dry["runs"], refs["dry_refs"]):
        runs_equal(want, digested(got), f"dryrun {job['env_name']}")
    launches = sum(sum(r) for r in dry["launches"]) + sum(sum(r["launches"]) for r in ranks)
    # (2)
    runs, dp = ranks[0]["runs"], ranks[0]["dp"]
    # the float64 pass in the worker beside the one-process iteration
    f64 = worker.submit(f64_net_pass, dp["params"], dp["ppo"], dp["mb"])
    one = dp_iteration(dev, None, DP_ENVS, DP_STEPS)
    timeline["dp_reference"] = time.time() - epoch
    steps = {}
    for job, got, want in zip(SHARDED_JOBS, runs, refs["runs"]):
        runs_equal(want, got, f"{job['env_name']} over {SHARDED_RANKS} ranks")
        steps[job["env_name"]] = dict(
            sharded_step_ms=float(np.median(got["step_s"])) * 1e3,
            one_process_step_ms=float(np.median(want["step_s"])) * 1e3,
            episodes_ended=int(got["done"].sum()))
    # (3)
    if any(not np.array_equal(r["checksum"], ranks[0]["checksum"]) for r in ranks):
        raise AssertionError("sharded: the ranks' parameters differ")
    if not all(np.isfinite(m["loss"]) and np.isfinite(m["entropy"]) for m in (dp["metrics"],)):
        raise AssertionError(f"sharded: non-finite loss or entropy: {dp['metrics']}")
    _, f64_grads = f64.result()
    grad_errs = sorted(((rel_err(dp["grads"][k], b), k) for k, b in f64_grads.items()), reverse=True)
    if not grad_errs[0][0] <= F32_GRAD_TOL:  # NaN fails too
        raise AssertionError(f"sharded: data-parallel gradient vs float64 {grad_errs[:3]}")
    param_diff = max((rel_err(dp["params"][k], v), k) for k, v in one["params"].items())
    param_abs = max(float((dp["params"][k] - v).abs().max()) for k, v in one["params"].items())
    differing = int((dp["actions"] != one["actions"]).sum())

    # the kernel at a rank's shapes: rank 0's rows of maze's final state
    job = SHARDED_JOBS[0]
    cfg = EnvConfig(env_name=job["env_name"], num_envs=job["num_envs"],
                    distribution_mode=DistributionMode[job["mode"]], rand_seed=entry.SEED)
    gd = make_game(cfg)
    glob = convert.fast_state_from_numpy(runs[0]["final"], dev)
    mesh0 = sharding.EnvMesh(0, SHARDED_RANKS, torch.device(dev))
    run = types.SimpleNamespace(game="sharded-maze-easy", gd=gd, cfg=cfg, pack=RenderPack(gd, cfg),
                                fs=sharding.shard_env_state(glob, mesh0))
    phase_final_frames(run, dev)
    kern = kernel_timing(run)
    timeline["end"] = time.time() - epoch
    emit("sharded", nvidia_smi=card_line() if on_card else "not a card", ranks=SHARDED_RANKS,
         backend="gloo, one card",
         dryrun=dict(ranks=1, backend="nccl", games=[j["env_name"] for j in entry.dryrun_jobs(1)],
                     bitwise_vs_no_group=True, launches=dry["launches"]),
         global_envs=SHARDED_ENVS, refill_bucket=SHARDED_BUCKET, steps=SHARDED_STEPS,
         bitwise_vs_one_process=True, per_game=steps, timeline=timeline,
         dp=dict(game=TRAIN_GAME, mode=TRAIN_MODE, global_envs=DP_ENVS, n_steps=DP_STEPS,
                 iter_s=dp["iter_s"], one_process_iter_s=one["iter_s"],
                 all_reduce_s=dp["comm_s"], collectives=dp["comm_calls"],
                 all_reduce_share=dp["comm_s"] / dp["iter_s"], replicas_bitwise=True,
                 grad_vs_f64_worst=grad_errs[:3], grad_tol=F32_GRAD_TOL,
                 max_rel_param_diff_vs_one_process=param_diff,
                 max_abs_param_diff_vs_one_process=param_abs,
                 differing_actions_vs_one_process=differing, actions=int(dp["actions"].size),
                 metrics=dp["metrics"]),
         launches=launches, kernel_ms=kern["kernel_ms"], plain_ms=kern["plain_ms"],
         bound_ms=kern["bound_ms"], seconds=time.time() - epoch)
    return dict(path_record(kern, launches, run.err), assets="png")


def mazegen_kernels(cases: dict, paths: dict) -> list:
    """The maze kernels' entries of the kernels line: the times of the first
    of MAZEGEN_CASES at the top, every case's and each main path's launches
    in ``per_path``.  A refill pass launches ``generate_kernel`` once on
    every path in MAZEGEN_PER_PASS and ``place_kernel`` once on maze (the
    main path checked their sum)."""
    first = cases[f"{MAZEGEN_CASES[0][0]}x{MAZEGEN_CASES[0][1]}"]
    out = []
    for name, kernel, part, nth in (("generate_maze", "generate_kernel", "generate", 1),
                                    ("place_objects", "place_kernel", "place", 2)):
        on_path = {p: dict(launches=r["refill_passes"] * (r["launches_per_pass"] >= nth),
                           refill_passes=r["refill_passes"]) for p, r in paths.items()}
        out.append({
            "name": name,
            "kernel": kernel,
            "route": "cuda",
            "source": "procgen_torch/csrc/mazegen.cu",
            "replaces": None,  # the JAX package ran this loop under jit
            "tpu_source": None,
            "launches": sum(p["launches"] for p in on_path.values()),
            "bitwise_equal": True,
            "max_abs_err": 0,
            "ms": first[part]["kernel_ms"],
            "plain_ms": first[part]["plain_ms"],
            "bound_ms": first[part]["bound_ms"],
            "bound_by": first[part]["bound_by"],
            "library_ms": None,
            "per_path": {**{c: dict(ms=t[part]["kernel_ms"], plain_ms=t[part]["plain_ms"],
                                    bound_ms=t[part]["bound_ms"], bound_by=t[part]["bound_by"],
                                    chain_ms=t[part]["chain_ms"],
                                    bytes_bound_ms=t[part]["bytes_bound_ms"],
                                    records=t[part]["records"])
                            for c, t in cases.items()}, **on_path},
        })
    return out


def miner_sweep_kernel(cases: dict, launches: int) -> dict:
    """The sweep kernel's entry of the kernels line: the hard case's times
    at the top, every case's in ``per_path``; ``launches`` is the miner
    main path's (one a step)."""
    hard = cases[f"{N_ENVS}x20"]
    return {
        "name": "gravity_sweep",
        "kernel": "sweep_kernel",
        "route": "cuda",
        "source": "procgen_torch/csrc/miner_sweep.cu",
        "replaces": None,  # the JAX package ran this loop as a fori_loop under jit
        "tpu_source": None,
        "launches": launches,
        "bitwise_equal": True,
        "max_abs_err": 0,
        **{k: hard[k] for k in ("plain_ms", "bound_ms", "bound_by")},
        "ms": hard["kernel_ms"],
        "library_ms": None,
        "per_path": cases,
    }


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
    emit("build", libraries={n: {"seconds": r["seconds"], "ptxas": [
        ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]}
        for n, r in built.items()}, compositor_blocks_per_sm=compositor.blocks_per_sm())

    tmp = tempfile.mkdtemp(prefix="procgen_assets_")  # synthetic roots
    try:
        phase_assets(tmp)
        phase_kernels_vs_plain(dev)
        phase_kernels_vs_plain_fractional(dev, tmp)
        maze_cases = phase_mazegen_vs_plain(dev)
        sweep_cases = phase_miner_sweep_vs_plain(dev, [
            ln.strip() for ln in built["miner_sweep"]["log"].splitlines()
            if "sweep_kernel" in ln or "registers" in ln or "spill" in ln])
        phase_trig(dev)
        per_path, maze_paths, sweep_launches = {}, {}, 0
        with cpu_worker() as worker:
            for game, mode, steps, generated in PATHS:
                phase_card_vs_cpu(dev, game, mode, worker, generated)
                run = phase_main_path(dev, game, mode, steps, generated)
                if game in MAZEGEN_PER_PASS:
                    maze_paths[f"{game}-{mode}"] = run.mazegen
                if game == "miner":
                    sweep_launches = run.sweep_launches
                phase_final_frames(run, dev)
                per_path[f"{game}-{mode}"] = dict(phase_timing(run),
                                                  assets=asset_kind(generated))
                del run
                torch.cuda.empty_cache()
            for game, mode in PNG_CARD_VS_CPU:
                phase_card_vs_cpu(dev, game, mode, worker, generated=False)
            phase_env(dev)
            phase_state(dev, worker)
            phase_render_mode(dev, worker)
            per_path["sharded"] = phase_sharded(dev, worker)
            finish_train = phase_train(dev, worker)
            cli = start_bench_cli(dev)
            phase_ref_parity(dev, tmp, beside=lambda: phase_oracle(dev))
            per_path[f"bench-{BENCH_GAME}-hard"] = phase_bench(dev, cli)
            per_path[f"train-{TRAIN_GAME}-{TRAIN_MODE}"] = finish_train()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
    }] + mazegen_kernels(maze_cases, maze_paths)
        + [miner_sweep_kernel(sweep_cases, sweep_launches)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
