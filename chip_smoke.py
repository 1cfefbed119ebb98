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
3. the double cos/sin of a float angle (caveflyer's ship), ``fmath.dsincos``:
   on 2^24 float32 angles in [-300, 300] the card's bits against the CPU's
   (must be equal), and the count of angles where torch's own float64
   cos/sin, narrowed, differ between the two; glibc's ``atan2f`` as float32
   ops (``fmath.atan2f``, starpilot's aimed bullets) and the correctly
   rounded square root (``fmath.sqrt32``) on 2^22 inputs, card against CPU
   (must be equal);
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
      versions the CPU tests hold against the JAX package): 8 envs, 40
      steps with forced resets, every state field and frame
      bitwise equal; bossfight's levels staged so that the boss takes hits
      and rounds are won (its random agents never reach the boss in 40
      steps); also coinrun (center-agent) and maze (static) in the PNG
      configuration;
   b. the main path: 4096 envs, refill bucket 512, seed 123, generated
      assets on the nine earliest paths and PNG assets from the asset root
      on the seven asset games: cold start, then 10 warm-up and 100 timed
      rendered steps with random actions on fruitbot, plunder, starpilot
      and bossfight, 50 on bigfish, climber, heist, caveflyer and
      dodgeball, 20 on the seven earliest paths (leaper 5: its resets
      pre-roll 300 physics steps); the kernel's
      launches counted from 0 just before and read just after (launches ==
      frames, or 2 x frames for grid-dynamic games), frames not black;
   c. the final frames through the kernel and through the plain version,
      in each z pass, bitwise equal, each pass's input canvas >= +0 (the
      kernel skips pixels outside a record's box, which is exact only
      without -0.0), and render_frames2 equal to the kernel's canvas with
      the velocity patch and the HUD painted over it;
   d. timing (CUDA events / synchronized host clock): env-steps/s, the
      kernel's ms per launch at the path's shapes beside its plain version
      and its bound, the step's split (game step, refill, frame; miner's
      gravity sweep; leaper's pre-roll; jumper's cell scans and path
      search; reposition's retries; heist's maze with doors; pair
      collisions, the entity-reflect sweep, dodgeball's enemy sweep,
      bigfish's and heist's agent-collision sweeps, starpilot's spawner
      timeline, bossfight's barrier sweep), torch ops per refill
      from one
      profiled refill at the bucket size, and device time by kernel from a
      short profiler window;
5. the gym3 surface in its default configuration (PNG assets):
   ``ProcgenTorchEnv(..., device="cuda")`` on miner and
   ``ProcgenTorchEnv(64, "bigfish")`` (the card by default), a few
   act/observe rounds each with the state on the card.

The asset root: ``PROCGEN_TORCH_ASSET_ROOT`` when it is set (the script
prints which root it used), else a synthetic root
(``procgen_torch.bench.synth_assets``) written into a temporary directory
at the start; the fractional-alpha root of phase 2 goes there too, and the
directory is removed at the end.

The last three lines are the card's name and power limit, the kernels line,
and ``{"ok": true, "device": {...}}``.  The script needs CUDA; without it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from procgen_torch import convert, cuda_build
from procgen_torch import fmath as fm
from procgen_torch.bench import synth_assets
from procgen_torch.bench.profiling import profiled
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.base import AGENT_SWEEP_SPAN, PAIRS_SPAN
from procgen_torch.engine.entity_ops import REPOSITION_SPAN
from procgen_torch.engine.game import step_env_no_reset
from procgen_torch.engine.levelgen.mazegen import DOORS_SPAN
from procgen_torch.engine.levelgen.roomgen import FIND_PATH_SPAN
from procgen_torch.engine.physics import REFLECT_SPAN
from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.games import bossfight as BF
from procgen_torch.games import make_game
from procgen_torch.games.bossfight import BARRIER_SWEEP_SPAN
from procgen_torch.games.dodgeball import ENEMY_SWEEP_SPAN
from procgen_torch.games.jumper import SCANS_SPAN
from procgen_torch.games.leaper import PREROLL_SPAN
from procgen_torch.games.miner import SWEEP_SPAN
from procgen_torch.games.starpilot import SPAWNERS_SPAN
from procgen_torch.parallel.fast import REFILL_SPAN, make_fast_fns
from procgen_torch.render import assets, compositor, fast2
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
# (game, mode, timed steps, generated assets) of each main path: maze is
# the static-grid class, miner and chaser the grid-dynamic one, coinrun the
# center-agent view with entity push, leaper the static view with tiled and
# rotated sprites, ninja and jumper center-agent views with a HUD,
# caveflyer (a center-agent view) and dodgeball (a static one) with free
# rotation and pair collisions; the seven games that read their sprites'
# aspect ratios from the PNG assets (bigfish, climber, heist, fruitbot,
# plunder, starpilot, bossfight) run in the default configuration, PNG
# assets.  The four newest paths run 100 timed steps; to keep the script's
# time, the earlier ones run fewer than they did when they were new: 50
# (caveflyer, dodgeball, bigfish, climber, heist), 20 (the seven earliest)
# and 5 (leaper: each of its resets pre-rolls 300 physics steps).
PATHS = (
    ("maze", "hard", 20, True), ("miner", "hard", 20, True), ("chaser", "hard", 20, True),
    ("coinrun", "hard", 20, True), ("leaper", "hard", 5, True), ("ninja", "hard", 20, True),
    ("jumper", "hard", 20, True), ("caveflyer", "hard", 50, True),
    ("dodgeball", "hard", 50, True), ("bigfish", "hard", 50, False),
    ("climber", "hard", 50, False), ("heist", "hard", 50, False),
    ("fruitbot", "hard", 100, False), ("plunder", "hard", 100, False),
    ("starpilot", "hard", 100, False), ("bossfight", "hard", 100, False),
)
# earlier games also held card vs CPU in the PNG configuration
PNG_CARD_VS_CPU = (("coinrun", "hard"), ("maze", "hard"))
# the sprite drawn with fractional alpha in the pack-atlas kernel case
FRACTIONAL_SPRITES = ("misc_assets/fishTile_072.png",)
TRIG_ANGLES = 1 << 24


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
REFILL_SPANS = {"preroll": PREROLL_SPAN, "levelgen_scans": SCANS_SPAN,
                "find_path": FIND_PATH_SPAN, "reposition": REPOSITION_SPAN,
                "maze_doors": DOORS_SPAN, "spawners": SPAWNERS_SPAN}
STEP_SPANS = {"pair_collisions": PAIRS_SPAN, "entity_reflect": REFLECT_SPAN,
              "enemy_sweep": ENEMY_SWEEP_SPAN, "agent_sweep": AGENT_SWEEP_SPAN,
              "barrier_sweep": BARRIER_SWEEP_SPAN}
SPANS = (REFILL_SPAN, FRAME_SPAN, SWEEP_SPAN, *REFILL_SPANS.values(), *STEP_SPANS.values())


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
    for name, fn, args in (("fmath.atan2f", fm.atan2f, (y, x)), ("fmath.sqrt32", fm.sqrt32, (s2,))):
        want = fn(*args)
        got = fn(*(a.to(dev) for a in args)).cpu()
        checks[name] = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    torch_sqrt_differ = int((torch.sqrt(s2).view(torch.int32)
                             != torch.sqrt(s2.to(dev)).cpu().view(torch.int32)).sum())
    if any(checks.values()):
        raise AssertionError(f"card results differ from the CPU's: {checks}")
    emit("trig_atan2f_sqrt", inputs=n, card_vs_cpu_differ=checks,
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


def phase_card_vs_cpu(dev, game, mode, generated=True):
    """The port on the card against the port on the CPU, small input, with
    forced resets (action -1) so that levels are swapped in (leaper's CPU
    half pre-rolls 300 physics steps in every reset).  Bossfight's staged
    levels must score: the boss takes hits and rounds are won."""
    n, steps = 8, 40
    cfg = game_cfg(game, mode, n, generated)
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
            if game == "bossfight" and t in BOSSFIGHT_STAGED_STEPS:
                fs = dataclasses.replace(fs, state=stage_bossfight(fs.state))
            acts = torch.as_tensor(a, device=d)
            fs = step(fs, acts)
            frames.append(fast2.render_frames2(gd, cfg, fs.state, pack).cpu())
            states.append(convert.fast_state_to_numpy(fs))
        runs[d] = (frames, states)
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
    emit("card_vs_cpu", game=game, mode=mode, assets=asset_kind(generated), envs=n,
         steps=steps, episodes_ended=dones,
         rewarded_steps=rewards, fields=len(s_cpu[0]), bitwise_equal=True, **staged)


def phase_main_path(dev, game, mode, timed_steps, generated=True):
    steps = WARMUP + timed_steps
    cfg = game_cfg(game, mode, N_ENVS, generated)
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
    first_step_ends = torch.zeros((), dtype=torch.int64, device=dev)  # episodes of 1 step
    reward_sum = torch.zeros((), dtype=torch.float64, device=dev)
    refills = torch.zeros((), dtype=torch.int64, device=dev)  # timed steps only
    for t in range(steps):
        if t == WARMUP:
            torch.cuda.synchronize()
            t_loop = time.perf_counter()
        acts = torch.randint(0, 15, (N_ENVS,), generator=gen, device=dev, dtype=torch.int32)
        valid_before, fresh = fs.queue_valid, fs.state.cur_time == 0
        fs = step(fs, acts)
        first_step_ends += (fs.state.done & fresh).sum()
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
    emit("main_path", game=game, mode=mode, assets=asset_kind(generated), num_envs=N_ENVS,
         steps=steps,
         refill_bucket=BUCKET, pack_build_s=pack_s, cold_start_s=cold_s,
         timed_steps=timed_steps, env_steps_per_s=sps, launches=launches,
         launches_per_frame=passes(gd), frames=frames_rendered,
         episodes_ended=int(episodes), episodes_ended_on_first_step=int(first_step_ends),
         reward_sum=float(reward_sum),
         nonzero_pixel_share=black, checksum=int(checksum))
    refills_per_step = int(refills) / timed_steps
    return types.SimpleNamespace(
        game=game, mode=mode, gd=gd, cfg=cfg, pack=pack, fs=fs, init=init, step=step,
        gen=gen, launches=launches, sps=sps, refills_per_step=refills_per_step,
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
    for name, span in REFILL_SPANS.items():
        if rp["count"][span]:
            extra[f"{name}_profiled_share_of_refill"] = rp["ns"][span] / rp["ns"][REFILL_SPAN]
            extra[f"torch_ops_per_{name}"] = rp["ops"][span] / rp["count"][span]

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
    for name, span in STEP_SPANS.items():
        if span in spans:  # inside the profiled steps, against their wall time
            extra[f"{name}_profiled_share_of_step"] = spans[span] / wall_ns
            extra[f"torch_ops_per_step_in_{name}"] = w["ops"][span] / window
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
        phase_trig(dev)
        per_path = {}
        for game, mode, timed_steps, generated in PATHS:
            phase_card_vs_cpu(dev, game, mode, generated)
            run = phase_main_path(dev, game, mode, timed_steps, generated)
            phase_final_frames(run, dev)
            per_path[f"{game}-{mode}"] = dict(phase_timing(run, dev), assets=asset_kind(generated))
            del run
            torch.cuda.empty_cache()
        for game, mode in PNG_CARD_VS_CPU:
            phase_card_vs_cpu(dev, game, mode, generated=False)
        phase_env(dev)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
