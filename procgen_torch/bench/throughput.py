"""Throughput benchmark of the port: rendered env-steps/s of the fast path.

    python -m procgen_torch.bench_cli [--games maze,miner] [--num-envs 8192]
        [--chunk 64] [--chunks 4] [--no-render] [--device cuda]

The loop of the reference package's ``bench.py``: hard mode,
``rand_seed=123``, one level seed per env from ``HostMT(123)``, a cold start
through the same bucket-sized refill the step uses (bucket ``max(256,
num_envs // 8)``), then per step random actions in [0, 15) from a
``torch.Generator`` on the device seeded 0, the fast-path step, the frame,
and a checksum of ``obs[:, 31, 31, :]`` summed mod 2^32 on the device, read
once per chunk.  One warm-up chunk, then ``chunks`` timed chunks.

Each game runs in a subprocess of its own, within a share of ``--budget``
seconds.  The parent prints one JSON line: ``metric``, ``value`` (the mean
over the games, a failed game counting 0), ``unit``, ``per_game``, each
game's ``checksum``, the settings, and the ``card`` (``nvidia-smi``'s name
and power limit) it ran on.  It runs on the card unless ``--device cpu``
is given; without CUDA it exits non-zero.  PNG assets (the default
configuration) need ``PROCGEN_TORCH_ASSET_ROOT`` (``python -m
procgen_torch.bench.synth_assets DIR`` writes a synthetic root).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

METRIC = "env_steps_per_sec_per_chip"
SEED = 123
GAME_RESERVE_S = 120.0  # the least time the suite keeps for each game


def bench_game(name: str, num_envs: int, chunk: int, chunks: int, render: bool = True,
               device="cuda") -> types.SimpleNamespace:
    """One game's loop.  Returns ``record`` (env-steps/s over the timed
    chunks, the checksum after the last chunk, the set-up times) and what
    ran: ``gd``, ``cfg``, ``pack`` and the final fast-path state ``fs``."""
    from procgen_torch import resolve_device
    from procgen_torch.config import DistributionMode, EnvConfig
    from procgen_torch.games import make_game
    from procgen_torch.parallel.fast import make_fast_fns
    from procgen_torch.render.fast2 import render_frames2
    from procgen_torch.render.pack import RenderPack
    from procgen_torch.state import seeded_template

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = EnvConfig(env_name=name, num_envs=num_envs, distribution_mode=DistributionMode.hard,
                    rand_seed=SEED)
    gd = make_game(cfg)
    t0 = time.perf_counter()
    pack = RenderPack(gd, cfg)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=max(256, num_envs // 8))
    t1 = time.perf_counter()
    # cold start: the first episodes come from the step's own refill
    fs = init.cold(seeded_template(gd, cfg, num_envs, device=dev))
    sync()
    t2 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)

    def run_chunk(fs, checksum):
        for _ in range(chunk):
            acts = torch.randint(0, 15, (num_envs,), generator=gen, device=dev, dtype=torch.int32)
            fs = step(fs, acts)
            if render:
                obs = render_frames2(gd, cfg, fs.state, pack)
                checksum = (checksum + obs[:, 31, 31, :].sum(dtype=torch.int64)) & 0xFFFFFFFF
        return fs, checksum, int(checksum)  # the chunk's one read

    fs, checksum, _ = run_chunk(fs, checksum)
    t3 = time.perf_counter()
    for _ in range(chunks):
        fs, checksum, value = run_chunk(fs, checksum)
    dt = time.perf_counter() - t3
    sps = num_envs * chunk * chunks / dt
    print(f"# {name}: {sps:,.0f} env-steps/s (num_envs={num_envs}, chunk={chunk}, "
          f"chunks={chunks}, warm-up chunk {t3 - t2:.1f}s, render={render})", file=sys.stderr)
    record = dict(steps_per_sec=sps, checksum=value, pack_s=t1 - t0, cold_start_s=t2 - t1,
                  warmup_chunk_s=t3 - t2, timed_s=dt)
    return types.SimpleNamespace(record=record, game=name, gd=gd, cfg=cfg, pack=pack, fs=fs)


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card (``torch``'s device
    name if it cannot be read), or ``cpu``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def _first_error_line(stderr: str) -> str:
    lines = (stderr or "").strip().splitlines()
    for pat in ("Error", "error:", "FAILED"):
        for line in lines:
            if pat in line:
                return line.strip()[:300]
    return " | ".join(lines[-2:])[:300]


def run_one_subprocess(game: str, args, deadline: float):
    """One game's bench in a fresh process; returns its record, or None and
    the line that explains the failure."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "procgen_torch.bench.throughput", "--one", game,
           "--num-envs", str(args.num_envs), "--chunk", str(args.chunk),
           "--chunks", str(args.chunks), "--device", args.device]
    if args.no_render:
        cmd.append("--no-render")
    budget = max(60.0, deadline - time.time())
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=budget, env=env)
    except subprocess.TimeoutExpired:
        return None, f"timeout after {budget:.0f}s"
    sys.stderr.write(out.stderr[-2000:])
    if out.returncode == 0:
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                return json.loads(line), None
    return None, f"exit {out.returncode}: {_first_error_line(out.stderr)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Rendered env-steps/s of procgen_torch's fast path.")
    ap.add_argument("--num-envs", type=int, default=8192)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--games", type=str, default="")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--budget", type=float, default=2700.0,
                    help="wall-clock seconds for the whole suite (default 2700)")
    ap.add_argument("--one", type=str, default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from procgen_torch import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    if args.one:
        run = bench_game(args.one, args.num_envs, args.chunk, args.chunks,
                         render=not args.no_render, device=args.device)
        print(json.dumps(run.record), flush=True)
        return 0

    from procgen_torch.games import available_games

    games = args.games.split(",") if args.games else available_games()
    deadline = time.time() + args.budget
    per_game, checksum, errors, records = {}, {}, {}, {}
    card = card_name(args.device)

    for i, game in enumerate(games):
        remaining = deadline - time.time()
        if remaining <= 0:
            per_game[game], errors[game] = 0.0, "suite budget exhausted"
            continue
        # a game may take what is left less GAME_RESERVE_S for each game
        # after it, so one slow game (leaper) inherits what the fast ones left
        share = max(remaining - GAME_RESERVE_S * (len(games) - i - 1), GAME_RESERVE_S)
        rec, err = run_one_subprocess(game, args, time.time() + share)
        per_game[game] = rec.pop("steps_per_sec") if rec else 0.0
        if rec:
            checksum[game] = rec.pop("checksum")
            records[game] = rec  # the set-up times
        else:
            errors[game] = err
            print(f"# {game}: FAILED: {err}", file=sys.stderr)
    print(json.dumps({
        "metric": METRIC, "value": sum(per_game.values()) / max(len(per_game), 1),
        "unit": "steps/s", "per_game": per_game, "checksum": checksum,
        "num_envs": args.num_envs, "chunk": args.chunk, "chunks": args.chunks,
        "render": not args.no_render, "card": card, "device": args.device,
        "records": records, "errors": errors,
    }), flush=True)
    return 0 if not errors else 1


if __name__ == "__main__":
    raise SystemExit(main())
