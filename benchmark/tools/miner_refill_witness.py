"""Miner hard: the program's fast path against the program's inline-reset
path and the reference, on the first step of each env's second level.

    python -m benchmark.tools.miner_refill_witness --envs 4096 --levels 7 [--device cuda]

Every env starts with phase 999, so it times out on its first step and
swaps in the level its queue has held since the start.  The slots whose
second level puts the exit next to the agent (found by the reference) are
stepped once more; the line of each gives the reward and done of that step
by the fast path, the inline path and the reference, and the diamond count
each path carried into the new level.  The C++ keeps the count of the
level that ended (miner.cpp's member, recomputed only by a step); the fast
path's queue entry keeps the count of the row when it was generated, 0 at
the start, so an agent that steps onto the exit first thing wins there.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmark import envloop
from benchmark.reference import envs as ref
from benchmark.reference.games import INT32_MAX, Miner
from benchmark.reference.mt import RandGen

CONFIG = {"game": "miner", "distribution_mode": "hard", "num_levels": 0, "start_level": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=20260114, help="the level-seed master")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    n, dev = args.envs, torch.device(args.device)
    traffic = {"num_envs": n, "refill_bucket": max(n // 8, 1), "fixed": {"levels": args.levels}}
    root = envloop.write_assets(5)
    envs = envloop.EnvBatch(CONFIG, traffic, dev)
    order, phases = np.arange(n), np.full(n, 999, np.int32)
    t0 = time.perf_counter()
    fs = envs.start(phases, order)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.levels + 1)
    acts = [torch.randint(0, 15, (n,), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(2)]
    replay, game = ref.Replay("miner", root, args.levels, order, phases), Miner()
    cand = []
    for j in range(n):
        stream = RandGen(replay.stream_seed[j])
        stream.randint(0, INT32_MAX)
        seed = stream.randint(0, INT32_MAX)
        agent, exit_ = game.reset(RandGen(seed), seed, None).ents
        if abs(int(exit_.x - agent.x)) + abs(int(exit_.y - agent.y)) == 1:
            cand.append(j)
    print(f"slots whose second level has the exit next to the agent: {len(cand)}")
    from procgen_torch.engine import game as program_game

    f1 = envs.step(fs, acts[0])
    f2 = envs.step(f1, acts[1])
    i1 = program_game.step_env(envs.gd, envs.cfg, fs.state, acts[0])
    i2 = program_game.step_env(envs.gd, envs.cfg, i1, acts[1])
    for j in cand:
        want = [w for kind, _, w in replay.play(j, [int(acts[0][j]), int(acts[1][j])], set())
                if kind == "step"][1]
        print(f"slot {j}: action {int(acts[1][j])}; reward/done: fast path "
              f"{f2.state.reward[j].item()}/{bool(f2.state.done[j])}, inline path "
              f"{i2.reward[j].item()}/{bool(i2.done[j])}, reference "
              f"{float(want['reward'])}/{want['done']}; diamonds carried: fast path "
              f"{int(f1.state.extra['diamonds_remaining'][j])}, inline path "
              f"{int(i1.extra['diamonds_remaining'][j])}")
    print(f"seconds {time.perf_counter() - t0:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
