"""Torch ops per refill, per game step and per frame of one game.

    python3 -m procgen_torch.bench.op_counts jumper hard [--envs 8] [--device cpu]
        [--generated-assets]

Counts the torch ops (aten ops that no other op encloses; each launches one
or more kernels on a card) of one refill at ``--envs`` envs (the refill
bucket), of one game step and of one frame, with the profiler's host
activity (procgen_torch/bench/profiling.py), and those inside the named
spans of the refill (leaper's pre-roll, jumper's scans, the path search,
reposition's retries, heist's maze with doors, starpilot's spawner
timeline) and of the step (miner's sweep, pair collisions, the
entity-reflect sweep, dodgeball's enemy sweep, bigfish's and heist's
agent-collision sweeps, bossfight's barrier sweep).  The game runs in its default
configuration, PNG assets, from ``PROCGEN_TORCH_ASSET_ROOT`` or else from a
synthetic root written into a temporary directory; ``--generated-assets``
runs the configuration the earlier slices measured.  On the card these counts set
the host time of a step; they do not depend on the device, except the
frame's: on the CPU the compositor runs its plain version, one op group per
drawn record.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from procgen_torch.bench import synth_assets
from procgen_torch.bench.profiling import profiled
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.base import AGENT_SWEEP_SPAN, PAIRS_SPAN
from procgen_torch.engine.entity_ops import REPOSITION_SPAN
from procgen_torch.engine.game import step_env_no_reset
from procgen_torch.engine.levelgen.mazegen import DOORS_SPAN
from procgen_torch.engine.levelgen.roomgen import FIND_PATH_SPAN
from procgen_torch.engine.physics import REFLECT_SPAN
from procgen_torch.games import make_game
from procgen_torch.games.bossfight import BARRIER_SWEEP_SPAN
from procgen_torch.games.dodgeball import ENEMY_SWEEP_SPAN
from procgen_torch.games.jumper import SCANS_SPAN
from procgen_torch.games.leaper import PREROLL_SPAN
from procgen_torch.games.miner import SWEEP_SPAN
from procgen_torch.games.starpilot import SPAWNERS_SPAN
from procgen_torch.parallel.fast import REFILL_SPAN, make_fast_fns
from procgen_torch.render import assets, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template

STEP_SPAN, FRAME_SPAN = "op_counts.game_step", "op_counts.frame"
# spans inside a refill and inside a game step, by the name of their count
REFILL_SPANS = {"preroll": PREROLL_SPAN, "levelgen_scans": SCANS_SPAN,
                "find_path": FIND_PATH_SPAN, "reposition": REPOSITION_SPAN,
                "maze_doors": DOORS_SPAN, "spawners": SPAWNERS_SPAN}
STEP_SPANS = {"sweep": SWEEP_SPAN, "pair_collisions": PAIRS_SPAN,
              "entity_reflect": REFLECT_SPAN, "enemy_sweep": ENEMY_SWEEP_SPAN,
              "agent_sweep": AGENT_SWEEP_SPAN, "barrier_sweep": BARRIER_SWEEP_SPAN}
SPANS = (REFILL_SPAN, STEP_SPAN, FRAME_SPAN, *REFILL_SPANS.values(), *STEP_SPANS.values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("game")
    ap.add_argument("mode")
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--generated-assets", action="store_true")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        if not args.generated_assets and not os.environ.get(assets.ROOT_ENV):
            os.environ[assets.ROOT_ENV] = str(synth_assets.write_root(tmp))
        count(args)


def count(args) -> None:
    cfg = EnvConfig(env_name=args.game, num_envs=args.envs,
                    distribution_mode=DistributionMode[args.mode], rand_seed=123,
                    use_generated_assets=args.generated_assets)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, _ = make_fast_fns(gd, cfg, pack, refill_bucket=args.envs)
    template = seeded_template(gd, cfg, args.envs, device=args.device)
    fs = init.cold(template)  # warm-up, and the state the step starts from
    _, refill = profiled(lambda: init.cold(template), SPANS, cuda=False)
    acts = torch.randint(0, 15, (args.envs,), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).to(args.device)

    def step_and_frame():
        with torch.profiler.record_function(STEP_SPAN):
            step_env_no_reset(gd, cfg, fs.state, acts)
        with torch.profiler.record_function(FRAME_SPAN):
            fast2.render_frames2(gd, cfg, fs.state, pack)

    _, step = profiled(step_and_frame, SPANS, cuda=False)
    out = dict(game=args.game, mode=args.mode, envs=args.envs, device=args.device,
               assets="generated" if args.generated_assets else "png",
               torch_ops_per_refill=refill["ops"][REFILL_SPAN],
               torch_ops_per_game_step=step["ops"][STEP_SPAN],
               torch_ops_per_frame=step["ops"][FRAME_SPAN])
    for name, span in REFILL_SPANS.items():
        if refill["count"][span]:
            out[f"torch_ops_per_{name}"] = refill["ops"][span] / refill["count"][span]
            out[f"{name}_calls_per_refill"] = refill["count"][span]
    for name, span in STEP_SPANS.items():
        if step["count"][span]:  # summed over the span's calls in the step
            out[f"torch_ops_per_step_in_{name}"] = step["ops"][span]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
