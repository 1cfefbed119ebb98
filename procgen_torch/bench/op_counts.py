"""Torch ops per refill, per game step and per frame of one game.

    python3 -m procgen_torch.bench.op_counts jumper hard [--envs 8] [--device cpu]
        [--generated-assets]

Counts the torch ops (aten ops that no other op encloses; each launches one
or more kernels on a card) of one refill at ``--envs`` envs (the refill
bucket), of one game step and of one frame, with the profiler's host
activity (procgen_torch/bench/profiling.py), and those inside every span of
``telemetry.SPANS`` that the refill or the step opens, keyed by the span's
name less ``procgen_torch.``: ``torch_ops_per_<span>`` (per call) and
``<span>_calls_per_refill`` for the refill's (``torch_ops_per_refill``,
``torch_ops_per_refill.levelgen``, ``torch_ops_per_leaper.preroll``, ...),
``torch_ops_per_step_in_<span>`` (summed over its calls) for the step's and
the frame's (``torch_ops_per_step_in_miner.gravity_sweep``, ...).  The game
runs in its default configuration, PNG assets, from
``PROCGEN_TORCH_ASSET_ROOT`` or else from a synthetic root written into a
temporary directory; ``--generated-assets`` runs the configuration the
earlier slices measured.  On the card these counts set the host time of a
step; they do not depend on the device, except where the card runs a kernel
and the CPU its plain version: the frame's compositor (one op group per
drawn record on the CPU), the maze generator in the refill and miner's
sweep (a loop over the cells on the CPU).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from procgen_torch import telemetry
from procgen_torch.bench import synth_assets
from procgen_torch.bench.profiling import profiled
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import step_env_no_reset
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render import assets, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template

# the game step and the frame, wrapped here; inside them, and inside the
# refill, the program's own spans (the summary counts only ops whose
# enclosing events are all spans it knows)
STEP_SPAN, FRAME_SPAN = "op_counts.game_step", "op_counts.frame"
SPANS = (STEP_SPAN, FRAME_SPAN, *telemetry.SPANS)


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
        print(json.dumps(count(**vars(args))))


def opened(summary) -> dict:
    """``{span less "procgen_torch.": (ops, calls)}`` of the program's spans
    that ran in a profiled window."""
    return {span.removeprefix("procgen_torch."): (summary["ops"][span], summary["count"][span])
            for span in telemetry.SPANS if summary["count"][span]}


def count(game, mode, envs=8, device="cpu", generated_assets=False) -> dict:
    """The op counts of ``game`` in ``mode`` (the module docstring)."""
    cfg = EnvConfig(env_name=game, num_envs=envs, distribution_mode=DistributionMode[mode],
                    rand_seed=123, use_generated_assets=generated_assets)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, _ = make_fast_fns(gd, cfg, pack, refill_bucket=envs)
    template = seeded_template(gd, cfg, envs, device=device)
    fs = init.cold(template)  # warm-up, and the state the step starts from
    _, refill = profiled(lambda: init.cold(template), SPANS, cuda=False)
    acts = torch.randint(0, 15, (envs,), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).to(device)

    def step_and_frame():
        with torch.profiler.record_function(STEP_SPAN):
            step_env_no_reset(gd, cfg, fs.state, acts)
        with torch.profiler.record_function(FRAME_SPAN):
            fast2.render_frames2(gd, cfg, fs.state, pack)

    _, step = profiled(step_and_frame, SPANS, cuda=False)
    out = dict(game=game, mode=mode, envs=envs, device=device,
               assets="generated" if generated_assets else "png",
               torch_ops_per_game_step=step["ops"][STEP_SPAN],
               torch_ops_per_frame=step["ops"][FRAME_SPAN])
    for name, (ops, calls) in opened(refill).items():
        out[f"torch_ops_per_{name}"] = ops / calls
        out[f"{name}_calls_per_refill"] = calls
    for name, (ops, _) in opened(step).items():
        out[f"torch_ops_per_step_in_{name}"] = ops
    return out


if __name__ == "__main__":
    main()
