"""One-command PPO training: ``python -m procgen_torch.learn.train coinrun``
(counterpart of ``procgen_tpu/learn/train.py``).

Runs the whole loop on one device (``--device``, the card unless the caller
asks for the CPU): the envs' fast path, their frames through the compositor
kernel, and the net.  Prints one JSON line per logged iteration with the JAX
package's keys.

Under torchrun (``torchrun --nproc_per_node=W -m procgen_torch.learn.train
coinrun``) it runs data parallel, one process per card over NCCL (gloo with
``--device cpu``): ``--num-envs`` is the global count, each rank steps its
shard of the env axis, the parameters are replicated and the gradients
all-reduced (parallel/sharding.py, learn/ppo.py), rank 0 prints the lines
and ``steps_per_sec`` counts the global batch.

The default configuration reads PNG assets: point
``PROCGEN_TORCH_ASSET_ROOT`` at an asset root (``python3 -m
procgen_torch.bench.synth_assets DIR`` writes a synthetic one); without
one it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import types

import numpy as np
import torch

from procgen_torch import resolve_device, telemetry
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env
from procgen_torch.games import make_game
from procgen_torch.learn.ppo import PPOConfig, make_train_fns
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.parallel.sharding import env_sharding, init_distributed
from procgen_torch.render.fast2 import render_frames2
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import seeded_template


def stagger(state, rand_seed: int, num_envs: int | None = None, start: int = 0):
    """Desynchronize episode phases: each env's initial ``cur_time`` drawn
    uniformly over [0, timeout), so that timeouts arrive continuously and
    not in lockstep at the 1000-step cap (the reference's envs desync
    through their own episode lengths).  Under a mesh ``state`` holds the
    rows from ``start`` of a global batch of ``num_envs``: the draws are the
    global batch's, sliced."""
    st = np.random.RandomState(rand_seed + 0x5AFE)
    u = st.random_sample(num_envs or state.num_envs)[start:start + state.num_envs]
    telemetry.count("host_reads.train.stagger")
    offs = (u * state.timeout.cpu().numpy()).astype(np.int32)
    return state.replace(cur_time=torch.from_numpy(offs).to(state.cur_time.device))


def make_env(cfg: EnvConfig, device, stagger_phases: bool = True, mesh=None):
    """The trainer's envs on ``device``: the game, its RenderPack, the fast
    path (refill bucket ``max(64, num_envs // 8)``), its frames, and the
    first FastState.  Each env's level-seed stream comes from the master
    MT19937 seeded with ``cfg.rand_seed``; every env is reset, its view set,
    and (by default) its phase staggered.  Under a ``mesh`` the envs are
    this rank's rows of the ``cfg.num_envs`` batch: the seeds and phases
    are the global batch's, sliced, and the refill bucket is global."""
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    fast_init, fast_step = make_fast_fns(gd, cfg, pack, refill_bucket=max(64, cfg.num_envs // 8),
                                         mesh=mesh)

    def render_fn(state):
        return render_frames2(gd, cfg, state, pack)

    rows = None if mesh is None else env_sharding(mesh, cfg.num_envs)
    state = seeded_template(gd, cfg, cfg.num_envs, device=device, rows=rows)
    state = update_view_params(gd, cfg, reset_env(gd, cfg, state))
    if stagger_phases:
        state = stagger(state, cfg.rand_seed, cfg.num_envs, 0 if rows is None else rows[0])
    return types.SimpleNamespace(gd=gd, cfg=cfg, pack=pack, fast_step=fast_step,
                                 render_fn=render_fn, fs=fast_init(state))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("env_name", nargs="?", default="coinrun")
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--n-steps", type=int, default=256)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--distribution-mode", default="easy")
    ap.add_argument("--rand-seed", type=int, default=0)
    ap.add_argument("--num-levels", type=int, default=0)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument(
        "--no-stagger", action="store_true",
        help="disable the initial episode-phase stagger (on by default: "
        "without it every env times out in lockstep at the 1000-step cap "
        "and whole rollouts pass with no completed episode)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # torchrun sets WORLD_SIZE: one process per card, data parallel
    mesh = init_distributed(device=args.device) if "WORLD_SIZE" in os.environ else None
    dev = resolve_device(args.device) if mesh is None else mesh.device
    cfg = EnvConfig(
        env_name=args.env_name,
        num_envs=args.num_envs,
        distribution_mode=DistributionMode[args.distribution_mode],
        rand_seed=args.rand_seed,
        num_levels=args.num_levels,
    ).resolve_exploration()
    env = make_env(cfg, dev, stagger_phases=not args.no_stagger, mesh=mesh)
    ppo = PPOConfig(n_steps=args.n_steps, lr=args.lr)
    init_ts, train_iter, _ = make_train_fns(env.gd, cfg, env.pack, ppo, env.fast_step,
                                            env.render_fn, dev, mesh)
    fs = env.fs

    # the same generator state on every rank: draws of global shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.rand_seed)
    ts = init_ts(gen)
    ep_acc = torch.zeros((fs.queue_valid.shape[0],), dtype=torch.float32, device=dev)

    total_steps = 0
    t0 = time.time()
    for it in range(args.iters):
        ts, fs, ep_acc, metrics = train_iter(ts, fs, gen, ep_acc)
        total_steps += args.num_envs * args.n_steps
        if (it + 1) % args.log_every == 0 and (mesh is None or mesh.rank == 0):
            # one device-host copy for all the metrics
            telemetry.count("host_reads.train.metrics")
            values = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
            m = dict(zip(metrics, values))
            m.update(
                iter=it + 1,
                env_steps=total_steps,
                steps_per_sec=round(total_steps / (time.time() - t0), 1),
            )
            print(json.dumps(m), flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
