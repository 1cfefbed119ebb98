"""One-command PPO training: ``python -m procgen_torch.learn.train coinrun``
(counterpart of ``procgen_tpu/learn/train.py``).

Runs the whole loop on one device (``--device``, the card unless the caller
asks for the CPU): the envs' fast path, their frames through the compositor
kernel, and the net.  Prints one JSON line per logged iteration with the JAX
package's keys.  The default configuration reads PNG assets: point
``PROCGEN_TORCH_ASSET_ROOT`` at an asset root (``python3 -m
procgen_torch.bench.synth_assets DIR`` writes a synthetic one); without
one it raises.
"""

from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np
import torch

from procgen_torch import resolve_device
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env
from procgen_torch.games import make_game
from procgen_torch.learn.ppo import PPOConfig, make_train_fns
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render.fast2 import render_frames2
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import seeded_template


def stagger(state, rand_seed: int):
    """Desynchronize episode phases: each env's initial ``cur_time`` drawn
    uniformly over [0, timeout), so that timeouts arrive continuously and
    not in lockstep at the 1000-step cap (the reference's envs desync
    through their own episode lengths)."""
    st = np.random.RandomState(rand_seed + 0x5AFE)
    offs = (st.random_sample(state.num_envs) * state.timeout.cpu().numpy()).astype(np.int32)
    return state.replace(cur_time=torch.from_numpy(offs).to(state.cur_time.device))


def make_env(cfg: EnvConfig, device, stagger_phases: bool = True):
    """The trainer's envs on ``device``: the game, its RenderPack, the fast
    path (refill bucket ``max(64, num_envs // 8)``), its frames, and the
    first FastState.  Each env's level-seed stream comes from the master
    MT19937 seeded with ``cfg.rand_seed``; every env is reset, its view set,
    and (by default) its phase staggered."""
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    fast_init, fast_step = make_fast_fns(gd, cfg, pack, refill_bucket=max(64, cfg.num_envs // 8))

    def render_fn(state):
        return render_frames2(gd, cfg, state, pack)

    state = seeded_template(gd, cfg, cfg.num_envs, device=device)
    state = update_view_params(gd, cfg, reset_env(gd, cfg, state))
    if stagger_phases:
        state = stagger(state, cfg.rand_seed)
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

    dev = resolve_device(args.device)
    cfg = EnvConfig(
        env_name=args.env_name,
        num_envs=args.num_envs,
        distribution_mode=DistributionMode[args.distribution_mode],
        rand_seed=args.rand_seed,
        num_levels=args.num_levels,
    ).resolve_exploration()
    env = make_env(cfg, dev, stagger_phases=not args.no_stagger)
    ppo = PPOConfig(n_steps=args.n_steps, lr=args.lr)
    init_ts, train_iter, _ = make_train_fns(env.gd, cfg, env.pack, ppo, env.fast_step,
                                            env.render_fn, dev)
    fs = env.fs

    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.rand_seed)
    ts = init_ts(gen)
    ep_acc = torch.zeros((args.num_envs,), dtype=torch.float32, device=dev)

    total_steps = 0
    t0 = time.time()
    for it in range(args.iters):
        ts, fs, ep_acc, metrics = train_iter(ts, fs, gen, ep_acc)
        total_steps += args.num_envs * args.n_steps
        if (it + 1) % args.log_every == 0:
            # one device-host copy for all the metrics
            values = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
            m = dict(zip(metrics, values))
            m.update(
                iter=it + 1,
                env_steps=total_steps,
                steps_per_sec=round(total_steps / (time.time() - t0), 1),
            )
            print(json.dumps(m), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
