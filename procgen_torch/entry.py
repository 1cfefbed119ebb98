"""Driver entry points (counterpart of ``__graft_entry__.py``): one
rendered env step as a compile check, and the multi-card dryrun.

    python -m procgen_torch.entry [--device cpu] [--n-devices N]

runs ``entry()``'s step once, then ``dryrun_multichip`` over N processes
(every card by default; 2 on the CPU, over gloo), and holds each game's
global run bit for bit against the same steps in one process.  ``run_sharded`` runs any
list of ``run_steps`` jobs the same way: the tests and chip_smoke.py hold
its global runs against one process's.  The games read PNG
assets: point ``PROCGEN_TORCH_ASSET_ROOT`` at an asset root (``python3 -m
procgen_torch.bench.synth_assets DIR`` writes a synthetic one).
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time

import numpy as np
import torch

from procgen_torch import convert, resolve_device
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env, step_env
from procgen_torch.games import make_game
from procgen_torch.parallel import sharding
from procgen_torch.parallel.fast import FastState, make_fast_fns
from procgen_torch.render import compositor
from procgen_torch.render.fast2 import render_frames2, render_static2
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import seeded_template

SEED = 7
# the dryrun's games: maze easy (grid walk and the static-layer cache),
# dodgeball hard (pair collisions, big entity tables, free rotation), and
# miner and bigfish easy (the joint batch's members)
DRYRUN_GAMES = (("maze", "easy"), ("dodgeball", "hard"), ("miner", "easy"), ("bigfish", "easy"))


def _build(env_name: str, num_envs: int, mode: str, device, mesh=None):
    """The game, its pack and the reset seeded batch (this rank's rows
    under a sharded ``mesh``) with its views set."""
    cfg = EnvConfig(env_name=env_name, num_envs=num_envs,
                    distribution_mode=DistributionMode[mode], rand_seed=SEED)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    rows = None if mesh is None else sharding.env_sharding(mesh, num_envs)
    state = seeded_template(gd, cfg, num_envs, device, rows)
    return cfg, gd, pack, update_view_params(gd, cfg, reset_env(gd, cfg, state))


def entry(device="cuda"):
    """(fn, example_args): one rendered env step of maze easy over 8 envs
    (the env transition with its inline reset, the static layer and the
    frame through the compositor)."""
    dev = resolve_device(device)
    cfg, gd, pack, state = _build("maze", 8, "easy", dev)

    def fn(state, actions):
        state = update_view_params(gd, cfg, step_env(gd, cfg, state, actions))
        state = state.replace(static_layer=render_static2(gd, cfg, state, pack))
        return state, render_frames2(gd, cfg, state, pack)

    return fn, (state, torch.zeros((8,), dtype=torch.int32, device=dev))


def run_steps(env_name: str, mode: str, num_envs: int, steps: int, mesh=None, device="cuda",
              refill_bucket: int | None = None, action_seed: int | None = None, deaths=(),
              resets=()):
    """The fast path of ``num_envs`` envs (this rank's rows under a sharded
    ``mesh``) for ``steps`` rendered steps.  ``deaths`` = [(env, k)] sets
    env's ``cur_time`` k steps before its timeout after the first levels
    are made; actions are random from ``action_seed`` (drawn for the global
    batch) or all 0, and -1 (a forced reset) for ``resets`` = [(step,
    env)], steps counted from 1.  Returns the global run as numpy: ``states`` (the
    FastState's fields at the start and after each step), ``frames``
    (steps + 1, N, 64, 64, 3), ``reward`` and ``done`` (steps, N),
    ``step_s``, each ``fast_step``'s host seconds (synchronized on the
    card), and ``launches``, this rank's compositor launches."""
    dev = resolve_device(device) if mesh is None else mesh.device
    cfg, gd, pack, state = _build(env_name, num_envs, mode, dev, mesh)
    fast_init, fast_step = make_fast_fns(gd, cfg, pack, refill_bucket or num_envs, mesh)
    start, count = (0, num_envs) if mesh is None else sharding.env_sharding(mesh, num_envs)

    def rows(x):
        return torch.as_tensor(np.ascontiguousarray(x[start:start + count])).to(dev)

    def gather(*tensors):
        if mesh is None:
            return tensors
        return sharding.gather_rows(tensors, mesh)

    compositor.launches = 0
    fs = fast_init(state)
    if deaths:
        k = np.full((num_envs,), -1, np.int32)
        for env, steps_left in deaths:
            k[env] = steps_left
        k = rows(k)
        cur_time = torch.where(k >= 0, fs.state.timeout - k, fs.state.cur_time)
        fs = FastState(fs.state.replace(cur_time=cur_time), fs.queue, fs.queue_valid)
    rs = np.random.RandomState(action_seed) if action_seed is not None else None
    out = dict(states=[], frames=[], reward=[], done=[], step_s=[])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def record(fs):
        glob = fs if mesh is None else sharding.make_global_env_state(fs, mesh)
        out["states"].append(convert.fast_state_to_numpy(glob))
        (frames,) = gather(render_frames2(gd, cfg, fs.state, pack))
        out["frames"].append(frames.cpu().numpy())

    record(fs)
    for t in range(1, steps + 1):
        acts = (np.zeros((num_envs,), np.int32) if rs is None
                else rs.randint(0, 15, size=num_envs).astype(np.int32))
        acts[[env for step, env in resets if step == t]] = -1
        acts = rows(acts)
        sync()
        t0 = time.perf_counter()
        fs = fast_step(fs, acts)
        sync()
        out["step_s"].append(time.perf_counter() - t0)
        reward, done = gather(fs.state.reward, fs.state.done)
        out["reward"].append(reward.cpu().numpy())
        out["done"].append(done.cpu().numpy())
        record(fs)
    out = {k: v if k in ("states", "step_s") else np.stack(v) for k, v in out.items()}
    out["launches"] = compositor.launches
    return out


def _run_rank(rank: int, world: int, init_method: str, device: str, backend, out_dir: str,
              jobs):
    if device == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    dev = f"cuda:{rank}" if device == "cuda" else device
    mesh = sharding.init_distributed(init_method, world, rank, device=dev, backend=backend)
    try:
        runs = [run_steps(**job, mesh=mesh) for job in jobs]
    finally:
        torch.distributed.destroy_process_group()
    launches = [r.pop("launches") for r in runs]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(runs=runs if rank == 0 else None, launches=launches), f)


def run_sharded(jobs, world: int, device="cuda", backend: str | None = None) -> dict:
    """``run_steps(**job)`` for each job, sharded over ``world`` spawned
    processes: one per card on ``"cuda"`` (NCCL), all on one card for a
    device with an index (``"cuda:0"``, with ``backend="gloo"``), or on the
    CPU (gloo).  Returns rank 0's global runs and each rank's compositor
    launches per job."""
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="procgen_sharded_") as tmp:
        sharding.spawn_ranks(_run_rank, world, tmp, (str(device), backend, tmp, list(jobs)))
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:  # written by our ranks
                ranks.append(pickle.load(f))
    return dict(runs=ranks[0]["runs"], launches=[r["launches"] for r in ranks])


def dryrun_jobs(n_devices: int) -> list:
    """The dryrun's runs (``_dryrun_one`` of the reference, per game): one
    step over ``2 * n_devices`` envs, the refill bucket every env."""
    n = 2 * n_devices
    return [dict(env_name=g, mode=m, num_envs=n, steps=1, refill_bucket=n) for g, m in DRYRUN_GAMES]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The multi-card check across the engine's path classes: maze easy,
    dodgeball hard, miner easy and bigfish easy, each one sharded fast step
    (env transition, level-queue refill, frame) over ``n_devices``
    processes, one per card (NCCL; gloo with ``device="cpu"``), with the
    global frames' shape checked.  Returns ``run_sharded``'s result."""
    out = run_sharded(dryrun_jobs(n_devices), n_devices, device)
    for job, run in zip(dryrun_jobs(n_devices), out["runs"]):
        shape = run["frames"].shape
        assert shape == (2, job["num_envs"], 64, 64, 3), (job["env_name"], shape)
    return out


def assert_runs_equal(want: dict, got: dict, what: str) -> None:
    """Two ``run_steps`` records bit for bit: rewards, dones, frames and
    every field of the state at every step."""
    for k in ("reward", "done", "frames"):
        if not np.array_equal(want[k], got[k]):
            raise AssertionError(f"{what}: {k} differ")
    for t, (a, b) in enumerate(zip(want["states"], got["states"], strict=True)):
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k].view(np.uint8),
                                                              b[k].view(np.uint8)):
                raise AssertionError(f"{what}: {k} differs at step {t}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="processes of the dryrun (default: every card; 2 on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fn, (state, actions) = entry(dev)
    _, obs = fn(state, actions)
    print("entry ok:", tuple(obs.shape), flush=True)
    n = args.n_devices or (torch.cuda.device_count() if dev.type == "cuda" else 2)
    out = dryrun_multichip(n, dev.type)
    for job, got in zip(dryrun_jobs(n), out["runs"]):
        assert_runs_equal(run_steps(**job, device=dev), got,
                          f"{job['env_name']} over {n} processes against one")
    print(f"dryrun_multichip({n}) ok: bitwise equal to one process", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
