"""What the env cells and the training cell share: the program's env batch,
the asset root, the env slots the check samples, and the recorder that
keeps what the program produced for those slots in the window."""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import sys
from types import SimpleNamespace

import torch

from benchmark import harness, synth_assets
from benchmark.reference import envs as ref


def port_modules():
    """The program's modules that ``EnvBatch`` builds from."""
    import procgen_torch.config
    import procgen_torch.engine.game
    import procgen_torch.games
    import procgen_torch.parallel.fast
    import procgen_torch.render.fast2
    import procgen_torch.render.pack
    import procgen_torch.render.renderer
    import procgen_torch.state

    p = procgen_torch
    return SimpleNamespace(config=p.config, games=p.games, game=p.engine.game,
                           fast=p.parallel.fast, fast2=p.render.fast2, pack=p.render.pack,
                           renderer=p.render.renderer, state=p.state)


class EnvBatch:
    """The program's env batch built from the inputs: the game, its pack,
    the fast path's (init, step) with the cell's refill bucket, and the
    frame."""

    def __init__(self, config: dict, traffic: dict, device):
        self.m = m = port_modules()
        self.device = torch.device(device)
        self.cfg = m.config.EnvConfig(
            env_name=config["game"],
            num_envs=traffic["num_envs"],
            distribution_mode=m.config.DistributionMode[config["distribution_mode"]],
            rand_seed=traffic["fixed"]["levels"],
            num_levels=config["num_levels"],
            start_level=config["start_level"],
        )
        self.gd = m.games.make_game(self.cfg)
        self.pack = m.pack.RenderPack(self.gd, self.cfg)
        self.init, self.step = m.fast.make_fast_fns(self.gd, self.cfg, self.pack,
                                                    refill_bucket=traffic["refill_bucket"])

    @property
    def timeout(self) -> int:
        return self.gd.timeout

    def start(self, phases, order):
        """The cell's first FastState: the level-seed streams dealt from the
        master seeded with the traffic's level seed, slot j taking stream
        ``order[j]``; every env reset, its view set, its phase ``cur_time
        = phases``, and the queue filled."""
        m, gd, cfg = self.m, self.gd, self.cfg
        s = m.state.seeded_template(gd, cfg, cfg.num_envs, device=self.device)
        idx = torch.as_tensor(order, dtype=torch.long, device=self.device)
        mt = s.level_seed_rng
        s = s.replace(level_seed_rng=type(mt)(**{f.name: getattr(mt, f.name)[idx]
                                                 for f in dataclasses.fields(mt)}))
        s = m.renderer.update_view_params(gd, cfg, m.game.reset_env(gd, cfg, s))
        s = s.replace(cur_time=torch.as_tensor(phases, dtype=torch.int32, device=self.device))
        return self.init(s)

    def frame(self, env_state) -> torch.Tensor:
        return self.m.fast2.render_frames2(self.gd, self.cfg, env_state, self.pack)


def write_assets(seed: int):
    root = harness.asset_dir() / "root"
    shutil.rmtree(root, ignore_errors=True)
    synth_assets.write_root(root, seed)
    os.environ["PROCGEN_TORCH_ASSET_ROOT"] = str(root)
    program_assets = sys.modules.get("procgen_torch.render.assets")
    if program_assets is not None:  # a second run in one process: new files
        program_assets.clear_caches()
    return root


def sample_slots(check: dict, phases, timeout: int, rng: random.Random) -> list:
    """The env slots the check follows, chosen from the seed before the
    window: ``near_timeout`` of the slots whose phase lies within
    ``near_within`` steps of the timeout (each finishes an episode, and so
    swaps in a refilled level, that soon), the rest from all slots."""
    n = len(phases)
    near = [j for j in range(n) if phases[j] >= timeout - check["near_within"]]
    slots = rng.sample(near, min(check["near_timeout"], len(near)))
    rest = [j for j in range(n) if j not in set(slots)]
    slots += rng.sample(rest, min(check["envs"] - len(slots), len(rest)))
    return sorted(slots)


class Recorder:
    """Copies of what the program produced for the sampled slots: per step
    the actions and the state's fields that the reference compares, per
    frame the frame and the number of steps taken before it.  Each is a
    gather on the device (no host synchronisation), so the program keeps
    none of its own tensors alive and may reuse its buffers."""

    def __init__(self, slots, device):
        self.slots = list(slots)
        self.idx = torch.as_tensor(self.slots, dtype=torch.long, device=device)
        self.steps, self.frames = [], []

    def step(self, state, actions) -> None:
        i = self.idx
        self.steps.append((actions[i], state.reward[i], state.done[i], state.cur_time[i],
                           state.current_level_seed[i], state.ents.x[i, 0], state.ents.y[i, 0],
                           state.grid[i]))

    def frame(self, obs) -> None:
        self.frames.append((len(self.steps), obs[self.idx]))

    def bytes(self) -> int:
        return sum(t.numel() * t.element_size() for s in self.steps for t in s) + sum(
            f.numel() for _, f in self.frames)

    def host(self) -> dict:
        """The record as NumPy arrays, as ``reference.envs.check`` takes it."""
        out = {"slots": self.slots, "frames": [(s, f.cpu().numpy()) for s, f in self.frames]}
        for name, col in zip(("actions",) + ref.FIELDS, zip(*self.steps)):
            out[name] = torch.stack(col).cpu().numpy()
        return out


def check_envs(cell, asset_root, order, phases, record: dict):
    """The env checks of a run (reference.envs.check) and their notes."""
    traffic = cell.traffic
    replay = ref.Replay(cell.config["game"], asset_root, traffic["fixed"]["levels"], order,
                        phases)
    return ref.check(replay, record, traffic["check"]["min_levels"])
