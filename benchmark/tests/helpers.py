"""Cells cut to a size the CPU runs in seconds."""

import time
from pathlib import Path

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(name: str, root: Path = ROOT, num_envs: int = 8, bucket: int = 2):
    """The cell with its traffic cut to ``num_envs`` envs, every one of them
    followed by the check (and, for training, 6-step rollouts in one epoch
    of 4 minibatches)."""
    cell = harness.find_cell(name, root)
    cell.traffic = dict(cell.traffic, num_envs=num_envs, refill_bucket=bucket,
                        check=dict(cell.traffic["check"], envs=num_envs, near_timeout=0,
                                   min_levels=0))
    if "ppo" in cell.traffic:
        cell.traffic["ppo"] = dict(cell.traffic["ppo"], n_steps=6, n_minibatches=4, n_epochs=1)
    return cell


def run_tiny(cell, seed=11, seconds=2.0, trace=False, system=None, device="cpu"):
    torch.set_num_threads(2)
    ctx = harness.Context(cell, seed, seconds, trace, time.perf_counter(), torch.device(device))
    return harness.run_cell(ctx, system)


def correct(out) -> bool:
    return all(v <= lim for _, v, lim in out.checks)
