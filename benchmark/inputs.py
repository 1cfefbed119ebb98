"""Everything a run feeds the program, drawn from ``--seed``: the order of
the envs, the asset files and the sample the check takes.  The same seed
gives the same inputs.

The work itself does not change with the seed: the levels (the level-seed
master), the episode phases, the random actions and, for training, the
asset files, the initial parameters and the policy's generator (all of
which the policy's actions follow) come from the traffic file's fixed
seeds, and ``--seed`` only deals the envs to the slots in another
order.  Each env slot then plays what another slot played under another
seed (in training, the same policy with its noise drawn per slot), so runs
on different seeds do the same work: with levels of their own per seed,
maze's step rate moved by half between seeds; with parameters and assets
of their own, the trainer's moved by a third.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seeds(seed: int) -> dict:
    """Independent seeds from any whole ``seed`` (also past 32 bits): the
    envs' order, the assets and the check's sample."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(3)
    names = ("order", "assets", "sample")
    return {n: int(w) for n, w in zip(names, words)}


def phases(seed: int, num_envs: int, timeout: int) -> np.ndarray:
    """Initial ``cur_time`` per env, uniform over [0, timeout), so that
    episodes end at their steady rate and not in lockstep.  The arithmetic
    of ``procgen_torch/learn/train.py:stagger`` (commit 46b2158), with the
    seed drawn here."""
    u = np.random.RandomState(seed & 0xFFFFFFFF).random_sample(num_envs)
    return (u * timeout).astype(np.int32)


def action_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def random_actions(gen: torch.Generator, num_envs: int, n_actions: int = 15) -> torch.Tensor:
    """One step's actions, uniform over the actions, drawn on the device
    (``procgen_torch/bench/throughput.py``'s draw, commit 46b2158)."""
    return torch.randint(0, n_actions, (num_envs,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def order(seed: int, num_envs: int) -> np.ndarray:
    """The env slots' order: slot j plays what env ``order[j]`` of the fixed
    inputs plays."""
    return np.random.RandomState(seed & 0xFFFFFFFF).permutation(num_envs)
