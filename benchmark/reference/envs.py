"""The plain reference of the env cells and the comparison that decides
their ``correct``.

The reference plays each sampled env slot alone, from its first level,
with the actions the slot was given, as procgen's C++ plays one env
(``games.py``, ``frame.py``): the level seeds dealt to the envs from a
master generator seeded with the traffic's level seed (one full-width draw
per env, vecgame.cpp), each env drawing its next level's seed from its own
stream at every reset; its phase set after the first reset; at every step
the game step, the timeout, and on a finished episode the next level.  It
imports nothing of the program and takes nothing the program made: it
generates the levels, bakes their layers and draws the frames itself, from
the inputs alone (the seeds, the phases, the actions, the asset files).

What it compares, at every step of every sampled env: the reward and done
the step reported, the time, the level seed, the agent's position (float
bits), the grid, and every byte of every frame the program drew of that
env.  A finished episode swaps in the level the program generated ahead
of time (its refill), so each episode boundary checks one refilled level.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.frame import Painter
from benchmark.reference.games import GAMES, INT32_MAX
from benchmark.reference.mt import RandGen

FIELDS = ("reward", "done", "cur_time", "level_seed", "agent_x", "agent_y", "grid")


def level_seeds(master_seed: int, n: int) -> list:
    """The first level-seed stream seed of each of ``n`` envs."""
    master = RandGen(master_seed)
    return [master.randint_full() for _ in range(n)]


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


class Replay:
    """The reference's view of a cell: the game, its painter, the level
    seed of every env slot and its phase."""

    def __init__(self, game: str, asset_root, master_seed: int, order, phases):
        self.game = GAMES[game]()
        self.painter = Painter(self.game, asset_root)
        seeds = level_seeds(master_seed, len(order))
        self.stream_seed = [seeds[int(i)] for i in order]
        self.phases = [int(p) for p in phases]

    def play(self, slot: int, actions, frame_steps):
        """Slot ``slot`` over the steps ``actions``: yields (t, fields after
        step t) for each step and ("frame", s, frame) for each step count s
        in ``frame_steps`` (the frame of the state after s steps), and
        counts the levels swapped in."""
        g, p = self.game, self.painter
        stream = RandGen(self.stream_seed[slot])

        def next_level(prev):
            s = stream.randint(0, INT32_MAX)
            return g.reset(RandGen(s), s, prev)

        level = next_level(None)
        level.cur_time = self.phases[slot]
        static = p.static_layer(level)
        self.swaps = 0
        if 0 in frame_steps:
            yield "frame", 0, p.frame(level, static)
        for t, a in enumerate(actions):
            level.cur_time += 1
            reward, done = g.step(level, int(a))
            done = done or level.cur_time >= g.timeout
            if done:
                level = next_level(level)
                static = p.static_layer(level)
                self.swaps += 1
            yield "step", t, {
                "reward": np.float32(reward), "done": done, "cur_time": level.cur_time,
                "level_seed": level.seed, "agent_x": level.agent.x, "agent_y": level.agent.y,
                "grid": level.grid,
            }
            if t + 1 in frame_steps:
                yield "frame", t + 1, p.frame(level, static)


def check(replay: Replay, record: dict, min_levels: int):
    """The checks (name, value, limit) and lines naming the first values
    that differ.  ``record``: the sampled ``slots``, per step their
    ``actions`` and the program's ``FIELDS`` (each (T, K, ...)), and the
    ``frames`` it drew ((step count, (K, 64, 64, 3) uint8) pairs)."""
    slots = record["slots"]
    frames = {}
    for s, f in record["frames"]:
        frames.setdefault(s, []).append(f)
    step_bad, frame_bad, levels, first = 0, 0, 0, []
    for k, slot in enumerate(slots):
        for kind, t, want in replay.play(slot, record["actions"][:, k], frames):
            if kind == "frame":
                for f in frames[t]:
                    bad = int((f[k] != want).sum())
                    frame_bad += bad
                    if bad and len(first) < 4:
                        first.append(f"slot {slot} frame after step {t}: {bad} bytes")
                continue
            for name in FIELDS:
                got = record[name][t, k]
                bad = int((_bits(got) != _bits(np.asarray(want[name], got.dtype))).sum())
                step_bad += bad
                if bad and len(first) < 4:
                    first.append(f"slot {slot} step {t}: {name} {got!r:.60} != "
                                 f"{np.asarray(want[name])!r:.60}")
        levels += replay.swaps
    steps = record["actions"].shape[0]
    notes = [f"checked {len(slots)} env slots over {steps} steps and "
             f"{sum(len(v) for v in frames.values())} frames each: {levels} levels swapped in"]
    notes += first
    checks = [("step_mismatches", step_bad, 0), ("frame_mismatches", frame_bad, 0),
              ("levels_short", max(0, min_levels - levels), 0)]
    return checks, notes
