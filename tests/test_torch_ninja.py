"""procgen_torch's ninja against native/ninja_oracle.cpp, procgen_tpu and its
own inline path.

* levelgen of six seeds per mode (easy, hard) against the std::mt19937 C++
  oracle: grid, wall theme, the goal entity (type, theme, x and y bit for
  bit) and the next raw draws of the step stream.  No JAX is compiled;
* the step, hard mode, 4 envs: every level is generated by the port on the
  CPU and carried into the JAX package's EnvState, then both packages step
  it and draw its frame (the HUD's charge bar included).  Every state field
  and frame must agree bitwise after every step, with the view_dim rule of
  tests/test_torch_fast_path.py.  Finished envs are reset by the port and
  carried over again.  The seeded actions throw stars (special actions 1-5)
  and charge jumps; stars stuck on walls, bombs blown up by stars, deaths on
  fire, bombs and explosions, and goals are counted, and each must occur;
* the port's fast path against its inline path, forced resets at t = 40,
  41 and 90.

The JAX side's mul+add and double-trig sites are pinned
(``pin_jax_roundings`` of tests/test_torch_fast_path.py): XLA:CPU contracts
ninja's air-control update (ninja.cpp:110) into an FMA, and its fast-path
``dcos``/``dsin`` are float cos/sin, not the double ones the reference
narrows (ninja.cpp:389-405).
"""

import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig

from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from procgen_torch.games import ninja as NJ
from procgen_torch.state import init_state_template
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_fast_path import pin_jax_roundings

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 4
SEED = 31


@pytest.fixture(scope="session")
def ninja_oracle():
    src = REPO / "native" / "ninja_oracle.cpp"
    binary = REPO / "native" / "build" / "ninja_oracle_torch"
    binary.parent.mkdir(exist_ok=True)
    if not binary.exists() or binary.stat().st_mtime < src.stat().st_mtime:
        tmp = binary.with_name(f"{binary.name}.{os.getpid()}")
        subprocess.run(["g++", "-O2", "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, binary)

    def run(seed: int, mode: int):
        out = subprocess.run(
            [str(binary), str(seed), str(mode)],
            check=True, capture_output=True, text=True,
        ).stdout.splitlines()
        toks = out[0].split()[1:]
        _, wall_theme, goal_theme = map(int, toks[:3])
        goal = tuple(float.fromhex(v) for v in toks[3:5])
        rows = [list(map(int, line.split())) for line in out[1:65]]
        fp = list(map(int, out[65].split()[1:]))
        return {
            "wall_theme": wall_theme, "goal_theme": goal_theme, "goal": goal,
            "grid": np.asarray(rows), "fp": fp,
        }

    return run


def _bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_ninja_levelgen_matches_oracle(ninja_oracle, mode):
    cfg = EnvConfig(env_name="ninja", num_envs=6, distribution_mode=DistributionMode[mode])
    gd = make_game(cfg)
    seeds = [4 + 37 * i for i in range(6)]
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    mt = R.mt_block_close(rs)

    ents = state.ents
    for i, seed in enumerate(seeds):
        ref = ninja_oracle(seed, int(mode == "hard"))
        np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=f"seed {seed}")
        assert int(state.extra["wall_theme"][i]) == ref["wall_theme"], seed
        assert int(ents.alive[i].sum()) == 2, seed  # the agent and the goal
        assert int(ents.type[i, 1]) == NJ.GOAL, seed
        assert int(ents.image_theme[i, 1]) == ref["goal_theme"], seed
        got = (_bits(float(ents.x[i, 1])), _bits(float(ents.y[i, 1])))
        assert got == tuple(_bits(v) for v in ref["goal"]), seed
        one = R.MT(key=mt.key[i], pos=mt.pos[i])
        for want in ref["fp"]:
            one, x = R.mt_raw(one)
            assert int(x) == want, seed


def _cfgs(mode="hard"):
    kw = dict(env_name="ninja", num_envs=N, rand_seed=SEED, use_generated_assets=True)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: throw stars (9-13, special actions 1-5), charge and
    release jumps to the right (8 holds up-right, 7 releases), or any."""
    u = rs.rand(N)
    return np.where(
        u < 0.35, rs.randint(9, 14, size=N),
        np.where(u < 0.8, rs.choice([8, 8, 8, 7, 7, 5], size=N), rs.randint(0, 15, size=N)),
    ).astype(np.int32)


class GridEvents:
    """Counts the grid collisions the port's handler answers, from its
    inputs: stars on walls, stars on bombs, the player on fire or bombs."""

    def __init__(self, monkeypatch):
        self.counts = dict(star_wall=0, star_bomb=0, player_deadly=0)
        real = NJ.Ninja.handle_grid_collision

        def spy(gd, cfg, state, ent_idx, cell_type, cx, cy, valid):
            t = NJ._slot_field(state.ents, "type", ent_idx)
            star = valid & (t == NJ.THROWING_STAR)
            self.counts["star_wall"] += int((star & (cell_type == NJ.WALL_MID)).sum())
            self.counts["star_bomb"] += int((star & (cell_type == NJ.BOMB)).sum())
            deadly = (cell_type == NJ.FIRE) | (cell_type == NJ.BOMB)
            self.counts["player_deadly"] += int((valid & (t == O.PLAYER) & deadly).sum())
            return real(gd, cfg, state, ent_idx, cell_type, cx, cy, valid)

        monkeypatch.setattr(NJ.Ninja, "handle_grid_collision", spy)


def test_ninja_step_matches_reference(monkeypatch):
    pin_jax_roundings(monkeypatch)
    events = GridEvents(monkeypatch)
    counts = dict(levels=N, goals=0, deaths=0, stars=0, explosions=0, charge_bars=0)
    for state in stepped_against_reference(*_cfgs(), _policy, 300):
        alive = state.ents.alive
        counts["goals"] += int((state.reward > 0).sum())
        counts["deaths"] += int((state.done & (state.reward == 0)).sum())
        counts["stars"] += int((alive & (state.ents.type == NJ.THROWING_STAR)).sum())
        counts["explosions"] += int((alive & (state.ents.type == O.EXPLOSION)).sum())
        counts["charge_bars"] += int((state.extra["jump_charge"] > 0).sum())
        counts["levels"] += int(state.done.sum())
    counts.update(events.counts)
    for k in ("goals", "deaths", "stars", "explosions", "charge_bars", "star_wall",
              "star_bomb", "player_deadly"):
        assert counts[k] > 0, counts
    assert counts["levels"] >= 2 * N, counts


def test_ninja_fast_path_matches_inline():
    fs = check_fast_path_matches_inline(_cfgs()[1], _policy)
    # convert.py carries the game's extras by name (the round trip above)
    assert sorted(fs.state.extra) == sorted(("has_support", "facing_right", "last_fire_time", "wall_theme", "jump_charge"))
