"""procgen_torch's dodgeball against native/dodgeball_oracle.cpp, procgen_tpu
and its own inline path.

* levelgen of five seeds per mode (easy, hard, extreme, memory) against
  the std::mt19937 C++ oracle.  Built with the reference's float rand01
  (``build_oracle`` of tests/test_torch_caveflyer.py) the oracle must equal
  the port bit for bit: entity types, x, y, rx, ry, vx, vy, spawn times,
  the enemy count and theme, and the next raw draws of the step stream.
  The unmodified oracle draws its positions through a double rand01, so
  there types, counts, themes, velocities, spawn times and draws are exact
  and positions are held at the tolerance of tests/test_dodgeball.py.  No
  JAX is compiled;
* the step, hard mode, 4 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState, then both
  packages step it and draw its frame.  Every state field and frame must
  agree bitwise after every step.  Enemies reflecting off lava walls (the
  entity-reflect sweep), balls absorbed by enemies, enemies killed (dust
  clouds), balls erased by lava walls, enemy balls thrown, doors opened and
  deaths are counted, and each must occur;
* the step in memory mode (a center-agent view), 120 steps, every field and
  frame bitwise (with ``pin_jax_render`` as well);
* the port's fast path against its inline path, forced resets at t = 40,
  41 and 90, with moves only (see the test).

The JAX side's fast path is pinned as in tests/test_torch_fast_path.py
(``pin_jax_roundings``): XLA:CPU contracts the agent's velocity update and
the sub-step's ``x + vx * pct`` into FMAs, and ``face_rotation`` runs its
own arctan2 with the ``+ 0.0`` folded away (dodgeball.py:337, 439-440,
506-508).
"""

import jax
import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig

from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import physics as ph
from procgen_torch.games import dodgeball as DB
from procgen_torch.games import make_game
from procgen_torch.state import init_state_template
from test_torch_caveflyer import build_oracle, run_oracle
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_fast_path import pin_jax_render, pin_jax_roundings

torch.set_num_threads(1)

N = 4
SEED = 31
MODES = [("easy", 0), ("hard", 1), ("extreme", 2), ("memory", 3)]
FIELDS = ("x", "y", "rx", "ry", "vx", "vy")


@pytest.fixture(scope="session")
def dodgeball_oracle():
    binaries = {f: build_oracle("dodgeball", f) for f in (False, True)}

    def run(seed: int, mode: int, float_rand01: bool):
        out = run_oracle(binaries[float_rand01], seed, mode)
        num_enemies, enemy_theme, n_ents = map(int, out[0].split()[1:])
        ents = []
        for line in out[1:1 + n_ents]:
            t = line.split()[1:]
            ents.append((int(t[0]),) + tuple(float.fromhex(v) for v in t[1:7]) + (int(t[7]),))
        fp = list(map(int, out[1 + n_ents].split()[1:]))
        return {"num_enemies": num_enemies, "enemy_theme": enemy_theme, "ents": ents, "fp": fp}

    return run


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("mode,mode_i", MODES)
def test_dodgeball_levelgen_matches_oracle(dodgeball_oracle, mode, mode_i):
    cfg = EnvConfig(env_name="dodgeball", num_envs=5, distribution_mode=DistributionMode[mode])
    gd = make_game(cfg)
    seeds = [1 + 41 * i for i in range(5)]
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    mt = R.mt_block_close(rs)

    ents = state.ents
    for i, seed in enumerate(seeds):
        for float_rand01 in (True, False):
            ref = dodgeball_oracle(seed, mode_i, float_rand01)
            where = f"seed {seed}, float rand01 {float_rand01}"
            assert int(state.extra["num_enemies"][i]) == ref["num_enemies"], where
            assert int(ents.alive[i].sum()) == len(ref["ents"]), where
            for k, (t, *vals, spawn) in enumerate(ref["ents"]):
                assert int(ents.type[i, k]) == t, (where, k)
                got = [float(getattr(ents, f)[i, k]) for f in FIELDS]
                if float_rand01:
                    assert [_bits(v) for v in got] == [_bits(v) for v in vals], (where, k, got, vals)
                else:
                    np.testing.assert_allclose(got, vals, atol=2e-5, err_msg=f"{where} ent {k}")
                    assert got[4:] == vals[4:], (where, k)  # vx, vy: no rand01
                if t == DB.ENEMY:
                    assert int(ents.spawn_time[i, k]) == spawn, (where, k)
                    assert int(ents.image_theme[i, k]) == ref["enemy_theme"], (where, k)
                    assert bool(ents.smart_step[i, k]) and bool(ents.collides_with_entities[i, k])
            one = R.MT(key=mt.key[i], pos=mt.pos[i])
            for want in ref["fp"]:
                one, x = R.mt_raw(one)
                assert int(x) == want, where


def _cfgs(mode="hard"):
    kw = dict(env_name="dodgeball", num_envs=N, rand_seed=SEED, use_generated_assets=True)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: throw a ball (9) along the last move, or move (0-8)."""
    u = rs.rand(N)
    return np.where(u < 0.6, 9, rs.randint(0, 9, size=N)).astype(np.int32)


def _stage(state, which):
    """Edit the new levels of ``which`` in the even envs so that doors open:
    every enemy but the first is moved out of the world (the step's erase
    drops it), the first stands 2.5 cells right of the agent, and the agent
    faces right (its balls fly along its last move).  The odd envs play
    their levels as generated."""
    which = which & (torch.arange(N) % 2 == 0)
    ents = state.ents
    slot = torch.arange(ents.capacity)
    enemy = ents.alive & (ents.type == DB.ENEMY) & which[:, None]
    first = slot == torch.where(enemy, slot, ents.capacity).amin(1, keepdim=True)
    ax, ay = ents.x[:, :1], ents.y[:, :1]
    x = torch.where(enemy & first, ax + 2.5, torch.where(enemy, -50.0, ents.x))
    y = torch.where(enemy & first, ay, ents.y)
    lma = torch.where(which, 7, state.last_move_action)
    return state.replace(ents=ents.replace(x=x, y=y), last_move_action=lma)


class Events:
    """Counts, from the port's inputs and outputs: enemy velocities negated
    by the entity-reflect sweep, balls the pair handler erases (absorbed by
    enemies or touching lava walls) and enemies it kills."""

    def __init__(self, monkeypatch):
        self.counts = dict(entity_reflections=0, balls_absorbed=0, enemies_killed=0,
                           balls_on_lava=0)
        real_sweep = ph._entity_reflect
        real_pairs = DB.Dodgeball.handle_collision_pairs

        def sweep(gd, cfg, state, idxs, obj, nx, ny, nvx, nvy, *args):
            out = real_sweep(gd, cfg, state, idxs, obj, nx, ny, nvx, nvy, *args)
            flipped = (out[2] * nvx < 0) | (out[3] * nvy < 0)
            self.counts["entity_reflections"] += int(flipped.sum())
            return out

        def pairs(gd, cfg, state, pair_mask):
            out = real_pairs(gd, cfg, state, pair_mask)
            e0, e1 = state.ents, out.ents
            L = pair_mask.shape[1]
            new = (e1.will_erase & ~e0.will_erase)[:, :L]
            ball = (e0.type == DB.PLAYER_BALL)[:, :L]
            enemy = (e0.type == DB.ENEMY)[:, :L]
            lava = (pair_mask & (e0.type[:, :L] == DB.LAVA_WALL)[:, :, None]).any(1)
            self.counts["balls_absorbed"] += int((new & ball & ~lava).sum())
            self.counts["enemies_killed"] += int((new & enemy).sum())
            self.counts["balls_on_lava"] += int((new & lava).sum())
            return out

        monkeypatch.setattr(ph, "_entity_reflect", sweep)
        monkeypatch.setattr(DB.Dodgeball, "handle_collision_pairs", pairs)


@pytest.fixture
def jax_x64_off():
    """The JAX package's fast mode runs without x64.  Another test file
    turns it on when it is imported (tests/test_fmath_batching.py), and
    every worker imports every file: with x64 on, the JAX package's
    ``num_enemies`` sum (dodgeball.py:538-540) comes out int64."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def test_dodgeball_step_matches_reference(monkeypatch, jax_x64_off):
    pin_jax_roundings(monkeypatch)
    events = Events(monkeypatch)
    counts = dict(levels=N, deaths=0, doors_open=0, dust_clouds=0, enemy_balls=0)
    for state in stepped_against_reference(*_cfgs(), _policy, 250, prepare=_stage):
        ents = state.ents
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        counts["doors_open"] += int((state.extra["num_enemies"] == 0).sum())
        counts["dust_clouds"] += int((ents.alive & (ents.type == DB.DUST_CLOUD)).sum())
        counts["enemy_balls"] += int((ents.alive & (ents.type == DB.ENEMY_BALL)).sum())
        counts["levels"] += int(state.done.sum())
    counts.update(events.counts)
    for k in ("deaths", "doors_open", "dust_clouds", "enemy_balls", "entity_reflections",
              "balls_absorbed", "enemies_killed", "balls_on_lava"):
        assert counts[k] > 0, counts
    assert counts["levels"] >= 2 * N, counts


def test_dodgeball_memory_step_matches_reference(monkeypatch, jax_x64_off):
    """Memory mode (a larger arena in a center-agent view, and fewer
    enemies), 120 steps, as the hard run: every field and frame bitwise."""
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    counts = dict(levels=N, deaths=0, enemy_balls=0)
    for state in stepped_against_reference(*_cfgs("memory"), _policy, 120, prepare=_stage):
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        counts["enemy_balls"] += int((state.ents.alive & (state.ents.type == DB.ENEMY_BALL)).sum())
        counts["levels"] += int(state.done.sum())
    assert counts["enemy_balls"] > 0 and counts["levels"] > N, counts


def _moving_policy(rs):
    """Seeded moves only (never 4 or a special action), so that every step
    rewrites last_move_action."""
    return rs.choice([0, 1, 2, 3, 5, 6, 7, 8], size=N).astype(np.int32)


def test_dodgeball_fast_path_matches_inline():
    # A queued level carries the action bookkeeping of the step that made
    # it, the inline reset that of the dying step (both packages' fast
    # path).  Dodgeball is the first ported game to read one of those
    # fields across a reset: the agent faces, and throws along, its last
    # move, so after a swap that is followed by no move the two paths face
    # differently.  Here every action is a move.
    fs = check_fast_path_matches_inline(_cfgs()[1], _moving_policy)
    assert sorted(fs.state.extra) == ["last_fire_time", "num_enemies"]
