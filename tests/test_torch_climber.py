"""procgen_torch's climber against native/climber_oracle.cpp, procgen_tpu and
its own inline path, in PNG mode on a synthetic asset root (climber reads
its enemy's aspect ratio from the PNG header when it is built).

* levelgen of six seeds per mode (easy, hard) against the std::mt19937 C++
  oracle built with the reference's float rand01 (``build_oracle`` of
  tests/test_torch_caveflyer.py: the oracle's own rand01 returns a double,
  and its draws decide where enemies and coins appear): grid, agent and
  wall themes, coin quota, the entity list (types, x, y and vx bit for bit)
  and the next raw draws of the step stream; and against the JAX package's
  ``game_reset``, every state field bitwise (the enemies' ``ry``, which the
  oracle does not print, included);
* the step, hard mode, 4 envs, 250 steps, and easy mode, 80 steps: every
  level is generated by the port on the CPU and carried into the JAX
  package's EnvState (a coin beside the agent and an enemy patrolling
  towards it are staged), then both packages step it and draw its frame
  (the center-agent view follows the agent up the world; walls take the
  level's theme); every state field and frame bitwise after every step,
  with ``pin_jax_roundings`` of tests/test_torch_fast_path.py (XLA:CPU
  contracts the air-control mul+add, climber.cpp:113, and the random agent
  spawn) and x64 off (``jax_x64_off`` of tests/test_torch_dodgeball.py:
  with it on, the JAX package's coin count sums to int64).  Coins, deaths,
  jumps and enemies turning are counted, and each must occur;
* the port's fast path against its inline path.
"""

import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game

from procgen_torch import convert
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.games import climber as C
from procgen_torch.games import make_game
from test_torch_assets import asset_root_fixture
from test_torch_bigfish import jax_direct_reset, port_direct_reset, reset_fields
from test_torch_caveflyer import build_oracle, run_oracle
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_fast_path import assert_fields_equal, jax_fields, pin_jax_render, pin_jax_roundings

torch.set_num_threads(1)

N = 4
SEED = 31

synth_root = asset_root_fixture()


def _parse(out: list, mw: int) -> dict:
    agent_theme, wall_theme, _, coin_quota, n_ents = map(int, out[0].split()[1:])
    rows = [list(map(int, line.split())) for line in out[1:65]]
    ents = []
    for line in out[65:65 + n_ents]:
        t = line.split()[1:]
        ents.append((int(t[0]),) + tuple(float.fromhex(v) for v in t[1:4]))
    fp = list(map(int, out[65 + n_ents].split()[1:]))
    return dict(agent_theme=agent_theme, wall_theme=wall_theme, coin_quota=coin_quota,
                grid=np.asarray(rows), ents=ents, fp=fp)


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_climber_levelgen_matches_oracle(synth_root, monkeypatch, mode):
    pin_jax_roundings(monkeypatch)  # the random agent spawn's mul+add
    binary = build_oracle("climber", float_rand01=True)
    seeds = [2 + 29 * i for i in range(6)]
    cfg = EnvConfig(env_name="climber", num_envs=len(seeds), distribution_mode=DistributionMode[mode])
    gd = make_game(cfg)
    state = port_direct_reset(gd, cfg, seeds)
    ents = state.ents
    enemies = 0
    for i, seed in enumerate(seeds):
        ref = _parse(run_oracle(binary, seed, int(mode == "hard")), gd.world_w)
        np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=f"seed {seed}")
        assert int(ents.image_theme[i, 0]) == ref["agent_theme"], seed
        assert int(state.extra["wall_theme"][i]) == ref["wall_theme"], seed
        assert int(state.extra["coin_quota"][i]) == ref["coin_quota"], seed
        assert int(ents.alive[i].sum()) == len(ref["ents"]), seed
        for k, (t, ex, ey, evx) in enumerate(ref["ents"]):
            assert int(ents.type[i, k]) == t, (seed, k)
            got = [_bits(getattr(ents, f)[i, k]) for f in ("x", "y", "vx")]
            assert got == [_bits(ex), _bits(ey), _bits(evx)], (seed, k)
            enemies += t == C.ENEMY
        one = R.MT(key=state.rng.key[i], pos=state.rng.pos[i])
        for want in ref["fp"]:
            one, x = R.mt_raw(one)
            assert int(x) == want, seed
    assert enemies > 0

    j_cfg = JConfig(env_name="climber", num_envs=len(seeds), distribution_mode=JMode[mode])
    j_state, overflowed = jax_direct_reset(j_make_game(j_cfg), j_cfg, seeds)
    assert not np.asarray(overflowed).any()
    assert_fields_equal(reset_fields(jax_fields(j_state)),
                        reset_fields(convert.state_to_numpy(state)), f"climber {mode} reset")


def _cfgs(mode="hard"):
    kw = dict(env_name="climber", num_envs=N, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions biased to run right and jump (moves 5, 7, 8)."""
    biased = rs.choice([5, 7, 8, 8, 2], size=N)
    return np.where(rs.rand(N) < 0.7, biased, rs.randint(0, 15, size=N)).astype(np.int32)


def _stage(state, which):
    """A coin one cell right of the agent and an enemy patrolling three
    cells further, on the floor of the new levels of ``which``."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]
    coin = eo.make_entity(ax + 1.0, ay, 0.0, 0.0, 0.3, 0.3, C.COIN)
    enemy = eo.make_entity(ax + 4.0, ay, -np.float32(0.15), 0.0, 0.5, 0.5, C.ENEMY)
    enemy.update(image_type=C.ENEMY1, smart_step=True, climber_spawn_x=ax + 4.0)
    ents, _ = eo.append_entity(ents, coin, active=which)
    ents, _ = eo.append_entity(ents, enemy, active=which)
    extra = dict(state.extra)
    extra["coin_quota"] = extra["coin_quota"] + which.to(torch.int32)
    return state.replace(ents=ents, extra=extra)


@pytest.mark.parametrize("mode,steps", [("hard", 250), ("easy", 80)])
def test_climber_step_matches_reference(synth_root, monkeypatch, jax_x64_off, mode, steps):
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    counts = dict(coins=0, deaths=0, jumps=0, turns=0)
    prev = None
    for state in stepped_against_reference(*_cfgs(mode), _policy, steps, prepare=_stage):
        ents = state.ents
        counts["coins"] += int((state.reward == C.COIN_REWARD).sum())
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        counts["jumps"] += int((ents.vy[:, eo.AGENT] == C.MAX_JUMP).sum())
        if prev is not None:
            enemy = ents.alive & (ents.type == C.ENEMY) & prev.ents.alive
            counts["turns"] += int((enemy & (ents.vx * prev.ents.vx < 0)).sum())
        prev = state
    for k in counts:
        assert counts[k] > 0, counts


def test_climber_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs()[1], _policy)
