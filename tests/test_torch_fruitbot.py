"""procgen_torch's fruitbot against native/fruitbot_oracle.cpp and
procgen_tpu, in PNG mode on a synthetic asset root (fruitbot reads its
fruit's and food's aspect ratios from the PNG headers when it is built).
Its easy mode and its fast path are in tests/test_torch_fruitbot_modes.py
(two files keep each under its time budget).

* levelgen of six seeds per mode (easy, hard) against the std::mt19937 C++
  oracle built with the reference's float rand01 (``build_oracle`` of
  tests/test_torch_caveflyer.py): entity types, themes, x, y, rx and ry,
  the counts and the next raw draws of the step stream.  Parity mode
  computes the wall's double chain ``min_pct + .2 * rand01()``
  (fruitbot.cpp:170) and matches bit for bit; fast mode rounds each float
  op in turn and is held to 2e-5, as tests/test_fruitbot.py holds the JAX
  package.  The oracle leaves out fit_aspect_ratio: fruit and food boxes
  are checked against their themes' aspect ratios;
* the step, hard mode, 4 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState (a lock and
  its door staged just above the agent in even envs, so that key bullets
  open doors), then both packages step it and draw its frame; every state
  field and frame bitwise after every step.  Fruit and food eaten, wall
  deaths, key bullets and opened doors are counted, and each must occur.

The JAX side's float chains are pinned to the reference's roundings
(``pin_jax_roundings``); its view is a center-agent one at visibility 10
or 20 (units 6.4 and 3.2), where XLA:CPU contracts the renderer's rect
mul+adds into FMAs (``pin_jax_render``, ROADMAP section C).
"""

import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig

from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.games import fruitbot as FB
from procgen_torch.games import make_game
from procgen_torch.state import init_state_template
from test_torch_assets import asset_root_fixture
from test_torch_caveflyer import build_oracle, run_oracle
from test_torch_coinrun import stepped_against_reference
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_fast_path import pin_jax_render, pin_jax_roundings

torch.set_num_threads(1)

N = 4
SEED = 31

synth_root = asset_root_fixture()


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


def port_reset(cfg, seeds):
    """game_reset of each seed on the CPU: (game, state, step stream)."""
    gd = make_game(cfg)
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    return gd, state, R.mt_block_close(rs)


def check_stream(mt, i, fp, where):
    """The next raw draws of env ``i``'s step stream equal the oracle's."""
    one = R.MT(key=mt.key[i], pos=mt.pos[i])
    for want in fp:
        one, x = R.mt_raw(one)
        assert int(x) == want, where


def oracle_ents(lines) -> list:
    """``ent type theme x y rx ry`` lines -> tuples (hex floats)."""
    out = []
    for line in lines:
        t = line.split()[1:]
        out.append((int(t[0]), int(t[1])) + tuple(float.fromhex(v) for v in t[2:6]))
    return out


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("mode,mode_i", [("easy", 0), ("hard", 1)])
def test_fruitbot_levelgen_matches_oracle(synth_root, mode, mode_i, parity):
    binary = build_oracle("fruitbot", float_rand01=True)
    cfg = EnvConfig(env_name="fruitbot", num_envs=6, distribution_mode=DistributionMode[mode],
                    parity_mode=parity)
    seeds = [3 + 17 * i for i in range(6)]
    gd, state, mt = port_reset(cfg, seeds)
    ents = state.ents
    doors = fitted = 0
    for i, seed in enumerate(seeds):
        out = run_oracle(binary, seed, mode_i)
        where = f"seed {seed}"
        num_good, num_bad = map(int, out[0].split()[1:])
        ref = oracle_ents(out[2:2 + int(out[1].split()[1])])
        assert int(ents.alive[i].sum()) == len(ref), where
        assert int((ents.type[i] == FB.GOOD_OBJ).sum()) == num_good, where
        assert int((ents.type[i] == FB.BAD_OBJ).sum()) == num_bad, where
        for k, (t, theme, ex, ey, erx, ery) in enumerate(ref):
            assert int(ents.type[i, k]) == t, (where, k)
            assert int(ents.image_theme[i, k]) == theme, (where, k)
            doors += t == FB.LOCKED_DOOR
            got = [float(getattr(ents, f)[i, k]) for f in ("x", "y", "rx", "ry")]
            want = [ex, ey, erx, ery]
            if t in (FB.GOOD_OBJ, FB.BAD_OBJ):
                # fit_aspect_ratio of the theme's sprite (bag.cpp:1025-1036)
                aspects = gd.good_aspects if t == FB.GOOD_OBJ else gd.bad_aspects
                ar = np.float32(aspects[theme])
                half = np.float32(0.5)
                want[2:] = [half, half / ar] if ar > 1 else [half * ar, half]
                assert [_bits(v) for v in got[2:]] == [_bits(v) for v in want[2:]], (where, k)
                fitted += 1
            if parity:
                assert [_bits(v) for v in got] == [_bits(v) for v in want], (where, k, got, want)
            else:
                np.testing.assert_allclose(got, want, atol=2e-5, err_msg=f"{where} ent {k}")
        check_stream(mt, i, map(int, out[2 + len(ref)].split()[1:]), where)
    assert fitted > 0 and (doors > 0 or mode == "easy")


def _cfgs(mode="hard"):
    kw = dict(env_name="fruitbot", num_envs=N, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: fire a key (9) a third of the time, else any."""
    return np.where(rs.rand(N) < 0.3, 9, rs.randint(0, 15, size=N)).astype(np.int32)


def _stage(state, which):
    """A lock and its door 2 above the agent in the even envs of ``which``
    (key bullets fly up from the agent)."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]
    even = which & (torch.arange(N) % 2 == 0)
    door = eo.make_entity(ax + 1.5, ay + 2.5, 0.0, 0.0, 1.0, FB.WALL_RY, FB.LOCKED_DOOR)
    lock = eo.make_entity(ax, ay + 2.5, 0.0, 0.0, FB.LOCK_RX, FB.LOCK_RY, FB.LOCK)
    ents, _ = eo.append_entity(ents, door, active=even)
    ents, _ = eo.append_entity(ents, lock, active=even)
    return state.replace(ents=ents)


def run_steps(monkeypatch, mode, steps):
    """The step run of one mode, every field and frame bitwise; returns the
    event counts."""
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    counts = dict(fruit=0, food=0, wall_deaths=0, keys=0, doors_opened=0)
    prev = None
    for state in stepped_against_reference(*_cfgs(mode), _policy, steps, prepare=_stage):
        ents = state.ents
        counts["fruit"] += int((state.reward == FB.POSITIVE_REWARD).sum())
        counts["food"] += int((state.reward < 0).sum())
        counts["wall_deaths"] += int((state.done & ~state.level_complete
                                      & (state.cur_time < 1000)).sum())
        counts["keys"] += int((ents.alive & (ents.type == FB.PLAYER_BULLET)
                               & (ents.life_time == 1)).sum())
        if prev is not None:
            gone = (prev.ents.alive & (prev.ents.type == FB.LOCKED_DOOR)).sum(1) - (
                ents.alive & (ents.type == FB.LOCKED_DOOR)).sum(1)
            counts["doors_opened"] += int((gone > 0)[~prev.done].sum())
        prev = state
    return counts


def test_fruitbot_step_matches_reference(synth_root, monkeypatch, jax_x64_off):
    counts = run_steps(monkeypatch, "hard", 250)
    for k in ("fruit", "food", "wall_deaths", "keys", "doors_opened"):
        assert counts[k] > 0, counts
