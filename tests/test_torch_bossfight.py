"""procgen_torch's bossfight against native/bossfight_oracle.cpp and
procgen_tpu, in PNG mode on a synthetic asset root (bossfight reads its
ships' and meteors' aspect ratios from the PNG headers when it is built).
Its other modes and its fast path are in tests/test_torch_bossfight_modes.py
(two files keep each under its time budget: the JAX package compiles a
bossfight step and frame in about a minute on the CPU).

* levelgen of six seeds per mode (easy, hard) against the std::mt19937 C++
  oracle built with the reference's float rand01 (``build_oracle`` of
  tests/test_torch_caveflyer.py) and the shields' double products
  ``1.2 * boss->rx`` and ``1.2 * boss->ry`` (bossfight.cpp:217; the oracle
  multiplies by ``1.2f``): the boss's theme, rounds, health and attack
  modes, the themes, the entity list (types, themes, x, y, rx, ry) and the
  next raw draws of the step stream.  Parity mode matches bit for bit;
  fast mode rounds the shields' ``ry`` as a float product, held to 1 ulp;
* the step, hard mode, 2 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState (in the odd
  env the shields are staged to drop at the first waypoint and the boss's
  rounds to take two hits, and the seeded actions steer the agent under
  the boss on every other step, so that bullets damage the boss, rounds
  end and the damaged boss explodes), then both packages step it and draw its
  frame; every state field bitwise after every step.  Reflections off the
  shields, hits on the boss, rounds won, bullets erased by barriers, enemy
  bullets and trails are counted, and each must occur.

The JAX side's float chains are pinned to the reference's roundings
(``pin_jax_roundings``, ``pin_jax_render``), and the spiral attack's angle
``PI * (1.25 + k / 16) + i * PI / 2`` (bossfight.py:473-476 of the JAX
package), whose product and sum XLA:CPU contracts into an FMA, through the
pinned ``fadd32`` (``pin_bossfight_spiral``, ROADMAP section C).  The laser
trails fade (alpha 0.7 per step, reflected bullets 0.8), so the compositor
blends fractional alpha, where the JAX package's is within 1.0 per float
value of the port's (ROADMAP section C: XLA:CPU multiplies by a reciprocal
and contracts the blend into an FMA): the frames are held to at most 1 per
uint8 value, as tests/test_torch_png_path_centered.py holds fractional
sprite alpha.
"""

import inspect
import subprocess
import textwrap

import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import bossfight as JB

from procgen_torch import objects as O
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.games import bossfight as BF
from test_torch_assets import asset_root_fixture
from test_torch_caveflyer import build_oracle
from test_torch_coinrun import stepped_against_reference
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_fast_path import pin_jax_render, pin_jax_roundings
from test_torch_fruitbot import check_stream, oracle_ents, port_reset

torch.set_num_threads(1)

N = 2  # envs in the step runs
SEED = 31

synth_root = asset_root_fixture()

# the reference's "1.2 * boss->rx, 1.2 * boss->ry": double products, each
# narrowed once (bossfight.cpp:217)
_SHIELDS = (("1.2f * BOSS_R, 1.2f * boss_ry", "(float)(1.2 * BOSS_R), (float)(1.2 * boss_ry)"),)


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("mode,mode_i", [("easy", 0), ("hard", 1)])
def test_bossfight_levelgen_matches_oracle(synth_root, mode, mode_i, parity):
    binary = build_oracle("bossfight", True, _SHIELDS, tag="_shields")
    cfg = EnvConfig(env_name="bossfight", num_envs=6, distribution_mode=DistributionMode[mode],
                    parity_mode=parity)
    seeds = [2 + 29 * i for i in range(6)]
    gd, state, mt = port_reset(cfg, seeds)
    aspects = gd.player_aspects + gd.boss_aspects + gd.barrier_aspects
    ents, ex = state.ents, state.extra
    barriers = 0
    for i, seed in enumerate(seeds):
        out = subprocess.run([str(binary), str(seed), str(mode_i)]
                             + [float(np.float32(a)).hex() for a in aspects],
                             check=True, capture_output=True, text=True).stdout.splitlines()
        where = f"seed {seed}"
        (boss_theme, round_health, num_rounds, invulnerable, boss_health, agent_theme,
         player_laser, boss_laser, moves_right) = map(int, out[0].split()[1:])
        modes = list(map(int, out[1].split()[1:]))
        assert int(ents.image_theme[i, BF.BOSS_SLOT]) == boss_theme, where
        assert int(ents.image_theme[i, 0]) == agent_theme, where
        assert float(ents.health[i, BF.BOSS_SLOT]) == boss_health, where
        got = [int(ex[k][i]) for k in ("round_health", "num_rounds", "invulnerable_duration",
                                       "player_laser_theme", "boss_laser_theme",
                                       "barriers_moves_right")]
        assert got == [round_health, num_rounds, invulnerable, player_laser, boss_laser,
                       moves_right], where
        assert ex["attack_modes"][i].tolist() == modes + [0] * (BF.MAX_ROUNDS - len(modes)), where
        assert int(ex["attack_mode"][i]) == modes[0] and bool(ex["shields_are_up"][i]), where
        ref = oracle_ents(out[3:3 + int(out[2].split()[1])])
        assert int(ents.alive[i].sum()) == len(ref), where
        for k, (t, theme, *xyr) in enumerate(ref):
            assert int(ents.type[i, k]) == t, (where, k)
            assert int(ents.image_theme[i, k]) == theme, (where, k)
            barriers += t == BF.BARRIER
            got = np.array([_bits(getattr(ents, f)[i, k]) for f in ("x", "y", "rx", "ry")])
            want = np.array([_bits(v) for v in xyr])
            tol = np.array([0, 0, 0, 1 if t == BF.SHIELDS and not parity else 0])
            assert (np.abs(got - want) <= tol).all(), (where, k, got, want)
        check_stream(mt, i, map(int, out[3 + len(ref)].split()[1:]), where)
    assert barriers > 0


def pin_bossfight_spiral(monkeypatch):
    """The JAX package's attack angles recompiled from their source with
    the spiral's "product + sum" through ``fadd32`` (a host rounding, after
    pin_jax_roundings), so that XLA cannot contract them."""
    src = textwrap.dedent(inspect.getsource(JB.Bossfight._boss_fire_thetas))
    for old, new in (
        ("PI * (1.25 + fm.wide(cfg, k1.astype(F32)) / 16.0)",
         "fm.fadd32(cfg, PI * (1.25 + fm.wide(cfg, k1.astype(F32)) / 16.0),"),
        ("+ fm.wide(cfg, i.astype(F32) * F32(PI) / 2)",
         "fm.wide(cfg, i.astype(F32) * F32(PI) / 2))"),
    ):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    scope = dict(vars(JB))
    exec(compile(src, "<pinned bossfight _boss_fire_thetas>", "exec"), scope)
    monkeypatch.setattr(JB.Bossfight, "_boss_fire_thetas", scope["_boss_fire_thetas"])


def _cfgs(mode="hard", n=N):
    kw = dict(env_name="bossfight", num_envs=n, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def policy(n, seen=None):
    """Seeded actions for ``n`` envs: fire (9) half the time, else any; with
    ``seen`` (a dict whose "state" the caller keeps at the latest port
    state) the agent steers under the boss on every other step instead."""
    tick = [0]

    def acts(rs):
        act = np.where(rs.rand(n) < 0.5, 9, rs.randint(0, 15, size=n)).astype(np.int32)
        tick[0] += 1
        state = (seen or {}).get("state")
        if state is not None and tick[0] % 2:
            dx = (state.ents.x[:, BF.BOSS_SLOT] - state.ents.x[:, 0]).numpy()
            act = np.where(dx > 0.5, 7, np.where(dx < -0.5, 1, act)).astype(np.int32)
        return act

    return acts


def stage(state, which):
    """In the odd envs of ``which``: the shields drop at the first waypoint
    (20 steps in) and each round of the boss's health takes two hits."""
    odd = which & (torch.arange(which.shape[0]) % 2 == 1)
    ex = dict(state.extra)
    ex["time_to_swap"] = torch.where(odd, 0, ex["time_to_swap"])
    ex["round_health"] = torch.where(odd, 2, ex["round_health"])
    health = (ex["round_health"] * ex["num_rounds"]).to(torch.float32)
    ents = eo.write_slot_masked(state.ents, BF.BOSS_SLOT, odd, health=health)
    return state.replace(ents=ents, extra=ex)


def run_steps(monkeypatch, mode, steps, n=N):
    """The step run of one mode: every field bitwise, frames within 1 per
    value; returns the event counts."""
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    pin_bossfight_spiral(monkeypatch)
    off = []

    def within_one(want, got, where):
        d = np.abs(want.astype(np.int16) - got.astype(np.int16))
        assert d.max() <= 1, f"frame off by {d.max()} {where}"
        off.append(int((d > 0).sum()))

    counts = dict(reflections=0, boss_hits=0, rounds=0, barrier_hits=0, enemy_bullets=0,
                  trails=0, deaths=0)
    prev = None
    seen = {}
    for state in stepped_against_reference(*_cfgs(mode, n), policy(n, seen), steps,
                                           prepare=stage, frames_equal=within_one):
        seen["state"] = state
        ents = state.ents
        new = ents.alive & (ents.life_time == 0)
        t = ents.type
        counts["reflections"] += int((ents.alive & (t == BF.REFLECTED_BULLET)
                                      & (ents.life_time <= 1)).sum())
        counts["enemy_bullets"] += int((new & (t == BF.ENEMY_BULLET)).sum())
        counts["trails"] += int((new & (t == BF.LASER_TRAIL)).sum())
        counts["rounds"] += int((state.reward >= BF.POSITIVE_REWARD).sum())
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        # a barrier leaves a resting explosion half a bullet's size on each
        # bullet it erases (the damaged boss's explosions are 0.75 wide)
        counts["barrier_hits"] += int((new & (t == O.EXPLOSION) & (ents.vx == 0) & (ents.vy == 0)
                                       & (ents.rx < 0.5)).sum())
        if prev is not None:
            fell = prev.ents.health[:, BF.BOSS_SLOT] - ents.health[:, BF.BOSS_SLOT]
            counts["boss_hits"] += int(fell[~prev.done].sum())
        prev = state
    assert len(off) == steps
    counts["frames_one_off"] = sum(v > 0 for v in off)
    return counts


def test_bossfight_step_matches_reference(synth_root, monkeypatch, jax_x64_off):
    counts = run_steps(monkeypatch, "hard", 250)
    for k in ("reflections", "boss_hits", "rounds", "barrier_hits", "enemy_bullets", "trails",
              "deaths"):
        assert counts[k] > 0, counts
