"""procgen_torch's starpilot against native/starpilot_oracle.cpp, procgen_tpu
and its own inline path, in PNG mode on a synthetic asset root (starpilot
reads its turrets' and finish line's aspect ratios from the PNG headers
when it is built).

* the spawner timeline of five seeds per mode (easy, hard, extreme) against
  the std::mt19937 C++ oracle built with the reference's float rand01
  (``build_oracle`` of tests/test_torch_caveflyer.py) and the double
  ``cos``/``sin`` the game calls (starpilot.cpp:284-285; the oracle calls
  ``cosf``/``sinf``): every spawner field, the count and the next raw draws
  of the step stream.  Parity mode against that build with the reference's
  ``std::sort`` (the oracle sorts with ``std::stable_sort``): every field
  bit for bit, the order of tied spawn times included (the port sorts
  through its copy of ``utils/cppsort.py``).  Fast mode against the stable
  build: integers and positions bit for bit, the angle's velocities (the
  float ``(rand01() - .5) * k`` of the fast path against the double chain)
  within 2 ulp;
* 400 easy timelines, the longest kind (all flyer groups): none draws past
  the reset's prefetched block, some draw more than 512 (the JAX package's
  block, which its longest easy timelines overflow: ROADMAP section C), and
  the two longest match the oracle;
* the step, hard mode, 4 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState (with two
  destructible flyers staged in front of the agent and an enemy about to
  fire, so that bullets hit, enemies die and aimed bullets fly), then both
  packages step it and draw its frame, the scrolling background included;
  every state field and frame bitwise after every step; extreme mode for
  80 steps.  Enemy bullets, hits, kills and released spawners are counted,
  and each must occur;
* the port's fast path against its inline path.

The JAX side's float chains are pinned to the reference's roundings
(``pin_jax_roundings``: its ``face_rotation`` of the aimed bullets is
glibc's ``atan2f``, its ``dcos``/``dsin`` glibc's double ``cos``/``sin``)
and its renderer's (``pin_jax_render``).  XLA:CPU also fuses the aimed
bullet's ``num / sqrt(d)`` (starpilot.py:473-476 of the JAX package) into a
multiply by a reciprocal square root, which is not the IEEE quotient of the
two correctly rounded ops its fast path spells out (about 40% of random
inputs differ by an ulp); ``pin_jax_sqrt`` computes the square root on the
host, which leaves XLA an IEEE division (ROADMAP section C).  The JAX
package appends every enemy's shot, then every death explosion, where the
reference walks the slots once (starpilot.cpp:369-394);
``pin_jax_append_order`` reorders its two blocks into the walk's order,
and the step test asserts that this moved a child at least once.
"""

import inspect
import subprocess
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import fmath as j_fmath
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import starpilot as JS

from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.games import starpilot as SP
from procgen_torch.state import init_state_template
from test_torch_assets import asset_root_fixture
from test_torch_caveflyer import build_oracle
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_fast_path import pin_jax_render, pin_jax_roundings
from test_torch_fruitbot import check_stream, port_reset

torch.set_num_threads(1)

N = 4
SEED = 31
MODES = [("easy", 0), ("hard", 1), ("extreme", 2)]

synth_root = asset_root_fixture()

# the game's double cos/sin (the oracle calls the float overloads), and the
# reference's std::sort (the oracle sorts stably)
_DOUBLE_TRIG = (("cosf(theta)", "cos((double)theta)"), ("sinf(theta)", "sin((double)theta)"))
_STD_SORT = (("std::stable_sort(spawners.begin()", "std::sort(spawners.begin()"),)
_FLOATS = ("x", "y", "vx", "vy", "rx", "ry", "health", "rotation")
_INTS = ("type", "image_theme", "render_z", "fire_time", "spawn_time")


def _oracle(binary, seed, mode_i, turret_aspects):
    """The oracle's sorted spawners (dicts) and its next raw draws."""
    out = subprocess.run(
        [str(binary), str(seed), str(mode_i)] + [float(np.float32(a)).hex() for a in turret_aspects],
        check=True, capture_output=True, text=True,
    ).stdout.splitlines()
    n = int(out[0].split()[1])
    sps = []
    for line in out[1:1 + n]:
        tk = line.split()[1:]
        sp = dict(zip(_INTS, map(int, tk[:5])))
        sp.update(zip(_FLOATS, (float.fromhex(v) for v in tk[5:13])))
        sps.append(sp)
    return sps, list(map(int, out[1 + n].split()[1:]))


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


def _check_spawners(binary, gd, state, mt, i, seed, mode_i, parity):
    """Env ``i``'s spawner table and step stream against the oracle's for
    ``seed``; returns the count of tied spawn times."""
    ex = state.extra
    ref, fp = _oracle(binary, seed, mode_i, gd.turret_aspects)
    where = f"seed {seed}"
    assert int(ex["sp_count"][i]) == len(ref), where
    for k, sp in enumerate(ref):
        for f in _INTS:
            assert int(ex[f"sp_{f}"][i, k]) == sp[f], (where, k, f)
        for f in _FLOATS:
            got, want = _bits(ex[f"sp_{f}"][i, k]), _bits(sp[f])
            ulps = 0 if parity or f not in ("vx", "vy") else 2
            assert abs(got - want) <= ulps, (where, k, f, float(ex[f"sp_{f}"][i, k]), sp[f])
    # the table past the count is zero
    assert not ex["sp_type"][i, len(ref):].any(), where
    check_stream(mt, i, fp, where)
    times = [sp["spawn_time"] for sp in ref]
    return len(times) - len(set(times))


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("mode,mode_i", MODES)
def test_starpilot_spawners_match_oracle(synth_root, mode, mode_i, parity):
    binary = build_oracle("starpilot", True, _DOUBLE_TRIG + (_STD_SORT if parity else ()),
                          tag="_dtrig_sort" if parity else "_dtrig")
    cfg = EnvConfig(env_name="starpilot", num_envs=5, distribution_mode=DistributionMode[mode],
                    parity_mode=parity)
    seeds = [14 + 27 * i for i in range(5)]
    gd, state, mt = port_reset(cfg, seeds)
    ties = sum(_check_spawners(binary, gd, state, mt, i, seed, mode_i, parity)
               for i, seed in enumerate(seeds))
    assert ties > 0  # tied spawn times, whose order the sort decides


def test_starpilot_long_timelines_fit_the_draw_block(synth_root):
    """Easy timelines are all flyer groups of up to five spawners, so they
    draw the most: over 400 easy seeds no reset draws past the prefetched
    block (``port_reset`` asserts it), some draw more than 512 (the JAX
    package's block, ROADMAP section C), and the two longest match the
    oracle bit for bit."""
    seeds = list(range(1000, 1400))
    cfg = EnvConfig(env_name="starpilot", num_envs=len(seeds),
                    distribution_mode=DistributionMode.easy)
    gd = SP.StarPilot(cfg)
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    draws = rs.cursor
    assert int((draws > 512).sum()) > 0, int(draws.max())
    binary = build_oracle("starpilot", True, _DOUBLE_TRIG, tag="_dtrig")
    mt = R.mt_block_close(rs)
    for i in torch.argsort(draws, descending=True)[:2].tolist():
        _check_spawners(binary, gd, state, mt, i, seeds[i], 0, False)


def pin_jax_sqrt(monkeypatch):
    """The JAX package's ``dsqrt`` as a host square root (float32, correctly
    rounded), so that XLA cannot fuse the division by it (see above)."""

    def dsqrt(cfg, x):
        x = jnp.asarray(x, jnp.float32)
        return j_fmath._callback(lambda v: np.sqrt(np.asarray(v, np.float32)), x, x)

    monkeypatch.setattr(j_fmath, "dsqrt", dsqrt)


def _walk_order(ents, fire, dead, cnt0, record):
    """One env's table (under vmap) after the JAX package's two appended
    blocks, every shot of the ``fire`` sources, then every explosion of the
    ``dead`` ones (each block in descending slot order, from slot ``cnt0``
    on), with those children moved into the reference's order: one walk
    down the slots, a slot's shot before its explosion.  ``record(moved,
    overflow)`` sees whether anything moved, and whether the table was
    too full to hold both blocks (the blocks then drop other children than
    the walk would: the test fails)."""
    E = fire.shape[0]
    slot = jnp.arange(E)
    above = slot[None, :] > slot[:, None]
    fires_above = jnp.sum(above & fire[None, :], 1)
    deaths_above = jnp.sum(above & dead[None, :], 1)
    n_fire = jnp.sum(fire.astype(jnp.int32))
    walk_shot = cnt0 + fires_above + deaths_above
    walk_expl = walk_shot + fire
    src = slot.at[jnp.where(fire, walk_shot, E)].set(cnt0 + fires_above, mode="drop")
    src = src.at[jnp.where(dead, walk_expl, E)].set(cnt0 + n_fire + deaths_above, mode="drop")
    overflow = cnt0 + n_fire + jnp.sum(dead.astype(jnp.int32)) > E
    jax.debug.callback(record, jnp.any(src != slot), overflow)
    return jax.tree_util.tree_map(lambda a: a[src], ents)


def pin_jax_append_order(monkeypatch, counts):
    """The JAX package's starpilot step recompiled from its source with its
    two blocks of enemy appends reordered into the reference's order right
    after the second (``_walk_order``); the reordered state is the one
    compared, and the one carried into the next step.  ``counts["reordered"]``
    counts the env-steps where that moved a child: a shot and an explosion
    in one step, a dying slot above a firing one (ROADMAP section C)."""

    def record(moved, overflow):
        assert not np.any(overflow), "entity table full: the blocks drop other appends"
        counts["reordered"] += int(np.sum(moved))

    src = textwrap.dedent(inspect.getsource(JS.StarPilot.game_step))
    for old, new in (
        ("    ents = eo.append_entities_masked(ents, bfields, fire, descending=True)\n",
         "    cnt0 = jnp.sum(ents.alive.astype(I32))\n"
         "    ents = eo.append_entities_masked(ents, bfields, fire, descending=True)\n"),
        ("    ents = eo.append_entities_masked(ents, efields, dead, descending=True)\n",
         "    ents = eo.append_entities_masked(ents, efields, dead, descending=True)\n"
         "    ents = _walk_order(ents, fire, dead, cnt0, _record)\n"),
    ):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    scope = dict(vars(JS), _walk_order=_walk_order, _record=record)
    exec(compile(src, "<starpilot game_step in the walk's order>", "exec"), scope)
    monkeypatch.setattr(JS.StarPilot, "game_step", scope["game_step"])


def _cfgs(mode="hard"):
    kw = dict(env_name="starpilot", num_envs=N, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: fire forward (9) or back (10) half the time, else
    any."""
    u = rs.rand(N)
    return np.where(u < 0.4, 9, np.where(u < 0.5, 10, rs.randint(0, 15, size=N))).astype(np.int32)


def _stage(state, which):
    """A turret above the agent that fires at it every 5 steps, then two
    flyers (health 2) in the agent's line of fire, 3 and 6 ahead: a flyer
    shot down on a step the turret fires dies in a slot above a firing one
    (the case of ``pin_jax_append_order``)."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]
    turret = eo.make_entity(ax + 1.0, ay + 5.0, 0.0, 0.0, 1.0, 1.0, SP.TURRET)
    turret.update(health=5.0, fire_time=5, spawn_time=0)
    ents, _ = eo.append_entity(ents, turret, active=which)
    for dx in (3.0, 6.0):
        flyer = eo.make_entity(ax + dx, ay, -np.float32(0.05), 0.0, 0.5, 0.5, SP.FLYER)
        flyer.update(health=2.0, rotation=np.float32(SP.PI / 2))
        ents, _ = eo.append_entity(ents, flyer, active=which)
    return state.replace(ents=ents)


@pytest.mark.parametrize("mode,steps", [("hard", 250), ("extreme", 80)])
def test_starpilot_step_matches_reference(synth_root, monkeypatch, jax_x64_off, mode, steps):
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    pin_jax_sqrt(monkeypatch)
    counts = dict(enemy_bullets=0, kills=0, explosions=0, released=0, deaths=0, reordered=0)
    pin_jax_append_order(monkeypatch, counts)
    prev = None
    for state in stepped_against_reference(*_cfgs(mode), _policy, steps, prepare=_stage):
        ents = state.ents
        new = ents.alive & (ents.life_time == 0)
        counts["enemy_bullets"] += int((new & ((ents.type == SP.BULLET2) | (ents.type == SP.BULLET3))).sum())
        counts["explosions"] += int((new & (ents.type == O.EXPLOSION)).sum())
        counts["kills"] += int((state.reward == SP.ENEMY_REWARD).sum())
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        if prev is not None:
            fell = prev.extra["sp_count"] - state.extra["sp_count"]
            counts["released"] += int(fell[~prev.done].clamp(min=0).sum())
        prev = state
    for k in counts:
        assert counts[k] > 0, counts


def test_starpilot_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs()[1], _policy)
