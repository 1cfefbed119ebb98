"""procgen_torch's caveflyer against native/caveflyer_oracle.cpp, procgen_tpu
and its own inline path.

* levelgen of three seeds per mode (easy, hard, memory), in fast and in
  parity mode, against the std::mt19937 C++ oracle, built as is and with
  the reference's float rand01 (see ``build_oracle``): grid, the entity
  list (types, x and y bit for bit) and the next raw draws of the step
  stream.  The enemies' velocity is the reference's double chain ``(.1 *
  rand01() + .1) * (randn(2) * 2 - 1)`` narrowed once (caveflyer.cpp:245):
  parity mode computes it so and matches the float-rand01 build's vx and vy
  bit for bit (the unmodified oracle's double draw at 1 ulp); fast mode
  rounds each float op in turn and is held to 1 ulp.  No JAX is compiled;
* the step, hard mode, 4 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState, then both
  packages step it and draw its frame.  Every state field and frame must
  agree bitwise after every step.  The seeded actions thrust, turn and
  fire; bullet hits on targets, obstacles, enemies and the goal (the pair
  collisions), bullets exploding on walls, targets destroyed and enemies
  reflecting off the cave walls are counted, and each must occur;
* the step in easy and memory modes, 120 steps, every field and frame
  bitwise (``pin_jax_render`` of tests/test_torch_fast_path.py pins the
  FMAs of the renderer's rects at easy mode's unit of 6.4);
* the port's fast path against its inline path, forced resets at t = 40,
  41 and 90.

The JAX side's float chains are pinned to the reference's roundings
(``pin_jax_roundings`` of tests/test_torch_fast_path.py, and the two
caveflyer sites below): on its fast path XLA:CPU contracts the agent's
``vx + px * .2`` (caveflyer.py:118-119) and the exhaust's ``x - rx *
cos(theta)`` (:193-196) into FMAs, computes ``cos``/``sin`` (:187-207,
:327-331) as float trig, and ``face_rotation`` (:340-344) as its own
arctan2 with the ``+ 0.0`` folded away.  And XLA:CPU flushes float32
denormals to zero: the ship's rotation speed halves every step it does not
turn, so after about 125 such steps the reference's (and the port's) speed
is a denormal where the JAX package's is 0; ``ents.vrot`` is compared with
the port's denormals read as zeros (``flush_denormals``).  A denormal speed
moves no rotation bit, so every other field stays bitwise.
"""

import os
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import fmath as j_fmath
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine import entity_ops as j_eo
from procgen_tpu.games import caveflyer as JC

from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import physics as ph
from procgen_torch.games import caveflyer as CF
from procgen_torch.games import make_game
from procgen_torch.state import init_state_template
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_fast_path import pin_jax_render, pin_jax_roundings

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 4
SEED = 31
MODES = [("easy", 0), ("hard", 1), ("memory", 3)]


# The oracles' RandGen::rand01 returns the double quotient, where the
# reference's (randgen.cpp:19-23, as chaser's and heist's oracles have it)
# narrows it to a float, so every chain that multiplies a draw runs in
# double in the oracle and in float in the reference.  The tests also build
# each oracle with the reference's rand01 (the one line replaced), and hold
# the port bit for bit against that build.
_DOUBLE_RAND01 = "double rand01() { return (double)g() / 4294967296.0; }"
_FLOAT_RAND01 = "float rand01() { return (float)((double)g() / 4294967296.0); }"


def build_oracle(name: str, float_rand01: bool, edits=(), tag: str = "") -> Path:
    """native/<name>_oracle.cpp built into native/build (g++ -O2), as is or
    with the reference's float rand01, and with ``edits`` (pairs of exact
    source text, each found once, and its replacement; ``tag`` names the
    build)."""
    src = REPO / "native" / f"{name}_oracle.cpp"
    suffix = ("_torch_f32rand" if float_rand01 else "_torch") + tag
    binary = REPO / "native" / "build" / f"{name}_oracle{suffix}"
    binary.parent.mkdir(exist_ok=True)
    if not binary.exists() or binary.stat().st_mtime < src.stat().st_mtime:
        text = src.read_text()
        if float_rand01:
            edits = ((_DOUBLE_RAND01, _FLOAT_RAND01),) + tuple(edits)
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        tmp = binary.with_name(f"{binary.name}.{os.getpid()}")
        tmp_src = tmp.with_suffix(".cpp")
        tmp_src.write_text(text)
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(tmp), str(tmp_src)], check=True)
        tmp_src.unlink()
        os.replace(tmp, binary)
    return binary


def run_oracle(binary: Path, seed: int, mode: int) -> list:
    return subprocess.run(
        [str(binary), str(seed), str(mode)], check=True, capture_output=True, text=True,
    ).stdout.splitlines()


@pytest.fixture(scope="session")
def caveflyer_oracle():
    binaries = {f: build_oracle("caveflyer", f) for f in (False, True)}

    def run(seed: int, mode: int, dim: int, float_rand01: bool):
        out = run_oracle(binaries[float_rand01], seed, mode)
        _, n_ents = map(int, out[0].split()[1:])
        rows = [list(map(int, line.split())) for line in out[1:1 + dim]]
        ents = []
        for line in out[1 + dim:1 + dim + n_ents]:
            t = line.split()[1:]
            ents.append((int(t[0]),) + tuple(float.fromhex(v) for v in t[1:5]))
        fp = list(map(int, out[1 + dim + n_ents].split()[1:]))
        return {"grid": np.asarray(rows), "ents": ents, "fp": fp}

    return run


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("mode,mode_i", MODES)
def test_caveflyer_levelgen_matches_oracle(caveflyer_oracle, mode, mode_i, parity):
    cfg = EnvConfig(env_name="caveflyer", num_envs=3, distribution_mode=DistributionMode[mode],
                    parity_mode=parity)
    gd = make_game(cfg)
    seeds = [8 + 19 * i for i in range(3)]
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    mt = R.mt_block_close(rs)

    ents = state.ents
    enemies = 0
    for i, seed in enumerate(seeds):
        for float_rand01 in (False, True):
            ref = caveflyer_oracle(seed, mode_i, gd.world_dim, float_rand01)
            where = f"seed {seed}, float rand01 {float_rand01}"
            np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=where)
            assert int(ents.alive[i].sum()) == len(ref["ents"]), where
            for k, (t, ex, ey, evx, evy) in enumerate(ref["ents"]):
                assert int(ents.type[i, k]) == t, (where, k)
                got = [_bits(ents.x[i, k]), _bits(ents.y[i, k])]
                assert got == [_bits(ex), _bits(ey)], (where, k)
                got = np.array([_bits(ents.vx[i, k]), _bits(ents.vy[i, k])], np.int64)
                want = np.array([_bits(evx), _bits(evy)], np.int64)
                # parity mode: the double chain of the reference's float
                # draw, bit for bit; fast mode: 1 ulp
                exact = parity and float_rand01
                assert np.abs(got - want).max() <= (0 if exact else 1), (where, k, got, want)
                enemies += t == CF.ENEMY
            one = R.MT(key=mt.key[i], pos=mt.pos[i])
            for want in ref["fp"]:
                one, x = R.mt_raw(one)
                assert int(x) == want, where
    assert enemies > 0


def _cfgs(mode="hard"):
    kw = dict(env_name="caveflyer", num_envs=N, rand_seed=SEED, use_generated_assets=True)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: fire (9) most of the time, else wait (4), thrust (5)
    or any action."""
    u = rs.rand(N)
    return np.where(
        u < 0.6, 9, np.where(u < 0.9, rs.choice([4, 4, 4, 5], size=N), rs.randint(0, 15, size=N))
    ).astype(np.int32)


def _stage(state, which):
    """Edit the new levels of ``which`` (many hard caves are too small for
    any object): a target one cell ahead of the ship's nose (the ship
    starts facing +y, where its bullets fly) and an enemy five cells to its
    right drifting towards it are appended, so that targets are shot down,
    enemies reflect off walls and ships die within an episode."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]
    target = eo.make_entity(ax, ay + 1, 0.0, 0.0, 0.5, 0.5, CF.TARGET)
    target.update(collides_with_entities=True, health=5.0)
    enemy = eo.make_entity(ax + 5, ay, -np.float32(0.15), 0.0, 0.5, 0.5, CF.ENEMY)
    enemy.update(collides_with_entities=True, smart_step=True)
    ents, _ = eo.append_entity(ents, target, active=which)
    ents, _ = eo.append_entity(ents, enemy, active=which)
    return state.replace(ents=ents)


def pin_caveflyer_chains(monkeypatch):
    """The reference package's caveflyer with its two contracted mul+add
    sites routed through the pinned ``fadd32`` (after pin_jax_roundings)."""
    F32 = jnp.float32

    def update_agent_velocity(self, cfg, state):
        ents = state.ents
        px = state.mixrate * state.maxspeed * state.action_vx
        py = state.mixrate * state.maxspeed * state.action_vy
        vx = j_fmath.fadd32(cfg, ents.vx[j_eo.AGENT], px * F32(0.2))
        vy = j_fmath.fadd32(cfg, ents.vy[j_eo.AGENT], py * F32(0.2))
        vx = j_fmath.dmul(cfg, vx, 0.9)
        vy = j_fmath.dmul(cfg, vy, 0.9)
        return state.replace(ents=j_eo.write_slot(ents, j_eo.AGENT, vx=vx, vy=vy))

    real_set_action = JC.CaveFlyer.set_action_xy

    def set_action_xy(self, cfg, state, move_action):
        # the exhaust's "x - rx * cos(theta)": the reference's exhaust slot is
        # rewritten with the product and the difference rounded in turn
        n0 = state.ents.count
        avx, avy, avrot, st = real_set_action(self, cfg, state, move_action)
        ents = state.ents
        theta = -ents.rotation[j_eo.AGENT] + F32(JC.PI / 2)
        ex = j_fmath.fadd32(cfg, ents.x[j_eo.AGENT],
                            -(ents.rx[j_eo.AGENT] * j_fmath.dcos(cfg, theta)))
        ey = j_fmath.fadd32(cfg, ents.y[j_eo.AGENT],
                            -(ents.ry[j_eo.AGENT] * j_fmath.dsin(cfg, theta)))
        added = st.ents.count > n0
        slot = jnp.minimum(n0, st.ents.capacity - 1)
        x = st.ents.x.at[slot].set(jnp.where(added, ex, st.ents.x[slot]))
        y = st.ents.y.at[slot].set(jnp.where(added, ey, st.ents.y[slot]))
        return avx, avy, avrot, st.replace(ents=st.ents.replace(x=x, y=y))

    monkeypatch.setattr(JC.CaveFlyer, "update_agent_velocity", update_agent_velocity)
    monkeypatch.setattr(JC.CaveFlyer, "set_action_xy", set_action_xy)


class Events:
    """Counts, from the port's inputs and outputs: bullets absorbed by the
    pair handler and targets it destroys, and enemy velocities negated by a
    grid reflection in a sub-step."""

    def __init__(self, monkeypatch):
        self.counts = dict(bullet_hits=0, targets_destroyed=0, reflections=0)
        real_pairs = CF.CaveFlyer.handle_collision_pairs
        real_sub = ph.sub_step

        def pairs(gd, cfg, state, pair_mask):
            out = real_pairs(gd, cfg, state, pair_mask)
            bullet = state.ents.alive & (state.ents.type == CF.PLAYER_BULLET)
            self.counts["bullet_hits"] += int((bullet & out.ents.will_erase & ~state.ents.will_erase).sum())
            target = state.ents.alive & (state.ents.type == CF.TARGET)
            self.counts["targets_destroyed"] += int((target & out.ents.will_erase & ~state.ents.will_erase).sum())
            return out

        def sub_step(gd, cfg, state, idxs, _vx, _vy, active, *args):
            out, blocked = real_sub(gd, cfg, state, idxs, _vx, _vy, active, *args)
            fields = ("vx", "vy", "type")
            before = {f: torch.gather(getattr(state.ents, f), 1, idxs) for f in fields}
            after = {f: torch.gather(getattr(out.ents, f), 1, idxs) for f in fields}
            flipped = (before["vx"] * after["vx"] < 0) | (before["vy"] * after["vy"] < 0)
            self.counts["reflections"] += int((flipped & active & (before["type"] == CF.ENEMY)).sum())
            return out, blocked

        monkeypatch.setattr(CF.CaveFlyer, "handle_collision_pairs", pairs)
        monkeypatch.setattr(ph, "sub_step", sub_step)


def test_caveflyer_step_matches_reference(monkeypatch):
    pin_jax_roundings(monkeypatch)
    pin_caveflyer_chains(monkeypatch)
    events = Events(monkeypatch)
    counts = dict(levels=N, goals=0, targets_shot=0, deaths=0, explosions=0, bullets=0)
    prev = None
    for state in stepped_against_reference(*_cfgs(), _policy, 250, prepare=_stage,
                                           ftz_fields=("ents.vrot",)):
        ents = state.ents
        counts["goals"] += int((state.reward >= CF.GOAL_REWARD).sum())
        counts["targets_shot"] += int((state.reward == CF.TARGET_REWARD).sum())
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        counts["bullets"] += int((ents.alive & (ents.type == CF.PLAYER_BULLET)).sum())
        expl = int((ents.alive & (ents.type == O.EXPLOSION) & (ents.life_time == 0)).sum())
        counts["explosions"] += expl
        counts["levels"] += int(state.done.sum())
        prev = state
    assert prev is not None
    counts.update(events.counts)
    for k in ("deaths", "bullets", "explosions", "bullet_hits", "targets_destroyed",
              "targets_shot", "reflections"):
        assert counts[k] > 0, counts
    assert counts["levels"] >= 2 * N, counts


@pytest.mark.parametrize("mode", ["easy", "memory"])
def test_caveflyer_step_matches_reference_other_modes(monkeypatch, mode):
    """Easy (a 30-cell world seen at visibility 10) and memory (60 cells,
    no widened path) modes, 120 steps, as the hard run: every field and
    frame bitwise.  At visibility 10 the view's unit is 6.4, where XLA:CPU
    contracts the sprite and background rects' mul+adds into FMAs; the JAX
    side is pinned there too (``pin_jax_render``)."""
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    pin_caveflyer_chains(monkeypatch)
    events = Events(monkeypatch)
    counts = dict(deaths=0, explosions=0, bullets=0)
    for state in stepped_against_reference(*_cfgs(mode), _policy, 120, prepare=_stage,
                                           ftz_fields=("ents.vrot",)):
        ents = state.ents
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        counts["bullets"] += int((ents.alive & (ents.type == CF.PLAYER_BULLET)).sum())
        counts["explosions"] += int((ents.alive & (ents.type == O.EXPLOSION)).sum())
    counts.update(events.counts)
    for k in ("bullets", "explosions", "bullet_hits"):
        assert counts[k] > 0, counts


def test_caveflyer_fast_path_matches_inline():
    check_fast_path_matches_inline(_cfgs()[1], _policy)
