"""procgen_torch's entity-entity collisions against procgen_tpu's, on random
entity tables.

* ``base.pair_collision_mask`` against a plain loop over slot pairs of
  bag.cpp:725-736 as the reference package has it (procgen_tpu
  engine/base.py:437-453): i collides with entities, i and j overlap by
  i's margin, both alive and not marked for erasure, i != j;
* caveflyer's and dodgeball's ``handle_collision_pairs`` against the JAX
  package's on the same tables and masks: every entity field and the
  reward bit for bit, the appended explosions and dust clouds included;
* the sequential entity-reflect sweep: ``physics.sub_step`` of dodgeball
  against the JAX package's (procgen_tpu engine/physics.py:244-290) on
  random tables of lava walls and enemies, both axes, every field and the
  blocked flags bit for bit; the sweep over every slot and over the slots
  that can reflect (as ``step_entities`` cuts it) agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine import physics as j_ph
from procgen_tpu.games import make_game as j_make_game

from procgen_torch import convert
from procgen_torch import objects as O
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import physics as ph
from procgen_torch.engine.base import pair_collision_mask
from procgen_torch.games import caveflyer as CF
from procgen_torch.games import dodgeball as DB
from procgen_torch.games import make_game
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import seeded_template
from test_torch_coinrun import JaxCarrier
from test_torch_fast_path import assert_fields_equal, jax_fields

torch.set_num_threads(1)

N = 4  # JaxCarrier's batch


def _cfgs(game):
    kw = dict(env_name=game, num_envs=N, rand_seed=7, use_generated_assets=True,
              distribution_mode=DistributionMode.hard)
    j_cfg = JConfig(**{**kw, "distribution_mode": JMode.hard})
    return j_cfg, EnvConfig(**kw)


def _template(gd, cfg):
    """A template batch with its world dims and view set."""
    state = gd.choose_world_dim(cfg, seeded_template(gd, cfg, N, device="cpu"))
    return update_view_params(gd, cfg, state)


def _random_table(state, rs, types, live, box=4.0):
    """The state's entity table with ``live`` random live slots per env (a
    prefix), types drawn from ``types``, boxes in a ``box``-wide square."""
    ents = state.ents
    E = ents.capacity
    n = torch.as_tensor(rs.randint(live // 2, live + 1, size=N))
    alive = torch.arange(E)[None, :] < n[:, None]

    def f32(v):
        return torch.as_tensor(np.float32(v))

    upd = dict(
        alive=alive,
        type=torch.where(alive, torch.as_tensor(rs.choice(types, size=(N, E)), dtype=torch.int32), 0),
        x=f32(rs.uniform(0, box, (N, E))), y=f32(rs.uniform(0, box, (N, E))),
        rx=f32(rs.choice([0.1, 0.25, 0.5, 0.75], (N, E))),
        vx=f32(rs.uniform(-0.3, 0.3, (N, E))), vy=f32(rs.uniform(-0.3, 0.3, (N, E))),
        ry=f32(rs.choice([0.1, 0.25, 0.5], (N, E))),
        will_erase=torch.as_tensor(rs.rand(N, E) < 0.1) & alive,
        collides_with_entities=torch.as_tensor(rs.rand(N, E) < 0.8),
        collision_margin=f32(rs.choice([0.0, 0.0, 0.1], (N, E))),
        health=f32(rs.choice([1.0, 2.0, 5.0], (N, E))),
    )
    upd["type"][:, 0] = O.PLAYER
    return state.replace(ents=ents.replace(**upd))


def _loop_mask(ents):
    e = {k: getattr(ents, k).numpy() for k in (
        "x", "y", "rx", "ry", "collision_margin", "collides_with_entities", "alive", "will_erase")}
    n, E = e["x"].shape
    out = np.zeros((n, E, E), bool)
    for b in range(n):
        for i in range(E):
            for j in range(E):
                tx = e["rx"][b, i] + e["rx"][b, j] + e["collision_margin"][b, i]
                ty = e["ry"][b, i] + e["ry"][b, j] + e["collision_margin"][b, i]
                out[b, i, j] = (
                    i != j and e["collides_with_entities"][b, i]
                    and e["alive"][b, i] and e["alive"][b, j]
                    and not e["will_erase"][b, i] and not e["will_erase"][b, j]
                    and abs(e["x"][b, i] - e["x"][b, j]) < tx
                    and abs(e["y"][b, i] - e["y"][b, j]) < ty
                )
    return out


GAMES = {
    "caveflyer": (CF, [CF.GOAL, CF.OBSTACLE, CF.TARGET, CF.ENEMY, CF.PLAYER_BULLET,
                       CF.PLAYER_BULLET, CF.EXHAUST]),
    "dodgeball": (DB, [DB.LAVA_WALL, DB.PLAYER_BALL, DB.PLAYER_BALL, DB.ENEMY, DB.DOOR,
                       DB.ENEMY_BALL]),
}


@pytest.mark.parametrize("game", sorted(GAMES))
def test_pair_handlers_match_reference(game):
    j_cfg, cfg = _cfgs(game)
    gd, j_gd = make_game(cfg), j_make_game(j_cfg)
    carry = JaxCarrier(j_gd, j_cfg)
    handler = jax.jit(jax.vmap(lambda s, m: j_gd.handle_collision_pairs(j_cfg, s, m)))
    rs = np.random.RandomState(3)
    base = _template(gd, cfg)
    base = base.replace(step_rand_int=torch.as_tensor(rs.randint(0, 10**6, N), dtype=torch.int32))
    hits = 0
    for trial in range(6):
        state = _random_table(base, rs, GAMES[game][1], live=min(20, gd.max_entities - 8))
        mask = pair_collision_mask(state.ents, state.ents.capacity)
        np.testing.assert_array_equal(mask.numpy(), _loop_mask(state.ents))
        got = gd.handle_collision_pairs(cfg, state, mask)
        want = handler(carry(state), jnp.asarray(mask.numpy()))
        assert_fields_equal(jax_fields(want), convert.state_to_numpy(got), f"trial {trial}")
        hits += int((got.ents.will_erase & ~state.ents.will_erase).sum())
    assert hits > 10


def test_entity_reflect_sweep_matches_reference():
    j_cfg, cfg = _cfgs("dodgeball")
    gd, j_gd = make_game(cfg), j_make_game(j_cfg)
    carry = JaxCarrier(j_gd, j_cfg)
    sub = jax.jit(jax.vmap(lambda s, i, vx, vy, a: j_ph.sub_step(j_gd, j_cfg, s, i, vx, vy, a)))
    rs = np.random.RandomState(4)
    base = _template(gd, cfg)
    base = base.replace(grid=torch.full_like(base.grid, O.SPACE))
    E = base.ents.capacity
    reflections = 0
    for trial in range(6):
        state = _random_table(base, rs, [DB.LAVA_WALL, DB.LAVA_WALL, DB.ENEMY, DB.DOOR],
                              live=E - 10, box=6.0)
        ents = state.ents
        smart = ents.alive & (ents.type == DB.ENEMY)
        state = state.replace(ents=ents.replace(smart_step=smart))
        # every slot as a mover, active where it is a live enemy (the
        # sweep's validity excludes the mover's own slot)
        M = E
        idxs = torch.arange(M).expand(N, M).contiguous()
        for horizontal in (True, False):
            v = state.ents.vx if horizontal else state.ents.vy
            _vx = torch.where(torch.as_tensor(horizontal), v, 0.0)
            _vy = torch.where(torch.as_tensor(horizontal), 0.0, v)
            want_s, want_b = sub(carry(state), jnp.asarray(idxs.numpy()), jnp.asarray(_vx.numpy()),
                                 jnp.asarray(_vy.numpy()), jnp.asarray(smart.numpy()))
            cands = [b for b in range(E - 1, -1, -1)
                     if bool((state.ents.alive[:, b] & (state.ents.type[:, b] == DB.LAVA_WALL)).any())]
            for slots in (list(range(E - 1, -1, -1)), cands):
                got_s, got_b = ph.sub_step(gd, cfg, state, idxs, _vx, _vy, smart, None, slots)
                where = f"trial {trial}, horizontal {horizontal}, {len(slots)} slots"
                assert_fields_equal(jax_fields(want_s), convert.state_to_numpy(got_s), where)
                np.testing.assert_array_equal(np.asarray(want_b), got_b.numpy(), err_msg=where)
            flipped = (got_s.ents.vx * state.ents.vx < 0) | (got_s.ents.vy * state.ents.vy < 0)
            reflections += int((flipped & smart).sum())
            state = got_s
    assert reflections > 10
