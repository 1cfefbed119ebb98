"""procgen_torch's leaper against procgen_tpu.

* the fast path, hard mode, step by step (the harness of
  tests/test_torch_grid_dynamic.py): 4 envs, refill bucket 2, 80 steps,
  forced resets at t = 40 and 41.  Every refill runs the traffic pre-roll
  (300 spawn and physics iterations); the frames draw the tiled finish line
  and the cars and frog in their axis rotation bins;
* ``reset_env`` (with the view parameters) in easy and extreme mode
  (pre-rolls of 360 and 200 iterations), every field bit for bit;
* ``entity_vs_all`` and ``has_any_collision_mask`` on seeded tables whose
  boxes touch exactly (the strict ``<`` of has_collision).

The JAX side's random agent spawn is pinned to the reference's roundings
(``pin_jax_roundings`` of tests/test_torch_fast_path.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine import entity_ops as j_eo
from procgen_tpu.engine import game as j_game
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.render import renderer as j_renderer
from procgen_tpu.state import empty_entity_table as j_empty_table
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.game import reset_env
from procgen_torch.games import make_game
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import EntityTable, seeded_template
from test_torch_fast_path import assert_fields_equal, jax_fields, pin_jax_roundings
from test_torch_grid_dynamic import run_against_reference

torch.set_num_threads(1)

N = 4
SEED = 17


def test_leaper_fast_path_matches_reference(monkeypatch):
    pin_jax_roundings(monkeypatch)  # the random agent spawn
    # random hops rarely cross 15 rows in 80 steps, so no reward is asked
    # for; the forced resets at t = 40 and 41 run the refill and its pre-roll
    run_against_reference("leaper", "hard", 80, expect_reward=False)


@pytest.mark.parametrize("mode", ["easy", "extreme"])
def test_leaper_reset_matches_reference(mode, monkeypatch):
    pin_jax_roundings(monkeypatch)  # the random agent spawn
    kw = dict(env_name="leaper", num_envs=N, rand_seed=SEED, use_generated_assets=True)
    j_cfg = JConfig(distribution_mode=JMode[mode], **kw)
    j_gd = j_make_game(j_cfg)
    tmpl = j_template(j_gd, j_cfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), tmpl)
    master = JR.HostMT(SEED)
    seeds = jnp.asarray([master.randint_full() for _ in range(N)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    want = jax.jit(jax.vmap(
        lambda s: j_renderer.update_view_params(j_gd, j_cfg, j_game.reset_env(j_gd, j_cfg, s))
    ))(batched)

    cfg = EnvConfig(distribution_mode=DistributionMode[mode], **kw)
    gd = make_game(cfg)
    assert gd.preroll_steps == {"easy": 360, "extreme": 200}[mode]
    got = update_view_params(gd, cfg, reset_env(gd, cfg, seeded_template(gd, cfg, N, device="cpu")))
    assert_fields_equal(jax_fields(want), convert.state_to_numpy(got), f"leaper {mode} reset")
    assert int(got.ents.alive.sum(1).max()) > 2  # the pre-roll spawned traffic


def _seeded_tables(n: int, e: int, seed: int):
    """numpy fields of n tables of e slots on a 0.25 grid (so boxes touch
    exactly), plus one query box per table."""
    rs = np.random.RandomState(seed)
    f = {
        "x": rs.randint(0, 40, size=(n, e)) * 0.25,
        "y": rs.randint(0, 40, size=(n, e)) * 0.25,
        "rx": rs.choice([0.25, 0.45, 0.5], size=(n, e)),
        "ry": rs.choice([0.25, 0.45, 0.5], size=(n, e)),
    }
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f["alive"] = rs.rand(n, e) < 0.7
    f["avoids_collisions"] = rs.rand(n, e) < 0.2
    q = {k: (rs.randint(0, 40, size=n) * 0.25).astype(np.float32) for k in ("x", "y")}
    q["rx"] = rs.choice([0.25, 0.5], size=n).astype(np.float32)
    q["ry"] = rs.choice([0.25, 0.5], size=n).astype(np.float32)
    return f, q


def test_entity_collision_masks_match_reference():
    n, e = 6, 48
    f, q = _seeded_tables(n, e, seed=3)
    j_empty = jax.vmap(lambda _: j_empty_table(e))(jnp.arange(n))
    j_ents = j_empty.replace(**{k: jnp.asarray(v) for k, v in f.items()})
    fields = convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(j_ents)[0])
    ents = EntityTable(**{k: torch.as_tensor(np.array(v)) for k, v in fields.items()})

    qx, qy, qrx, qry = (q[k] for k in ("x", "y", "rx", "ry"))
    cases = {
        "vs_all": (
            jax.vmap(j_eo.entity_vs_all)(j_ents, qx, qy, qrx, qry),
            eo.entity_vs_all(ents, *(torch.as_tensor(v) for v in (qx, qy, qrx, qry))),
        ),
        "vs_all_neg_margin": (
            jax.vmap(j_eo.entity_vs_all)(j_ents, qx, qy, qrx, qry, -qrx),
            eo.entity_vs_all(ents, *(torch.as_tensor(v) for v in (qx, qy, qrx, qry, -qrx))),
        ),
        "any_collision": (
            jax.vmap(lambda t, *a: j_eo.has_any_collision_mask(t, *a))(j_ents, qx, qy, qrx, qry),
            eo.has_any_collision_mask(ents, *(torch.as_tensor(v) for v in (qx, qy, qrx, qry))),
        ),
    }
    for name, (want, got) in cases.items():
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=name)
    touching = np.asarray(
        (np.abs(qx[:, None] - f["x"]) == qrx[:, None] + f["rx"])
        | (np.abs(qy[:, None] - f["y"]) == qry[:, None] + f["ry"])
    )
    assert touching.any() and np.asarray(cases["vs_all"][0]).any()
