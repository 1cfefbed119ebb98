"""procgen_torch engine pieces outside the fast path's main loop.

* fmath helpers against numpy's IEEE float32 (fast mode) and float64
  (parity mode) expressions;
* ``write_slot_masked``;
* the entity appends and ``find_entity_index`` against procgen_tpu's on
  random tables, and ``fsign`` on both IEEE zeros;
* the inline-reset ``step_env`` and the non-cold fast-path ``init`` against
  procgen_tpu's, maze hard, every field bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine import entity_ops as j_eo
from procgen_tpu.engine.game import reset_env as j_reset_env
from procgen_tpu.engine.game import step_env as j_step_env
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.parallel.fast import make_fast_fns as j_make_fast_fns
from procgen_tpu.render.pack import RenderPack as JPack
from procgen_tpu.render.renderer import update_view_params as j_view
from procgen_tpu.state import EntityTable as JTable
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch import fmath as fm
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.game import reset_env, step_env
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import _ENTITY_FIELDS, EntityTable, empty_entity_table, seeded_template

torch.set_num_threads(1)


class _Cfg:
    def __init__(self, parity_mode):
        self.parity_mode = parity_mode


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_fmath_matches_ieee_expressions():
    rs = np.random.RandomState(1)
    a = rs.uniform(-50, 50, 4096).astype(np.float32)
    b = rs.uniform(0.1, 9, 4096).astype(np.float32)
    o = rs.uniform(-5, 5, 4096).astype(np.float32)
    ta, tb, to = (torch.as_tensor(v) for v in (a, b, o))
    f32, f64 = np.float32, np.float64
    fast, par = _Cfg(False), _Cfg(True)
    cases = [
        (fm.dmul(fast, ta, 0.9), a * f32(0.9)),
        (fm.dadd(fast, ta, 0.2), a + f32(0.2)),
        (fm.fdiv(fast, ta, tb), a / b),
        (fm.dmuladd(fast, ta, 0.2, 1.5), f32(1.5) + f32(0.2) * a),
        (fm.fmuladd32(fast, ta, tb, to), a * b + o),
        (fm.fadd32(fast, ta * tb, to * tb), a * b + o * b),
        (fm.div_const(ta, 255.0), a / f32(255.0)),
        (fm.seq(fast, ta), a),
        (fm.narrow(fm.wide(fast, ta)), a),
        (fm.dmul(par, ta, 0.9), (a.astype(f64) * 0.9).astype(f32)),
        (fm.dadd(par, ta, 0.2), (a.astype(f64) + 0.2).astype(f32)),
        (fm.fdiv(par, ta, tb), (a.astype(f64) / b.astype(f64)).astype(f32)),
        (fm.dmuladd(par, ta, 0.2, 1.5), (f64(f32(1.5)) + 0.2 * a.astype(f64)).astype(f32)),
        (fm.narrow(fm.wide(par, ta) * 0.9), (a.astype(f64) * 0.9).astype(f32)),
    ]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want), err_msg=f"case {i}")
    assert fm.wide(par, ta).dtype == torch.float64


def test_write_slot_masked():
    ents = empty_entity_table(3, 2, "cpu")
    mask = torch.tensor([True, False, True])
    out = eo.write_slot_masked(ents, 1, mask, x=torch.tensor([1.0, 2.0, 3.0]), alive=True)
    np.testing.assert_array_equal(out.x[:, 1].numpy(), [1.0, 0.0, 3.0])
    np.testing.assert_array_equal(out.alive[:, 1].numpy(), [True, False, True])
    assert not out.alive[:, 0].any() and not ents.alive.any()  # input untouched


def _random_fields(rs, n, e):
    """Numpy (n, e) arrays of every entity field (``alive`` excluded)."""
    out = {}
    for name, dtype in _ENTITY_FIELDS.items():
        if name == "alive":
            continue
        if dtype == torch.float32:
            out[name] = rs.uniform(-9, 9, (n, e)).astype(np.float32)
        elif dtype == torch.int32:
            out[name] = rs.randint(-3, 12, (n, e)).astype(np.int32)
        else:
            out[name] = rs.rand(n, e) < 0.5
    return out


def test_entity_appends_match_reference():
    n, e = 16, 6
    rs = np.random.RandomState(12)
    table = _random_fields(rs, n, e)
    table["alive"] = np.arange(e)[None, :] < rs.randint(0, e + 1, (n, 1))  # a prefix
    table["x"][0, 0] = -0.0  # signed zeros move bit for bit
    cand = _random_fields(rs, n, e)
    mask = rs.rand(n, e) < 0.4
    active = rs.rand(n) < 0.7
    ax, ay = rs.uniform(0, 5, n).astype(np.float32), rs.uniform(0, 5, n).astype(np.float32)

    j_ents = JTable(**{k: jnp.asarray(v) for k, v in table.items()})
    t_ents = EntityTable(**{k: torch.as_tensor(v) for k, v in table.items()})

    def j_all(ents, cand, mask, active, x, y):
        one, slot = j_eo.append_entity(ents, j_eo.make_entity(x, y, 0.5, -0.5, 0.4, 0.4, 7), active)
        down = j_eo.append_entities_masked(ents, cand, mask, descending=True)
        up = j_eo.append_entities_masked(ents, cand, mask, descending=False)
        return one, slot, down, up, j_eo.find_entity_index(ents, 3)

    j_out = jax.jit(jax.vmap(j_all))(
        j_ents, {k: jnp.asarray(v) for k, v in cand.items()}, jnp.asarray(mask),
        jnp.asarray(active), jnp.asarray(ax), jnp.asarray(ay),
    )
    t_cand = {k: torch.as_tensor(v) for k, v in cand.items()}
    one, slot = eo.append_entity(
        t_ents, eo.make_entity(torch.as_tensor(ax), torch.as_tensor(ay), 0.5, -0.5, 0.4, 0.4, 7),
        torch.as_tensor(active),
    )
    t_out = (
        one, slot,
        eo.append_entities_masked(t_ents, t_cand, torch.as_tensor(mask), descending=True),
        eo.append_entities_masked(t_ents, t_cand, torch.as_tensor(mask), descending=False),
        eo.find_entity_index(t_ents, 3),
    )
    for i, (want, got) in enumerate(zip(j_out, t_out)):
        if isinstance(got, EntityTable):
            for name in _ENTITY_FIELDS:
                a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
                if a.dtype == np.float32:
                    a, b = a.view(np.int32), b.view(np.int32)
                np.testing.assert_array_equal(a, b, err_msg=f"output {i} field {name}")
        else:
            np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=f"output {i}")
    full = t_ents.alive.all(1)
    assert (one.alive.sum(1) == t_ents.alive.sum(1) + (torch.as_tensor(active) & ~full)).all()

    z = torch.tensor([0.0, -0.0, 2.5, -3.0])
    np.testing.assert_array_equal(_bits(fm.fsign(z).numpy()), _bits([0.0, 0.0, 1.0, -1.0]))


def test_inline_step_and_init_match_reference():
    n, seed = 4, 29
    jcfg = JConfig(env_name="maze", num_envs=n, distribution_mode=JMode.hard,
                   rand_seed=seed, use_generated_assets=True)
    jgd = j_make_game(jcfg)
    tmpl = j_template(jgd, jcfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), tmpl)
    master = JR.HostMT(seed)
    seeds = jnp.asarray([master.randint_full() for _ in range(n)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    j_states = jax.jit(jax.vmap(lambda s: j_view(jgd, jcfg, j_reset_env(jgd, jcfg, s))))(batched)
    j_step = jax.jit(jax.vmap(lambda s, a: j_view(jgd, jcfg, j_step_env(jgd, jcfg, s, a))))

    cfg = EnvConfig(env_name="maze", num_envs=n, distribution_mode=DistributionMode.hard,
                    rand_seed=seed, use_generated_assets=True)
    gd = make_game(cfg)
    states = update_view_params(gd, cfg, reset_env(gd, cfg, seeded_template(gd, cfg, n, "cpu")))

    def check(want_tree, got: dict, where):
        want = convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(want_tree)[0])
        assert sorted(want) == sorted(got)
        for k in want:
            a, b = want[k], got[k]
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"{k} {where}")

    # non-cold init of the fast path from reset states
    j_init, _ = j_make_fast_fns(jgd, jcfg, JPack(jgd, jcfg), refill_bucket=2)
    init, _ = make_fast_fns(gd, cfg, RenderPack(gd, cfg), refill_bucket=2)
    fs = init(states)
    check(jax.jit(j_init)(j_states), convert.fast_state_to_numpy(fs), "after init")
    again = convert.fast_state_to_numpy(
        convert.fast_state_from_numpy(convert.fast_state_to_numpy(fs), "cpu")
    )
    for k, v in convert.fast_state_to_numpy(fs).items():
        np.testing.assert_array_equal(v, again[k], err_msg=k)

    rs = np.random.RandomState(4)
    dones = 0
    for t in range(60):
        acts = np.full((n,), -1, np.int32) if t in (20, 21) else rs.randint(0, 15, size=n).astype(np.int32)
        j_states = j_step(j_states, jnp.asarray(acts))
        states = update_view_params(gd, cfg, step_env(gd, cfg, states, torch.as_tensor(acts)))
        dones += int(states.done.sum())
        check(j_states, convert.state_to_numpy(states), f"at step {t}")
    assert dones >= 2 * n
