"""The port's renderer against procgen_tpu.render.fast2 on maze states
(and the free rotation of caveflyer and dodgeball, and starpilot's
scrolling background).

RenderPack arrays are equal array for array.  States come from the JAX
package (reset + random steps) and are converted with procgen_torch.convert;
the port's entity records equal the JAX ones by value (the JAX z-sort is an
einsum, which turns -0.0 into +0.0), and ``render_static2`` and
``render_frames2`` give bitwise-equal uint8 frames.  Memory mode covers the
center-agent view.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine.game import reset_env as j_reset_env
from procgen_tpu.engine.game import step_env as j_step_env
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.render import fast2 as j_fast2
from procgen_tpu.render.pack import RenderPack as JPack
from procgen_tpu.render.renderer import update_view_params as j_view
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from procgen_torch.render import fast2
from procgen_torch.render.pack import RenderPack
from test_torch_assets import asset_root_fixture

torch.set_num_threads(1)

N = 6


def _jax_states(mode, steps=15, seed=23):
    cfg = JConfig(
        env_name="maze", num_envs=N, distribution_mode=JMode[mode], rand_seed=seed,
        use_generated_assets=True,
    )
    gd = j_make_game(cfg)
    pack = JPack(gd, cfg)
    tmpl = j_template(gd, cfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), tmpl)
    master = JR.HostMT(seed)
    seeds = jnp.asarray([master.randint_full() for _ in range(N)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    states = jax.jit(jax.vmap(lambda s: j_view(gd, cfg, j_reset_env(gd, cfg, s))))(batched)
    step = jax.jit(jax.vmap(lambda s, a: j_view(gd, cfg, j_step_env(gd, cfg, s, a))))
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        states = step(states, jnp.asarray(rs.randint(0, 15, size=N), jnp.int32))
    states = states.replace(static_layer=j_fast2.render_static2(gd, cfg, states, pack))
    return gd, cfg, pack, states


def _port(mode, seed=23):
    cfg = EnvConfig(
        env_name="maze", num_envs=N, distribution_mode=DistributionMode[mode],
        rand_seed=seed, use_generated_assets=True,
    )
    gd = make_game(cfg)
    return gd, cfg, RenderPack(gd, cfg)


@pytest.mark.parametrize("mode", ["easy", "hard", "memory"])
def test_render_matches_reference(mode):
    jgd, jcfg, jpack, jstates = _jax_states(mode)
    gd, cfg, pack = _port(mode)

    # host tables, array for array
    names = sorted(k for k in vars(jpack) if not k.startswith("_"))
    assert names == sorted(k for k in vars(pack) if not k.startswith("_"))
    for k in names:
        a, b = getattr(jpack, k), getattr(pack, k)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=f"RenderPack.{k}")

    fields = convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(jstates)[0])
    states = convert.state_from_numpy(fields, "cpu")

    static = fast2.render_static2(gd, cfg, states, pack)
    np.testing.assert_array_equal(np.asarray(jstates.static_layer), static.numpy())

    j_tables = j_fast2.get_tables(jgd, jcfg, jpack)
    j_rec, j_kmax = jax.jit(
        lambda s: j_fast2.entity_records(jgd, jcfg, s, j_tables, False)
    )(jstates)
    rec, kmax = fast2.entity_records(gd, cfg, states, fast2.get_tables(gd, cfg, pack, "cpu"))
    np.testing.assert_array_equal(np.asarray(j_rec), rec.numpy())  # by value
    assert int(j_kmax) == int(kmax)

    want = jax.jit(lambda s: j_fast2.render_frames2(jgd, jcfg, s, jpack))(jstates)
    got = fast2.render_frames2(gd, cfg, states, pack)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() > 0).mean() > 0.9  # not a black frame


@pytest.mark.parametrize("game", ["caveflyer", "dodgeball"])
def test_free_rotation_matches_reference(game):
    """The 16-bin free-rotation atlas, array for array, and the records each
    entity draws with (``fast2.entity_records``: the bin round(rotation *
    16 / 2 pi) mod 16, mirrored to (16 - a) % 16 when reflected) on
    rotations up to +-300 rad (caveflyer's ship turns without a bound)."""
    from test_torch_coinrun import JaxCarrier, _port_reset

    kw = dict(env_name=game, num_envs=4, rand_seed=5, use_generated_assets=True)
    jcfg = JConfig(distribution_mode=JMode.hard, **kw)
    cfg = EnvConfig(distribution_mode=DistributionMode.hard, **kw)
    jgd, gd = j_make_game(jcfg), make_game(cfg)
    jpack, pack = JPack(jgd, jcfg), RenderPack(gd, cfg)
    assert pack.rot_bins == 16
    for k in sorted(k for k in vars(jpack) if not k.startswith("_")):
        np.testing.assert_array_equal(getattr(jpack, k), getattr(pack, k), err_msg=f"RenderPack.{k}")

    from procgen_torch.state import seeded_template

    state = _port_reset(gd, cfg, pack, seeded_template(gd, cfg, 4, device="cpu"),
                        torch.ones(4, dtype=torch.bool))
    rs = np.random.RandomState(11)
    E = state.ents.capacity
    rot = rs.uniform(-300, 300, (4, E)).astype(np.float32)
    rot[:, :8] = np.float32([0, np.pi, -np.pi, np.pi / 8, -np.pi / 8, 300, -300, 1e-3])
    ents = state.ents.replace(
        alive=torch.ones_like(state.ents.alive), rotation=torch.as_tensor(rot),
        is_reflected=torch.as_tensor(rs.rand(4, E) < 0.5),
        type=torch.where(state.ents.alive, state.ents.type, state.ents.type[:, 1:2]),
        image_type=torch.where(state.ents.alive, state.ents.image_type, state.ents.image_type[:, 1:2]),
    )
    state = state.replace(ents=ents)
    j_tables = j_fast2.get_tables(jgd, jcfg, jpack)
    j_rec, j_kmax = jax.jit(lambda s: j_fast2.entity_records(jgd, jcfg, s, j_tables, False))(
        JaxCarrier(jgd, jcfg)(state))
    rec, kmax = fast2.entity_records(gd, cfg, state, fast2.get_tables(gd, cfg, pack, "cpu"))
    want, got = np.asarray(j_rec), rec.numpy()
    assert int(j_kmax) == int(kmax)
    bins = got[..., 4] % 16  # the variant's rotation bin (slot * 16 + bin)
    assert len(np.unique(bins[got[..., 7] > 0])) == 16
    # XLA:CPU contracts the rotated box's |c| * w + |s| * h into an FMA
    # (procgen_tpu/render/fast2.py:408-409); the port rounds each product.
    # Off the axis bins the box (columns 0-3) is held at 2 ulp, every other
    # value by value.
    box = np.zeros(got.shape, bool)
    box[..., :4] = (bins % 4 != 0)[..., None]
    np.testing.assert_array_equal(np.where(box, 0, want), np.where(box, 0, got))
    ulps = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32).astype(np.int64))
    assert ulps[box].max() <= 2, ulps[box].max()


synth_root = asset_root_fixture()


@pytest.mark.parametrize("use_backgrounds", [True, False])
def test_dynamic_bg_pass_matches_reference(synth_root, use_backgrounds):
    """Starpilot's scrolling background: ``fast2.dynamic_bg_pass`` (direct
    gathers) against the JAX pass (two one-hot bf16 products), float32
    canvases bit for bit, on 64 envs at random times (0-1000 steps, the
    tile edges of the first frames and past the strip's end) over
    random 64x64 background mips, every texel distinct in most rows; and
    ``render_static2``'s cached mip over the pack's backgrounds (each
    selected and resampled from its own size)."""
    from test_torch_coinrun import JaxCarrier, _port_reset

    n = 64
    kw = dict(env_name="starpilot", num_envs=n, rand_seed=5, use_backgrounds=use_backgrounds)
    jcfg = JConfig(distribution_mode=JMode.hard, **kw)
    cfg = EnvConfig(distribution_mode=DistributionMode.hard, **kw)
    jgd, gd = j_make_game(jcfg), make_game(cfg)
    jpack, pack = JPack(jgd, jcfg), RenderPack(gd, cfg)
    from procgen_torch.state import seeded_template

    state = _port_reset(gd, cfg, pack, seeded_template(gd, cfg, n, device="cpu"),
                        torch.ones(n, dtype=torch.bool))
    jstate = JaxCarrier(jgd, jcfg)(state)
    np.testing.assert_array_equal(
        np.asarray(j_fast2.render_static2(jgd, jcfg, jstate, jpack)),
        fast2.render_static2(gd, cfg, state, pack).numpy())
    assert len(np.unique(state.background_index.numpy())) > 1

    rs = np.random.RandomState(13)
    t = rs.randint(0, 1001, size=n).astype(np.int32)  # an episode's 1000 steps
    # the tile edges of the first frames, and past the end of the strip
    t[:12] = [0, 1, 2, 3, 59, 60, 61, 239, 240, 241, 4320, 5000]
    mips = rs.randint(0, 256, size=(n, 64, 64, 3)).astype(np.uint8)
    state = state.replace(cur_time=torch.as_tensor(t), static_layer=torch.as_tensor(mips))
    jstate = JaxCarrier(jgd, jcfg)(state)
    want = jax.jit(lambda s: j_fast2.dynamic_bg_pass(jgd, jcfg, s, j_fast2.get_tables(jgd, jcfg, jpack)))(jstate)
    got = fast2.dynamic_bg_pass(gd, cfg, state, fast2.get_tables(gd, cfg, pack, "cpu"))
    want = np.asarray(want)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(want.view(np.int32), got.numpy().view(np.int32))
    if use_backgrounds:
        # the strip covers the frame for an episode, and runs out by t = 4320
        assert (got.numpy()[t <= 1000] > 0).mean() > 0.98
        assert not got[t >= 4320].any()
    else:
        assert not got.any()
