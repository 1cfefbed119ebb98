"""The port's counterparts of the JAX renderer's matmul paths
(``render_frames``, ``render_static_dispatch``, ``render_static_fast``,
``_grid_fast_one``, ``_composite_entities_matmul``,
``_paint_vel_info_batched`` in procgen_torch/render/renderer.py) against
procgen_tpu's, on the CPU, in the default configuration (PNG assets from a
synthetic root).

For each render class, maze hard (static grid), miner hard (grid-dynamic),
coinrun hard (a moving view; its velocity patch) and dodgeball hard (free
rotation: ``render_frames`` takes ``render_env``), 4 envs, on the states of
two points of a random run carried into the JAX package's EnvState: every
function's frames bit for bit, from one jit per game.  The canvas under
``_grid_fast_one``, ``_composite_entities_matmul`` and the velocity patch
is the state's static layer; those three return float32 canvases, held bit
for bit as frames and within 4 ulp of 255 as floats (XLA:CPU's contracted
blend, below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu.render import renderer as j_renderer

from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.render import renderer
from test_torch_assets import asset_root_fixture
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_render_env import _reference, _stepped

torch.set_num_threads(1)

synth_root = asset_root_fixture()

N = 4
GAMES = ("maze", "miner", "coinrun", "dodgeball")
OUTPUTS = ("render_frames", "render_static_dispatch", "render_static_fast", "_grid_fast_one",
           "_composite_entities_matmul", "_paint_vel_info_batched")


def outputs(r, gd, cfg, pack, states, canvas, each):
    """Every function's output on ``states`` (and the f32 ``canvas``)
    through the renderer module ``r``; ``each(fn, *args)`` applies a
    single-env function to every env (the JAX package's are written for one
    env) or a batched one to the batch."""
    return dict(
        render_frames=r.render_frames(gd, cfg, states, pack),
        render_static_dispatch=each(lambda s: r.render_static_dispatch(gd, cfg, s, pack), states),
        render_static_fast=each(lambda s: r.render_static_fast(gd, cfg, s, pack), states),
        _grid_fast_one=each(lambda s, c: r._grid_fast_one(gd, cfg, s, pack, c), states, canvas),
        _composite_entities_matmul=each(
            lambda s, c: r._composite_entities_matmul(gd, cfg, s, pack, c), states, canvas),
        _paint_vel_info_batched=r._paint_vel_info_batched(gd, cfg, states, canvas),
    )


@pytest.mark.parametrize("game", GAMES)
def test_matmul_paths_match_reference(synth_root, game, jax_x64_off):
    env = ProcgenTorchEnv(N, game, rand_seed=11, distribution_mode="hard", device="cpu",
                          render=False)
    jgd, jcfg, jpack, carry = _reference(game, N)
    want_fn = jax.jit(lambda s: outputs(j_renderer, jgd, jcfg, jpack, s,
                                        s.static_layer.astype(jnp.float32),
                                        lambda fn, *a: jax.vmap(fn)(*a)))
    drawn = 0
    for k, state in enumerate(_stepped(env, 16, 8)):
        want = want_fn(carry(state))
        got = outputs(renderer, env.gd, env.cfg, env.pack, state,
                      state.static_layer.to(torch.float32), lambda fn, *a: fn(*a))
        for name in OUTPUTS:
            a, b = got[name].numpy(), np.asarray(want[name])
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.shape, b.shape)
            where = f"{game} {name} at check {k}"
            if a.dtype == np.float32:
                # a canvas: its frame bit for bit, its floats within 4 ulp of
                # 255 (XLA:CPU contracts the blend rgb * a + out * (1 - a)
                # into an FMA, which moves a value under fractional alpha by
                # an ulp or two: ROADMAP section C)
                np.testing.assert_allclose(a, b, rtol=0, atol=4 * np.spacing(np.float32(255)),
                                           err_msg=where)
                a, b = (np.clip(x + np.float32(0.5), 0, 255).astype(np.uint8) for x in (a, b))
            np.testing.assert_array_equal(a, b, err_msg=where)
        frames = got["render_frames"]
        drawn += int((frames != state.static_layer).any(-1).sum())
        assert frames.shape == (N, 64, 64, 3) and (frames > 0).float().mean() > 0.5
    assert drawn > 0  # the entities changed pixels of the static layer
