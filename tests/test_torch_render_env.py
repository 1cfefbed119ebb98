"""procgen_torch's direct gather renderer (``render/renderer.py``) and the
512x512 ``render_mode`` info frame against procgen_tpu's, on the CPU, in the
default configuration (PNG assets from a synthetic root).

* ``render_env`` at res 128 for the six games of the card's render_mode
  phase (maze: static grid; miner: grid-dynamic; coinrun: center-agent view
  with adjusted sprite rects; jumper: HUD overlay; starpilot: the scrolling
  background painter; caveflyer: free rotation), hard mode, 3 envs, on the
  states of 24 random steps (every 8th), carried into the JAX package's
  EnvState: bitwise equal;
* the ``render_mode="rgb_array"`` info frame for maze and coinrun: ``(N,
  512, 512, 3)`` uint8, bitwise equal to the JAX package's own expression
  (procgen_tpu/env.py:144-151: ``render_env`` at 1024, box-filtered in
  integers with ``+ 2) // 4``);
* ``render_frame`` (the static layer plus the gather pass) for maze and
  chaser against the JAX package's (its matmul pass, which draws these
  games' unrotated sprites identically): bitwise;
* the scrolling-background painter (``GameDef.paint_dynamic_background``)
  at res 64 equals ``fast2.dynamic_bg_pass`` when the full background image
  is the 64x64 mip the pass samples: bitwise.

No pin is needed on these states.  The JAX renderer's blend ``rgb * a + out
* (1 - a)`` is contracted into an FMA by XLA:CPU; it moves a pixel only
under fractional alpha (bossfight's fading trails: ROADMAP section C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.render import renderer as j_renderer
from procgen_tpu.render.pack import RenderPack as JPack

from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.render import fast2, renderer
from test_torch_assets import asset_root_fixture
from test_torch_coinrun import JaxCarrier

torch.set_num_threads(1)

synth_root = asset_root_fixture()

N = 3
RENDER_MODE_GAMES = ("maze", "miner", "coinrun", "jumper", "starpilot", "caveflyer")


def _reference(game, n=N, mode="hard"):
    jcfg = JConfig(env_name=game, num_envs=n, rand_seed=11, distribution_mode=JMode[mode])
    jgd = j_make_game(jcfg)
    return jgd, jcfg, JPack(jgd, jcfg), JaxCarrier(jgd, jcfg)


def _stepped(env, steps, every, seed=1):
    """The env's state every ``every`` of ``steps`` random steps."""
    rs = np.random.RandomState(seed)
    for t in range(steps):
        env.act(rs.randint(0, 15, size=env.num))
        if t % every == every - 1:
            yield env.state


@pytest.mark.parametrize("game", RENDER_MODE_GAMES)
def test_render_env_matches_reference(synth_root, game):
    """Exact: every uint8 value at res 128."""
    env = ProcgenTorchEnv(N, game, rand_seed=11, distribution_mode="hard", device="cpu",
                          render=False)
    jgd, jcfg, jpack, carry = _reference(game)
    j_render = jax.jit(jax.vmap(lambda s: j_renderer.render_env(jgd, jcfg, s, jpack, res=128)))
    for k, state in enumerate(_stepped(env, 24, 8)):
        got = renderer.render_env(env.gd, env.cfg, state, env.pack, res=128)
        assert got.shape == (N, 128, 128, 3) and got.dtype == torch.uint8
        want = np.asarray(j_render(carry(state)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{game} at check {k}")
        assert (want > 0).mean() > 0.5


@pytest.mark.parametrize("game", ["maze", "coinrun"])
def test_info_frame_matches_reference(synth_root, game):
    """Exact: ``info["rgb"]`` of every env."""
    n = 2
    env = ProcgenTorchEnv(n, game, rand_seed=11, distribution_mode="hard", device="cpu",
                          render_mode="rgb_array")
    jgd, jcfg, jpack, carry = _reference(game, n)

    def hires(s):  # procgen_tpu/env.py:144-151
        big = j_renderer.render_env(jgd, jcfg, s, jpack, res=1024).astype(jnp.uint16)
        pooled = (big[0::2, 0::2] + big[1::2, 0::2] + big[0::2, 1::2] + big[1::2, 1::2] + 2) // 4
        return pooled.astype(jnp.uint8)

    j_hires = jax.jit(jax.vmap(hires))
    for state in _stepped(env, 6, 6):
        infos = env.get_info()
        got = np.stack([info["rgb"] for info in infos])
        assert got.shape == (n, 512, 512, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(j_hires(carry(state))), err_msg=game)
        assert infos[0]["level_seed"] == int(state.current_level_seed[0])


@pytest.mark.parametrize("game", ["maze", "chaser"])
def test_render_frame_matches_reference(synth_root, game):
    """Exact: every uint8 value at res 64."""
    env = ProcgenTorchEnv(N, game, rand_seed=11, distribution_mode="hard", device="cpu",
                          render=False)
    jgd, jcfg, jpack, carry = _reference(game)
    j_frame = jax.jit(jax.vmap(lambda s: j_renderer.render_frame(jgd, jcfg, s, jpack)))
    for state in _stepped(env, 16, 8):
        got = renderer.render_frame(env.gd, env.cfg, state, env.pack)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_frame(carry(state))), err_msg=game)


def test_background_painter_matches_fast2(synth_root):
    """Exact: the painter over the 64x64 mips equals the fast path's
    scrolling-background pass at res 64."""
    env = ProcgenTorchEnv(N, "starpilot", rand_seed=11, distribution_mode="hard",
                          device="cpu", render=False)
    gd, cfg = env.gd, env.cfg
    tables = renderer.get_gather_tables(gd, cfg, env.pack, "cpu")
    mips = type("MipTables", (), dict(bg_atlas=torch.as_tensor(env.pack.bg_mip64),
                                      bg_dims=torch.full_like(tables.bg_dims, 64)))
    for state in _stepped(env, 30, 10):
        SX, SY, _, _ = renderer._pixel_world_coords(state, 64)
        zero = torch.zeros((N, 64, 64, 3))
        got = gd.paint_dynamic_background(cfg, state, zero, SX, SY, mips)
        want = fast2.dynamic_bg_pass(gd, cfg, state, fast2.get_tables(gd, cfg, env.pack, "cpu"))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert int(state.cur_time[0]) > 0
