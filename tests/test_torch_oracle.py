"""procgen_torch's observation oracle (``render/oracle.py``) on the CPU, in
the default configuration (PNG assets from a synthetic root).

* for all 16 games, hard mode, 4 envs, on the states of 12 random steps
  (every 4th; env 0 forced to reset at step 5): ``oracle_obs`` equals
  ``fast2.render_frames2`` (here the compositor's plain version; on the card
  ``chip_smoke.py``'s ``oracle`` phase holds the kernel's frames to it) and
  ``oracle_static`` equals ``fast2.render_static2``, bitwise;
* for maze (a static grid) and coinrun (a center-agent view with adjusted
  sprite rects) the port's oracle equals the JAX package's ``oracle_obs``
  and ``oracle_static`` on the same states, carried into its EnvState:
  bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.render import oracle as j_oracle
from procgen_tpu.render.pack import RenderPack as JPack

from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.render import fast2, oracle
from test_torch_assets import GAMES, asset_root_fixture
from test_torch_coinrun import JaxCarrier

torch.set_num_threads(1)

synth_root = asset_root_fixture()

N = 4


def _states(game, steps=12, every=4):
    env = ProcgenTorchEnv(N, game, rand_seed=11, distribution_mode="hard", device="cpu",
                          render=False)
    rs = np.random.RandomState(1)
    for t in range(steps):
        a = rs.randint(0, 15, size=N).astype(np.int32)
        if t == 5:
            a[0] = -1
        env.act(a)
        if t % every == every - 1:
            yield env, env.state


@pytest.mark.parametrize("game", GAMES)
def test_oracle_matches_fast_path(synth_root, game):
    """Exact: every uint8 value of the observation and the static layer."""
    for env, state in _states(game):
        gd, cfg, pack = env.gd, env.cfg, env.pack
        obs = oracle.oracle_obs(gd, cfg, state, pack)
        assert obs.shape == (N, 64, 64, 3) and obs.dtype == torch.uint8
        assert torch.equal(obs, fast2.render_frames2(gd, cfg, state, pack)), game
        assert torch.equal(oracle.oracle_static(gd, cfg, state, pack),
                           fast2.render_static2(gd, cfg, state, pack)), game


@pytest.mark.parametrize("game", ["maze", "coinrun"])
def test_oracle_matches_reference(synth_root, game):
    """Exact: the port's oracle against the JAX package's."""
    jcfg = JConfig(env_name=game, num_envs=N, rand_seed=11, distribution_mode=JMode.hard)
    jgd = j_make_game(jcfg)
    jpack = JPack(jgd, jcfg)
    carry = JaxCarrier(jgd, jcfg)
    j_obs = jax.jit(jax.vmap(lambda s: j_oracle.oracle_obs(jgd, jcfg, s, jpack)))
    j_static = jax.jit(jax.vmap(lambda s: j_oracle.oracle_static(jgd, jcfg, s, jpack)))
    for env, state in _states(game):
        js = carry(state)
        np.testing.assert_array_equal(
            oracle.oracle_obs(env.gd, env.cfg, state, env.pack).numpy(), np.asarray(j_obs(js)))
        np.testing.assert_array_equal(
            oracle.oracle_static(env.gd, env.cfg, state, env.pack).numpy(),
            np.asarray(j_static(js)))
