"""procgen_torch's bigfish against procgen_tpu and its own inline path, in
PNG mode on a synthetic asset root (bigfish reads its fish's aspect ratios
from the PNG headers when it is built).

* levelgen of six seeds per mode (easy, hard) against the JAX package's
  ``game_reset`` (bigfish has no C++ oracle): every state field bitwise,
  the step stream's state included;
* the step, hard mode, 4 envs, 250 steps: every level is generated by the
  port on the CPU and carried into the JAX package's EnvState (a small fish
  staged beside the agent and a big one further off, so that fish are
  eaten and agents die), then both packages step it and draw its frame;
  every state field and frame bitwise after every step; easy mode for 80
  steps.  Spawned fish (with their themes' ``ry``), fish eaten and deaths
  are counted, and each must occur;
* the port's fast path against its inline path.

The fish radius is the reference's double chain ``(FISH_MAX_R - FISH_MIN_R)
* pow(rand01(), 1.4) + FISH_MIN_R``, narrowed once (bigfish.cpp:84): the
port computes it so in both modes.  The JAX fast path computes it as float32
``jnp.power`` and a mul+add that XLA:CPU contracts into an FMA; the step
test routes its radius through the reference's chain on the host
(``pin_bigfish_radius``), with ``pin_jax_roundings`` of
tests/test_torch_fast_path.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import fmath as j_fmath
from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import bigfish as JB
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.games import bigfish as B
from procgen_torch.games import make_game
from procgen_torch.state import init_state_template
from test_torch_assets import asset_root_fixture
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_fast_path import assert_fields_equal, jax_fields, pin_jax_roundings

torch.set_num_threads(1)

N = 4
SEED = 31

synth_root = asset_root_fixture()


def jax_direct_reset(j_gd, j_cfg, seeds):
    """The JAX package's game_reset of each seed (vmapped), as
    tests/test_heist.py runs it."""
    tmpl = j_template(j_gd, j_cfg)

    def one(seed):
        st = j_gd.choose_world_dim(j_cfg, tmpl)
        rs = JR.mt_block_open(JR.mt_seed(jnp.asarray(seed, jnp.int32)), j_gd.reset_max_draws)
        st, rs = j_gd.game_reset(j_cfg, st, rs)
        return st.replace(rng=JR.mt_block_close(rs)), JR.blk_overflowed(rs)

    return jax.jit(jax.vmap(one))(jnp.asarray(seeds, jnp.int32))


def port_direct_reset(gd, cfg, seeds):
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    return state.replace(rng=R.mt_block_close(rs))


def reset_fields(state) -> dict:
    """Every field but the view's (update_view_params writes those)."""
    return {k: v for k, v in state.items()
            if k.rsplit(".", 1)[-1] not in ("view_dim", "x_off", "y_off")}


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_bigfish_levelgen_matches_reference(synth_root, monkeypatch, mode):
    pin_jax_roundings(monkeypatch)  # the random agent spawn's mul+add
    seeds = [5 + 41 * i for i in range(6)]
    cfg = EnvConfig(env_name="bigfish", num_envs=len(seeds), distribution_mode=DistributionMode[mode])
    j_cfg = JConfig(env_name="bigfish", num_envs=len(seeds), distribution_mode=JMode[mode])
    state = port_direct_reset(make_game(cfg), cfg, seeds)
    j_state, overflowed = jax_direct_reset(j_make_game(j_cfg), j_cfg, seeds)
    assert not np.asarray(overflowed).any()
    assert_fields_equal(reset_fields(jax_fields(j_state)),
                        reset_fields(convert.state_to_numpy(state)), f"bigfish {mode} reset")
    # the background index is drawn over the seven water backgrounds
    assert int(state.background_index.max()) < 7


class _PinnedPower:
    """jax.numpy with ``power`` returning the reference's whole radius chain
    (used with FISH_MAX_R = 1 and FISH_MIN_R = 0, so the game's own mul+add
    passes the value through)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def power(u, _p):
        def host(x):
            r = (np.float64(B.FISH_MAX_R - B.FISH_MIN_R) * np.power(np.asarray(x, np.float64), 1.4)
                 + np.float64(B.FISH_MIN_R))
            return r.astype(np.float32)

        u = jnp.asarray(u, jnp.float32)
        return j_fmath._callback(host, u, u)


def pin_bigfish_radius(monkeypatch):
    monkeypatch.setattr(JB, "jnp", _PinnedPower())
    monkeypatch.setattr(JB, "FISH_MAX_R", np.float32(1.0))
    monkeypatch.setattr(JB, "FISH_MIN_R", np.float32(0.0))


def _cfgs(mode="hard"):
    kw = dict(env_name="bigfish", num_envs=N, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    return rs.randint(0, 15, size=N).astype(np.int32)


def _stage(state, which):
    """A small fish just ahead of the agent swimming towards it, and a big
    one further off, in the new levels of ``which``."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]
    small = eo.make_entity(ax + 1.5, ay, -np.float32(0.2), 0.0, 0.3, 0.3, B.FISH)
    big = eo.make_entity(ax - 4.0, ay, np.float32(0.1), 0.0, 1.5, 1.5, B.FISH)
    big["image_theme"] = 2
    ents, _ = eo.append_entity(ents, small, active=which)
    ents, _ = eo.append_entity(ents, big, active=which)
    return state.replace(ents=ents)


@pytest.mark.parametrize("mode,steps", [("hard", 250), ("easy", 80)])
def test_bigfish_step_matches_reference(synth_root, monkeypatch, mode, steps):
    pin_jax_roundings(monkeypatch)
    pin_bigfish_radius(monkeypatch)
    counts = dict(levels=N, spawned=0, eaten=0, deaths=0)
    prev = None
    for state in stepped_against_reference(*_cfgs(mode), _policy, steps, prepare=_stage):
        fish = state.ents.alive & (state.ents.type == B.FISH)
        if prev is not None:
            counts["spawned"] += int((fish.sum(1) > (prev.ents.alive & (prev.ents.type == B.FISH)).sum(1)).sum())
        counts["eaten"] += int((state.reward == B.POSITIVE_REWARD).sum())
        counts["deaths"] += int((state.done & ~state.level_complete).sum())
        counts["levels"] += int(state.done.sum())
        prev = state
    for k in ("spawned", "eaten", "deaths"):
        assert counts[k] > 0, counts


def test_bigfish_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs()[1], _policy)
