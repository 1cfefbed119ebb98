"""The nine games of the earlier slices in their default configuration, PNG
assets (``use_generated_assets=False``), on a synthetic asset root, against
procgen_tpu: here the five static views (maze, miner, chaser, leaper,
dodgeball) and caveflyer; tests/test_torch_png_path_centered.py runs the
other three center-agent views with these helpers.

For each game, hard mode, 4 envs, 60 steps (leaper 30: each of its resets
pre-rolls 300 physics steps): every level is generated by the port on the
CPU and carried into the JAX package's EnvState, then both packages step it
and draw its frame; every state field and frame bitwise after every step.
Forced resets (action -1) at steps 10, 11 and 40 and every finished episode
bring new levels, whose background index is drawn over the game's own
background group (not the generated-asset pool of 16), and whose themes
index real multi-theme atlas slots.  Frames are drawn over non-square
backgrounds (the center-agent background pass) and non-square sprites.

The JAX side is pinned where XLA:CPU rounds otherwise than the reference
(ROADMAP section C): ``pin_jax_roundings`` and ``pin_jax_render`` of
tests/test_torch_fast_path.py, caveflyer's two contracted chains
(``pin_caveflyer_chains``) and its flushed denormals (``ents.vrot``), and
x64 off for dodgeball.

Sprites of binary alpha (the root's default) give bitwise frames.
"""

import jax
import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig

from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from test_torch_assets import asset_root_fixture
from test_torch_caveflyer import pin_caveflyer_chains
from test_torch_coinrun import stepped_against_reference
from test_torch_fast_path import pin_jax_render, pin_jax_roundings

torch.set_num_threads(1)

N = 4  # JaxCarrier's batch
SEED = 17
FORCED = (10, 11, 40)

synth_root = asset_root_fixture()


def _cfgs(game, mode="hard"):
    kw = dict(env_name=game, num_envs=N, rand_seed=SEED, use_generated_assets=False)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy():
    """Seeded random actions, every env forced to reset at FORCED steps."""
    t = [0]

    def policy(rs):
        acts = rs.randint(0, 15, size=N).astype(np.int32)
        if t[0] in FORCED:
            acts[:] = -1
        t[0] += 1
        return acts

    return policy


def _pin(monkeypatch, game):
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    if game == "caveflyer":
        pin_caveflyer_chains(monkeypatch)


def _run(game, steps, frames_equal=None):
    ftz = ("ents.vrot",) if game == "caveflyer" else ()
    levels, bg = N, set()
    for state in stepped_against_reference(*_cfgs(game), _policy(), steps, ftz_fields=ftz,
                                           frames_equal=frames_equal):
        levels += int(state.done.sum())
        bg.update(state.background_index.tolist())
    return levels, bg


def check_png_path(monkeypatch, game, steps):
    _pin(monkeypatch, game)
    was = jax.config.jax_enable_x64
    if game == "dodgeball":
        # the JAX fast mode runs without x64 (tests/test_torch_dodgeball.py)
        jax.config.update("jax_enable_x64", False)
    try:
        levels, bg = _run(game, steps)
    finally:
        jax.config.update("jax_enable_x64", was)
    assert levels >= 3 * N  # the first levels and two forced resets at least
    # background indices over the game's own group
    n_bg = make_game(_cfgs(game)[1]).num_backgrounds
    assert max(bg) < n_bg and (len(bg) > 1 or n_bg == 1), (bg, n_bg)


@pytest.mark.parametrize("game,steps", [
    ("maze", 60), ("miner", 60), ("chaser", 60), ("leaper", 30), ("dodgeball", 60),
    ("caveflyer", 60),
])
def test_png_path_matches_reference(synth_root, monkeypatch, game, steps):
    check_png_path(monkeypatch, game, steps)
