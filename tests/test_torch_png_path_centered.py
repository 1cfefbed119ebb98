"""Three center-agent games of the earlier slices (coinrun, ninja, jumper)
in their default configuration, PNG assets, on a synthetic asset root,
against procgen_tpu, as tests/test_torch_png_path.py runs the others: hard
mode, 4 envs, 60 steps with forced resets, every state field and frame
bitwise after every step.  Their frames draw the background pass over
non-square backgrounds every frame.

The last case draws caveflyer over a root whose ship sprite has fractional
alpha (1-254): there the compositor is within 1.0 per float value of the
JAX package's (ROADMAP C: XLA:CPU multiplies by a reciprocal and contracts
the blend into an FMA), so its frames are held to at most 1 per uint8
value, and its states bitwise.
"""

import numpy as np
import pytest
import torch

from procgen_torch.games import make_game
from procgen_torch.render.pack import RenderPack
from test_torch_assets import FRACTIONAL, asset_root_fixture
from test_torch_png_path import _cfgs, _pin, _run, check_png_path

torch.set_num_threads(1)

synth_root = asset_root_fixture()
fractional_root = asset_root_fixture(FRACTIONAL, scope="function")


@pytest.mark.parametrize("game", ["coinrun", "ninja", "jumper"])
def test_png_path_centered_matches_reference(synth_root, monkeypatch, game):
    check_png_path(monkeypatch, game, 60)


def test_png_path_fractional_alpha(fractional_root, monkeypatch):
    """Caveflyer's ship drawn with fractional alpha: states bitwise, frames
    at most 1 apart per uint8 value."""
    cfg = _cfgs("caveflyer")[1]
    pack = RenderPack(make_game(cfg), cfg)
    alpha = pack.var_mips[..., 3]
    assert ((alpha > 0) & (alpha < 255)).any()  # the ship's fractional texels
    _pin(monkeypatch, "caveflyer")
    worst = []

    def within_one(want, got, where):
        d = np.abs(want.astype(np.int16) - got.astype(np.int16))
        assert d.max() <= 1, f"frame off by {d.max()} {where}"
        worst.append(int(d.max()))

    _run("caveflyer", 40, frames_equal=within_one)
    assert len(worst) == 40
