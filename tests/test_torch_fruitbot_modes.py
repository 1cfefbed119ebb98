"""procgen_torch's fruitbot in easy mode against procgen_tpu, and its fast
path against its inline path, in PNG mode on a synthetic asset root (the
rules of tests/test_torch_fruitbot.py, which holds levelgen and the hard
mode; two files keep each under its time budget).

* the step, easy mode, 4 envs, 80 steps, as the hard run: every state field
  and frame bitwise;
* the port's fast path against its inline path.
"""

import torch

from test_torch_assets import asset_root_fixture
from test_torch_coinrun import check_fast_path_matches_inline
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)
from test_torch_fruitbot import _cfgs, _policy, run_steps

torch.set_num_threads(1)

synth_root = asset_root_fixture()


def test_fruitbot_easy_step_matches_reference(synth_root, monkeypatch, jax_x64_off):
    counts = run_steps(monkeypatch, "easy", 80)
    for k in ("fruit", "food", "wall_deaths", "keys"):
        assert counts[k] > 0, counts


def test_fruitbot_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs()[1], _policy)
