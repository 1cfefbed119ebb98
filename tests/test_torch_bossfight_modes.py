"""procgen_torch's bossfight in easy mode against procgen_tpu, and its fast
path against its inline path, in PNG mode on a synthetic asset root (the
rules of tests/test_torch_bossfight.py, which holds levelgen and the hard
mode; two files keep each under its time budget).

* the step, easy mode, 2 envs, 80 steps, as the hard run: every state field
  bitwise, frames within 1 per uint8 value (fading trails);
* the fast path (refill bucket 2) against the inline path.  The step's four
  random fractions live in the state and are drawn first thing in every
  step (bossfight.cpp:355-358), and the reset leaves them: a queued level
  holds those of the step that generated it, the inline reset those of the
  dying step, as the action bookkeeping (ROADMAP section C).  No step
  reads them before drawing them anew (the only earlier reader, a
  bullet's reflection off the shields, needs a bullet, and a new level has
  none), so they are left out of the comparison; every other field and
  every frame are compared.
"""

import torch

from test_torch_assets import asset_root_fixture
from test_torch_bossfight import _cfgs, policy, run_steps
from test_torch_coinrun import N, check_fast_path_matches_inline
from test_torch_dodgeball import jax_x64_off  # noqa: F401 (a fixture)

torch.set_num_threads(1)

synth_root = asset_root_fixture()


def test_bossfight_easy_step_matches_reference(synth_root, monkeypatch, jax_x64_off):
    counts = run_steps(monkeypatch, "easy", 80)
    for k in ("reflections", "enemy_bullets", "trails"):
        assert counts[k] > 0, counts


def test_bossfight_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs(n=N)[1], policy(N), carried=tuple(
        f"extra.{k}" for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y")))
