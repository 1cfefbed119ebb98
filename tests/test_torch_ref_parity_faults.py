"""Two faults of the port that only the reference binary shows, each held
as the case that first showed it (procgen_torch in parity mode against
``native/refharness/refdump``; see tests/test_torch_ref_parity.py).

* plunder, hard, seed 1, 60 steps: a ship spawned on lane 4 (hard mode,
  ``r_scale`` 1) at step 38.  Its row ``(lane * .11f + .4f) * (main_height
  / 2 - r_scale) + main_height / 2`` is the double chain narrowed once;
  rounded op by op it is 17.560001 (``0x418c7ae2``) where the reference has
  ``0x418c7ae1``.  ``test_spawn_row_on_every_input`` holds the game's row
  against the double chain on every input of the site.
* starpilot, hard, seed 7, 360 steps: at step 345 the enemy in slot 5 dies
  while the one in slot 2 fires.  The reference walks the slots in
  descending order (starpilot.cpp:369-394), each enemy's shot before its
  death explosion, so the explosion lands in slot 9 and the bullet in slot
  10; appending every shot first, then every explosion, swaps them.
"""

import itertools

import numpy as np
import pytest
import torch

from procgen_torch.games import plunder as PL
from test_torch_ref_parity import check_against_reference, refbin, synth_root  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("game,steps,seed", [("plunder", 60, 1), ("starpilot", 360, 7)])
def test_fault_witness_matches_reference_binary(refbin, game, steps, seed):  # noqa: F811
    check_against_reference(refbin, game, steps, seed)


def test_spawn_row_on_every_input():
    """Every lane, every mode's ``r_scale`` (easy 1.5, else 1) at plunder's
    fixed main height 20: the game's row is the double chain narrowed once,
    and differs from the float chain rounded op by op only on lane 4 at
    ``r_scale`` 1."""
    f32 = np.float32
    lanes = torch.arange(PL.NUM_LANES, dtype=torch.int32)
    moved = []
    for r_scale, mh in itertools.product((1.0, 1.5), (20.0,)):
        got = PL.spawn_row(lanes, r_scale, mh).numpy()
        assert got.dtype == np.float32
        for lane in range(PL.NUM_LANES):
            chain = (lane * float(f32(0.11)) + float(f32(0.4))) * (mh / 2 - r_scale) + mh / 2
            assert got[lane].view(np.int32) == f32(chain).view(np.int32), (lane, r_scale)
            op_by_op = (f32(lane) * f32(0.11) + f32(0.4)) * (f32(mh / 2) - f32(r_scale)) + f32(mh / 2)
            if op_by_op != got[lane]:
                moved.append((lane, r_scale))
    assert moved == [(4, 1.0)]
