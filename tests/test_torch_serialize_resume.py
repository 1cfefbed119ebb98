"""procgen_torch's ``get_state``/``set_state`` resume a rollout bit for bit
(the protocol of tests/test_serialize.py:10-37, reference state_test.py:79-124),
for all 16 games in the default configuration (PNG assets from a synthetic
root), on the CPU.

Two envs in easy mode take 20 random steps; their state is saved, and 25
more steps recorded.  A second env with another ``rand_seed`` restores the
saved state and replays the 25 actions: rewards, firsts and frames must be
equal at every step, and both envs' bytes equal at the end.
"""

import numpy as np
import pytest
import torch

from procgen_torch.env import ProcgenTorchEnv
from test_torch_assets import GAMES, asset_root_fixture

torch.set_num_threads(1)

synth_root = asset_root_fixture()


@pytest.mark.parametrize("game", GAMES)
def test_state_roundtrip_resumes_identically(synth_root, game):
    """Exact: rewards, firsts, uint8 frames and bytes."""
    rng = np.random.RandomState(4)
    env = ProcgenTorchEnv(2, game, rand_seed=10, distribution_mode="easy", device="cpu")
    for _ in range(20):
        env.act(rng.randint(0, 15, size=2))
    blobs = env.get_state()
    acts = [rng.randint(0, 15, size=2) for _ in range(25)]

    cont = []
    for a in acts:
        env.act(a)
        rew, ob, first = env.observe()
        cont.append((rew.copy(), ob["rgb"].copy(), first.copy()))

    env2 = ProcgenTorchEnv(2, game, rand_seed=99, distribution_mode="easy", device="cpu")
    env2.set_state(blobs)
    for t, a in enumerate(acts):
        env2.act(a)
        rew, ob, first = env2.observe()
        np.testing.assert_array_equal(rew, cont[t][0], err_msg=f"{game} rew step {t}")
        np.testing.assert_array_equal(first, cont[t][2], err_msg=f"{game} first step {t}")
        np.testing.assert_array_equal(ob["rgb"], cont[t][1], err_msg=f"{game} obs step {t}")

    # state bytes also line up after the replay
    assert env.get_state() == env2.get_state()
