"""procgen_torch's chaser against native/chaser_oracle.cpp and procgen_tpu.

* levelgen (maze without dead ends, quadrant orbs, agent and eggs) of six
  seeds per mode against the std::mt19937 C++ oracle: grid, orb count,
  agent and entity positions bit for bit, and the next raw draws of the
  step stream;
* the fast path step by step against procgen_tpu's (the harness of
  tests/test_torch_grid_dynamic.py): smart enemies sub-stepping, the
  reverse collision sweep, hatching and colour-rect orb frames.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from procgen_torch.state import init_state_template
from test_torch_grid_dynamic import run_against_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MAZE_DIMS = {0: 11, 1: 13, 2: 19}


@pytest.fixture(scope="session")
def chaser_oracle():
    src = REPO / "native" / "chaser_oracle.cpp"
    binary = REPO / "native" / "build" / "chaser_oracle"
    binary.parent.mkdir(exist_ok=True)
    if not binary.exists() or binary.stat().st_mtime < src.stat().st_mtime:
        subprocess.run(["g++", "-O2", "-o", str(binary), str(src)], check=True)

    def run(seed: int, mode: int):
        md = MAZE_DIMS[mode]
        out = subprocess.run(
            [str(binary), str(seed), str(mode)],
            check=True, capture_output=True, text=True,
        ).stdout.splitlines()
        total_orbs = int(out[0].split()[1])
        ax, ay = (float.fromhex(t) for t in out[1].split()[1:])
        rows = [list(map(int, line.split())) for line in out[2:2 + md]]
        n_ents = int(out[2 + md].split()[1])
        ents = []
        for line in out[3 + md:3 + md + n_ents]:
            t = line.split()[1:]
            ents.append((int(t[0]), float.fromhex(t[1]), float.fromhex(t[2])))
        fp = list(map(int, out[3 + md + n_ents].split()[1:]))
        return {
            "total_orbs": total_orbs, "agent": (ax, ay),
            "grid": np.asarray(rows), "ents": ents, "fp": fp,
        }

    return run


@pytest.mark.parametrize("mode", ["easy", "hard", "extreme"])
def test_chaser_levelgen_matches_oracle(chaser_oracle, mode):
    cfg = EnvConfig(env_name="chaser", num_envs=6, distribution_mode=DistributionMode[mode])
    gd = make_game(cfg)
    seeds = [5 + 31 * i for i in range(6)]
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    mt = R.mt_block_close(rs)

    for i, seed in enumerate(seeds):
        ref = chaser_oracle(seed, int(DistributionMode[mode]))
        np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=f"seed {seed}")
        assert int(state.extra["total_orbs"][i]) == ref["total_orbs"]
        ents = state.ents
        assert (float(ents.x[i, 0]), float(ents.y[i, 0])) == ref["agent"], seed
        for k, (t, ex, ey) in enumerate(ref["ents"]):
            assert int(ents.type[i, k + 1]) == t, (seed, k)
            assert float(ents.x[i, k + 1]) == ex, (seed, k)
            assert float(ents.y[i, k + 1]) == ey, (seed, k)
        assert int(ents.alive[i].sum()) == 1 + len(ref["ents"])
        one = R.MT(key=mt.key[i], pos=mt.pos[i])
        for want in ref["fp"]:
            one, x = R.mt_raw(one)
            assert int(x) == want, seed


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_chaser_fast_path_matches_reference(mode):
    run_against_reference("chaser", mode, 150)
