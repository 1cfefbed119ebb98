"""procgen_torch's jumper against native/jumper_oracle.cpp, procgen_tpu and
its own inline path.

* levelgen of three seeds per mode (easy, hard, memory) against the
  std::mt19937 C++ oracle: grid, wall theme, the entity list (type, x and y
  bit for bit) and the next raw draws of the step stream.  No JAX is
  compiled;
* every mode's reset against procgen_tpu's on more seeds (every state
  field bitwise), which also holds the three cell scans of the reset;
* the step, hard mode, 4 envs: every level is generated by the port on the
  CPU and carried into the JAX package's EnvState, then both packages step
  it and draw its frame (compass, distance bar and landing shadow
  included).  Every state field and frame must agree bitwise after every
  step, with the view_dim rule of tests/test_torch_fast_path.py.  The
  seeded actions double-jump, and two envs start each level beside a goal
  moved next to the agent; goals, deaths on spikes, double jumps (the
  landing shadow) and trails are counted, and each must occur;
* the port's fast path against its inline path, forced resets at t = 40,
  41 and 90.
"""

import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import jumper as JP
from procgen_torch.games import make_game
from procgen_torch.state import init_state_template
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_fast_path import jax_fields, pin_jax_roundings

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 4
SEED = 31
MODES = {"easy": (0, 20), "hard": (1, 40), "memory": (3, 45)}


@pytest.fixture(scope="session")
def jumper_oracle():
    src = REPO / "native" / "jumper_oracle.cpp"
    binary = REPO / "native" / "build" / "jumper_oracle_torch"
    binary.parent.mkdir(exist_ok=True)
    if not binary.exists() or binary.stat().st_mtime < src.stat().st_mtime:
        tmp = binary.with_name(f"{binary.name}.{os.getpid()}")
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, binary)

    def run(seed: int, mode: str):
        mode_i, W = MODES[mode]
        out = subprocess.run(
            [str(binary), str(seed), str(mode_i)],
            check=True, capture_output=True, text=True,
        ).stdout.splitlines()
        wall_theme, n_ents, _ = map(int, out[0].split()[1:])
        rows = [list(map(int, line.split())) for line in out[1:1 + W]]
        ents = []
        for line in out[1 + W:1 + W + n_ents]:
            t = line.split()[1:]
            ents.append((int(t[0]),) + tuple(float.fromhex(v) for v in t[1:3]))
        fp = list(map(int, out[1 + W + n_ents].split()[1:]))
        return {"wall_theme": wall_theme, "grid": np.asarray(rows), "ents": ents, "fp": fp}

    return run


def _bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


def _port_levels(mode, seeds):
    cfg = EnvConfig(env_name="jumper", num_envs=len(seeds), distribution_mode=DistributionMode[mode])
    gd = make_game(cfg)
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    return state.replace(rng=R.mt_block_close(rs))


@pytest.mark.parametrize("mode", list(MODES))
def test_jumper_levelgen_matches_oracle(jumper_oracle, mode):
    seeds = [12 + 31 * i for i in range(3)]
    state = _port_levels(mode, seeds)
    ents = state.ents
    for i, seed in enumerate(seeds):
        ref = jumper_oracle(seed, mode)
        np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=f"seed {seed}")
        assert int(state.extra["wall_theme"][i]) == ref["wall_theme"], seed
        assert int(ents.alive[i].sum()) == len(ref["ents"]), seed
        for k, (t, ex, ey) in enumerate(ref["ents"]):
            assert int(ents.type[i, k]) == t, (seed, k)
            got = (_bits(float(ents.x[i, k])), _bits(float(ents.y[i, k])))
            assert got == (_bits(ex), _bits(ey)), (seed, k)
        one = R.MT(key=state.rng.key[i], pos=state.rng.pos[i])
        for want in ref["fp"]:
            one, x = R.mt_raw(one)
            assert int(x) == want, seed


@pytest.mark.parametrize("mode", list(MODES))
def test_jumper_reset_matches_reference(mode):
    """The port's reset against the JAX package's on 12 seeds: every field."""
    seeds = [1000 + 7919 * i for i in range(12)]
    state = _port_levels(mode, seeds)
    j_cfg = JConfig(env_name="jumper", num_envs=len(seeds), distribution_mode=JMode[mode])
    j_gd = j_make_game(j_cfg)
    tmpl = j_template(j_gd, j_cfg)

    def one(seed):
        st = j_gd.choose_world_dim(j_cfg, tmpl)
        rs = JR.mt_block_open(JR.mt_seed(jnp.asarray(seed, jnp.int32)), j_gd.reset_max_draws)
        st, rs = j_gd.game_reset(j_cfg, st, rs)
        return st.replace(rng=JR.mt_block_close(rs))

    j_states = jax.jit(jax.vmap(one))(jnp.asarray(seeds, jnp.int32))
    want, got = jax_fields(j_states), convert.state_to_numpy(state)
    assert sorted(want) == sorted(got)
    for k in sorted(want):
        a, b = np.asarray(want[k]), got[k]
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    # not vacuous: spikes were placed and the wall fix opened cells
    assert (state.ents.type == JP.SPIKE).any() or mode == "memory"


def _cfgs(mode="hard"):
    kw = dict(env_name="jumper", num_envs=N, rand_seed=SEED, use_generated_assets=True)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions: jump right and left (moves 8, 2, 5), run, or any; the
    jumps repeat, so the second jump of a pair comes mid-air."""
    u = rs.rand(N)
    return np.where(
        u < 0.75, rs.choice([8, 8, 5, 2, 7, 1, 6], size=N), rs.randint(0, 15, size=N)
    ).astype(np.int32)


def _goal_near_agent(state, which):
    """Move the goal (slot 1) just right of the agent in the envs of
    ``which``, so that the seeded actions reach goals in a 40x40 world; the
    carried state holds the move, so both packages step the same level."""
    ents = state.ents
    x, y = ents.x.clone(), ents.y.clone()
    x[:, JP.GOAL_SLOT] = torch.where(which, x[:, 0] + 0.9, x[:, JP.GOAL_SLOT])
    y[:, JP.GOAL_SLOT] = torch.where(which, y[:, 0] + 0.1, y[:, JP.GOAL_SLOT])
    return state.replace(ents=ents.replace(x=x, y=y))


def test_jumper_step_matches_reference(monkeypatch):
    pin_jax_roundings(monkeypatch)
    near = torch.arange(N) < 2  # envs 0 and 1 start each level beside its goal
    counts = dict(levels=N, goals=0, deaths=0, double_jumps=0, trails=0)
    for state in stepped_against_reference(
        *_cfgs(), _policy, 300, prepare=lambda s, which: _goal_near_agent(s, which & near)
    ):
        ex = state.extra
        timeout = state.cur_time >= state.timeout
        counts["goals"] += int((state.reward > 0).sum())
        counts["deaths"] += int((state.done & (state.reward == 0) & ~timeout).sum())
        counts["double_jumps"] += int(((ex["jump_delta"] < 0) & ~ex["has_support"]).sum())
        counts["trails"] += int((state.ents.alive & (state.ents.type == O.TRAIL)).sum())
        counts["levels"] += int(state.done.sum())
    for k in ("goals", "deaths", "double_jumps", "trails"):
        assert counts[k] > 0, counts
    assert counts["levels"] >= 2 * N, counts


def test_jumper_fast_path_matches_inline():
    fs = check_fast_path_matches_inline(_cfgs()[1], _policy)
    # convert.py carries the game's extras by name (the round trip above)
    assert sorted(fs.state.extra) == sorted(("jump_count", "jump_delta", "jump_time", "has_support", "facing_right", "wall_theme"))
