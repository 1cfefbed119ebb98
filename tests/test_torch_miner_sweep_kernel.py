"""Miner's gravity sweep kernel (``procgen_torch/csrc/miner_sweep.cu``)
against the plain version (``MinerGame.gravity_sweep_ref``), bit for bit.

On the CPU: the kernel's per-env code (``csrc/miner_sweep.cuh``) built for
the host (``csrc/miner_sweep_host.cpp``, g++), each grid staged in bytes as
the kernel stages it: random grids at W = 10, 20 and 35 (easy, hard,
memory), the sweeps of real miner steps in every mode, and hand-made
grids whose result is drawn out below (rolls left and right, a roll
blocked by the agent's cell, a crush, falling diamonds, objects in row 0
and in the side columns).  Grid, diamond count and crush flag.  The object
codes compiled into the kernel are pinned to ``miner.py``'s, and CPU
tensors run the plain version without a launch.

On the card (marker ``cuda``; run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_miner_sweep_kernel.py``): the kernel
at 4096 rows in every mode, miner hard's fast path on the card against the
CPU state by state across level swaps, one launch a step, and the inline
path of every mode against the CPU's.  This file imports no JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from procgen_torch import cuda_build, telemetry
from procgen_torch import objects as O
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env, step_env
from procgen_torch.games import make_game, miner
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template, tree_leaves_with_names

I32 = torch.int32
MODES = {10: "easy", 20: "hard", 35: "memory"}


def _game(mode: str, n: int = 8, seed: int = 31):
    cfg = EnvConfig(env_name="miner", num_envs=n, distribution_mode=DistributionMode[mode],
                    rand_seed=seed, use_generated_assets=True)
    return cfg, make_game(cfg)


def _host_lib():
    lib = cuda_build.load("miner_sweep_host")
    if lib.miner_sweep_host.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.miner_sweep_host.argtypes = [ptr] * 3 + [i] * 2 + [ptr] * 3
        lib.miner_sweep_host.restype = i
        lib.miner_sweep_codes.argtypes = [ptr]
    return lib


def host_sweep(W, flat, ay, ax, free):
    """The kernel's arguments as ``gravity_sweep`` makes them, through the
    host build; returns (grid, diamonds, crushed)."""
    N = flat.shape[0]
    grid = flat.to(I32).contiguous()
    fall = miner.fall_cell(ay, ax, W).contiguous()
    free = free.to(torch.int64).contiguous()
    out = torch.empty_like(grid)
    diamonds = torch.empty((N,), dtype=I32)
    crushed = torch.empty((N,), dtype=torch.bool)
    rc = _host_lib().miner_sweep_host(grid.data_ptr(), fall.data_ptr(), free.data_ptr(), N, W,
                                      out.data_ptr(), diamonds.data_ptr(), crushed.data_ptr())
    assert rc == 0
    return out, diamonds, crushed


def assert_same(got, want, what=""):
    for name, g, w in zip(("grid", "diamonds", "crushed"), got, want):
        g, w = g.cpu(), w.cpu()
        if name == "grid":  # the plain version returns int64
            g, w = g.to(torch.int64), w.to(torch.int64)
        assert g.dtype == w.dtype and torch.equal(g, w), (
            f"{what}: {name} differs in rows {_rows(g, w)}")


def _rows(a, b):
    return torch.nonzero((a != b).reshape(a.shape[0], -1).any(1)).flatten().tolist()[:8]


def random_case(W, n, seed, values=None):
    """Random grids dense in boulders, diamonds and space (or uniform over
    ``values``), agents at cell centres or anywhere (fractional positions
    truncate toward zero, some below the grid), and the is_free cell the
    agent's or another, in the grid or outside it."""
    rs = np.random.RandomState(seed)
    codes = np.array([miner.BOULDER, miner.DIAMOND, miner.MOVING_BOULDER, miner.MOVING_DIAMOND,
                      O.SPACE, miner.DIRT])
    if values is None:
        grid = codes[rs.choice(len(codes), size=(n, W * W), p=[.2, .1, .1, .1, .35, .15])]
    else:
        grid = rs.choice(values, size=(n, W * W))
    centred = rs.rand(n) < 0.7
    ax = np.where(centred, rs.randint(0, W, n) + 0.5, rs.uniform(-0.5, W, n))
    ay = np.where(centred, rs.randint(0, W, n) + 0.5, rs.uniform(-0.5, W, n))
    own = (np.floor(ay).astype(np.int64) * W + np.floor(ax).astype(np.int64))
    free = np.where(rs.rand(n) < 0.8, own, rs.randint(-W, W * W + W, n))
    grid[np.arange(n), np.clip(own, 0, W * W - 1)] = O.SPACE  # the agent dug its cell
    return (torch.as_tensor(grid, dtype=I32), torch.as_tensor(ay, dtype=torch.float32),
            torch.as_tensor(ax, dtype=torch.float32), torch.as_tensor(free))


def test_object_codes_pinned_to_miner():
    out = (ctypes.c_int32 * 5)()
    _host_lib().miner_sweep_codes(out)
    assert list(out) == [miner.BOULDER, miner.DIAMOND, miner.MOVING_BOULDER,
                         miner.MOVING_DIAMOND, O.SPACE]


@pytest.mark.parametrize("W", sorted(MODES))
@pytest.mark.parametrize("values", ["objects", "every_value"])
def test_host_build_matches_plain_on_random_grids(W, values):
    _, gd = _game(MODES[W])
    n = 64 if W < 35 else 24
    vals = np.arange(O.SPACE + 1) if values == "every_value" else None
    flat, ay, ax, free = random_case(W, n, seed=W + len(values), values=vals)
    want = gd.gravity_sweep_ref(flat, ay, ax, free)
    assert_same(host_sweep(W, flat, ay, ax, free), want, f"W {W}")
    if values == "objects":
        assert want[2].any() and not want[2].all(), "no env (or every env) crushed"
        assert not torch.equal(want[0], flat.to(torch.int64)), "nothing moved"


def _recorded_sweeps(mode, steps, n=8):
    """The inputs and outputs of every sweep of ``steps`` inline steps of
    random actions after a reset (episode ends reset in place)."""
    cfg, gd = _game(mode, n)
    calls = []
    plain = gd.gravity_sweep

    def record(flat, ay, ax, free):
        out = plain(flat, ay, ax, free)
        calls.append(((flat.clone(), ay.clone(), ax.clone(), free.clone()), out))
        return out

    gd.gravity_sweep = record
    state = reset_env(gd, cfg, seeded_template(gd, cfg, n, device="cpu"))
    gen = torch.Generator().manual_seed(7)
    done = 0
    for _ in range(steps):
        state = step_env(gd, cfg, state, torch.randint(0, 15, (n,), generator=gen, dtype=I32))
        done += int(state.done.sum())
    return gd, calls, done


@pytest.mark.parametrize("mode,steps", [("easy", 40), ("hard", 25), ("memory", 10)])
def test_host_build_matches_plain_on_real_steps(mode, steps):
    gd, calls, _ = _recorded_sweeps(mode, steps)
    assert len(calls) == steps
    for t, (args, want) in enumerate(calls):
        assert_same(host_sweep(gd.world_dim, *args), want, f"{mode} step {t}")


# Hand-made grids at W = 10: the bottom rows, drawn top row first (row 0 is
# the last line), DIRT above them.  '.' SPACE, '#' DIRT, 'o' BOULDER, 'd'
# DIAMOND, 'O' MOVING_BOULDER, 'D' MOVING_DIAMOND, 'A' the agent's cell
# (SPACE; both agent cells); without an 'A' the agent is in the top row.
_CHARS = {".": O.SPACE, "#": miner.DIRT, "o": miner.BOULDER, "d": miner.DIAMOND,
          "O": miner.MOVING_BOULDER, "D": miner.MOVING_DIAMOND, "A": O.SPACE}
HAND = {
    # (3,1) rolls left onto the swept (2,1) and stays there this sweep;
    # (6,1) rolls right, and (7,1), swept next, falls
    "rolls": (["##.o##o.##",
               "##.o##o.##"],
              ["##o.##..##",
               "##.o##oO##"], 0, False),
    # the left roll of (4,1) is blocked by the agent's cell (3,0)
    "agent_blocks_roll": (["###.o#####",
                           "###Ao#####"],
                          ["###.o#####",
                           "###Ao#####"], 0, False),
    # a moving boulder lands on the agent: crushed, the cell stays
    "crush": (["##O#######",
               "##A#######"],
              ["##O#######",
               "##A#######"], 0, True),
    # a boulder at rest on the agent neither falls nor crushes
    "rest_on_agent": (["##o#######",
                       "##A#######"],
                      ["##o#######",
                       "##A#######"], 0, False),
    # diamonds fall into the swept row below and are counted once
    "diamonds_fall": (["#d##D#####",
                       "#.##.#####",
                       "#d##d#####"],
                      ["#.##.#####",
                       "#D##D#####",
                       "#d##d#####"], 4, False),
    # row 0 settles; column 0 rolls right (then falls), column 9 rolls left
    "edges": (["o.######.o",
               "o.O####D.o"],
              ["..######o.",
               "oOo####d.o"], 1, False),
}


def _hand_grid(rows, W=10):
    grid = np.full((W, W), miner.DIRT, np.int64)  # [y, x], y = 0 the bottom row
    agent = (W - 1) * W  # the top row's first cell
    for k, line in enumerate(rows):
        y = len(rows) - 1 - k
        for x, ch in enumerate(line):
            grid[y, x] = _CHARS[ch]
            if ch == "A":
                agent = y * W + x
    return grid.reshape(-1), agent


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_made_grids(case):
    before, after, diamonds, crushed = HAND[case]
    W = 10
    _, gd = _game("easy")
    grid, agent = _hand_grid(before)
    want_grid, want_agent = _hand_grid(after)
    assert agent == want_agent
    flat = torch.as_tensor(grid, dtype=I32)[None]
    ax = torch.tensor([agent % W + 0.5])
    ay = torch.tensor([agent // W + 0.5])
    free = torch.tensor([agent])
    want = gd.gravity_sweep_ref(flat, ay, ax, free)
    assert torch.equal(want[0][0], torch.as_tensor(want_grid)), (
        f"{case}: the plain version's grid\n{want[0][0].reshape(W, W).flip(0)}")
    assert int(want[1][0]) == diamonds and bool(want[2][0]) == crushed
    assert_same(host_sweep(W, flat, ay, ax, free), want, case)


def test_cpu_tensors_run_the_plain_version():
    _, gd = _game("hard")
    flat, ay, ax, free = random_case(20, 16, seed=3)
    before = miner.launches
    assert_same(gd.gravity_sweep(flat, ay, ax, free), gd.gravity_sweep_ref(flat, ay, ax, free))
    assert miner.launches == before


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", sorted(MODES))
def test_kernel_matches_plain(card, W):
    _, gd = _game(MODES[W])
    flat, ay, ax, free = (t.to(card) for t in random_case(W, 4096, seed=W))
    before = miner.launches
    got = gd.gravity_sweep(flat, ay, ax, free)
    torch.cuda.synchronize()
    assert miner.launches == before + 1
    assert got[0].dtype == I32 and got[0].shape == flat.shape
    assert_same(got, gd.gravity_sweep_ref(flat, ay, ax, free), f"W {W}")


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(card, monkeypatch):
    _, gd = _game("hard")
    flat, ay, ax, free = (t.to(card) for t in random_case(20, 64, seed=5))

    def refuse(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(gd, "gravity_sweep_ref", refuse)
    gd.gravity_sweep(flat, ay, ax, free)
    with pytest.raises(ValueError):
        gd.gravity_sweep(flat.to(torch.int64), ay, ax, free)


def _fast_run(dev, steps, n=256, bucket=64):
    """Miner hard's fast path from a cold start with random actions; returns
    the states after the start and after each step."""
    cfg, gd = _game("hard", n)
    init, step = make_fast_fns(gd, cfg, RenderPack(gd, cfg), refill_bucket=bucket)
    actions = np.random.RandomState(5).randint(0, 15, size=(steps, n)).astype(np.int32)
    fs = init.cold(seeded_template(gd, cfg, n, device=dev))
    out = [fs]
    for t in range(steps):
        fs = step(fs, torch.as_tensor(actions[t], device=dev))
        out.append(fs)
    return out


def _assert_states_equal(got, want, what):
    g_leaves, w_leaves = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [k for k, _ in g_leaves] == [k for k, _ in w_leaves]
    for (k, a), (_, b) in zip(g_leaves, w_leaves):
        assert torch.equal(a.cpu(), b), f"{k} differs {what}"


@pytest.mark.cuda
def test_fast_path_matches_cpu_across_swaps(card):
    steps = 50
    gpu, cpu = _fast_run(card, steps), _fast_run("cpu", steps)
    swaps = 0
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        _assert_states_equal(g, c, f"at step {t}")
        swaps += int(c.state.done.sum()) if t else 0
    assert swaps > 0, "no episode ended, so no level swapped in"


@pytest.mark.cuda
def test_one_launch_per_step(card):
    from torch.profiler import ProfilerActivity, profile

    steps, n = 12, 256
    before = miner.launches
    with profile(activities=[ProfilerActivity.CPU]):
        _fast_run(card, steps, n=n)
    counters = telemetry.snapshot()["counters"]
    assert miner.launches - before == steps
    assert counters["fast.steps"] == steps
    assert counters["miner.sweep.kernel_rows"] == steps * n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["easy", "hard", "memory"])
def test_inline_path_matches_cpu(card, mode):
    n, steps = 64, 20

    def run(dev):
        cfg, gd = _game(mode, n, seed=17)
        state = reset_env(gd, cfg, seeded_template(gd, cfg, n, device=dev))
        gen = np.random.RandomState(9)
        out = [state]
        for _ in range(steps):
            acts = torch.as_tensor(gen.randint(0, 15, n).astype(np.int32), device=dev)
            state = step_env(gd, cfg, state, acts)
            out.append(state)
        return out

    before = miner.launches
    gpu = run(card)
    torch.cuda.synchronize()
    assert miner.launches - before == steps
    for t, (g, c) in enumerate(zip(gpu, run("cpu"))):
        _assert_states_equal(g, c, f"{mode} at step {t}")
