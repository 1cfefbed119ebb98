"""The maze kernels (``procgen_torch/csrc/mazegen.cu``) against the plain
version (``mazegen.generate_maze_ref`` + ``place_objects_ref``), bit for bit.

On the CPU: the kernels' per-env code (``csrc/mazegen.cuh``) built for the
host (``csrc/mazegen_host.cpp``, g++), on every maze size of the games'
``max_dim`` 15, 25 and 31, a batch mixing every size of each ``max_dim``
the games use, blocks short enough that the cursor clamps, and placements
that exhaust their retries.  Grid, free cells, their count and the cursor.

On the card (marker ``cuda``; run there with ``python -m pytest
--noconftest -m cuda tests/test_torch_mazegen_kernel.py``): the kernels at
512 and 4096 rows, maze hard's fast path on the card against the CPU state
by state, two launches per refill pass, and the reset of every game that
generates a maze (maze, chaser, jumper, heist) against the CPU's.  This
file imports no JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from procgen_torch import cuda_build
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch import telemetry
from procgen_torch.bench import synth_assets
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import LEVELGEN_SPAN, make_fast_fns
from procgen_torch.render import assets
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template, tree_leaves_with_names

I32 = torch.int32


def _block(seeds, draws: int, device="cpu"):
    seeds = torch.as_tensor(np.asarray(seeds, np.int32), device=device)
    return R.mt_block_open(R.mt_seed(seeds), draws)


def _seeds(n: int, salt: int):
    return np.random.RandomState(salt).randint(0, 2**31 - 1, size=n)


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _host_lib():
    lib = cuda_build.load("mazegen_host")
    if lib.mazegen_generate_host.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.mazegen_generate_host.argtypes = [ptr] * 3 + [i] * 5 + [ptr] * 4
        lib.mazegen_place_host.argtypes = [ptr] * 4 + [i] * 6 + [ptr] * 3
        lib.mazegen_generate_host.restype = lib.mazegen_place_host.restype = i
    return lib


def host_maze(blk, dims, max_dim, start_obj, num_objs, max_tries):
    """``generate_maze`` then ``place_objects`` through the host build;
    returns (maze result, cursor after the maze, cursor after placing)."""
    lib = _host_lib()
    B, D = blk.vals.shape
    AD = max_dim + 2
    vals = blk.vals.contiguous()
    md = torch.as_tensor(dims).to(I32).contiguous()
    grid = torch.empty((B, AD, AD), dtype=I32)
    free = torch.empty((B, max_dim * max_dim), dtype=I32)
    nf = torch.empty((B,), dtype=I32)
    cur1 = torch.empty((B,), dtype=I32)
    cur2 = torch.empty((B,), dtype=I32)
    lib.mazegen_generate_host(*_ptrs(vals, blk.cursor, md), B, D, max_dim, O.WALL_OBJ,
                              O.SPACE, *_ptrs(grid, free, nf, cur1))
    maze = mazegen.MazeResult(blk.replace(cursor=cur1), grid.clone(), free.clone(), nf)
    lib.mazegen_place_host(*_ptrs(vals, cur1, md, nf), B, D, max_dim, start_obj, num_objs,
                           max_tries, *_ptrs(grid, free, cur2))
    return maze, cur1, mazegen.MazeResult(blk.replace(cursor=cur2), grid, free, nf)


def ref_maze(blk, dims, max_dim, start_obj, num_objs, max_tries):
    md = torch.as_tensor(dims).to(I32)
    maze = mazegen.generate_maze_ref(blk, md, max_dim)
    rs, placed = mazegen.place_objects_ref(maze.rng, maze, start_obj, num_objs, md, max_dim,
                                           max_tries)
    return maze, maze.rng.cursor, placed.replace(rng=rs)


def assert_same(got, want):
    g_maze, g_cur, g_placed = got
    w_maze, w_cur, w_placed = want
    for name in ("grid", "free_cells", "num_free_cells"):
        for g, w, stage in ((g_maze, w_maze, "maze"), (g_placed, w_placed, "placed")):
            a, b = getattr(g, name).cpu(), getattr(w, name).cpu()
            assert torch.equal(a, b), f"{stage} {name} differs in rows {_rows(a, b)}"
    assert torch.equal(g_cur.cpu(), w_cur.cpu()), "cursor after the maze differs"
    assert torch.equal(g_placed.rng.cursor.cpu(), w_placed.rng.cursor.cpu()), (
        "cursor after placing differs")


def _rows(a, b):
    return torch.nonzero((a != b).reshape(a.shape[0], -1).any(1)).flatten().tolist()[:8]


def _case(max_dim, dims, draws=512, start_obj=2, num_objs=1, max_tries=32, salt=0):
    blk = _block(_seeds(len(dims), salt + 7 * max_dim + len(dims)), draws)
    dims = torch.as_tensor(np.asarray(dims, np.int32))
    args = (dims, max_dim, start_obj, num_objs, max_tries)
    assert_same(host_maze(blk, *args), ref_maze(blk, *args))


# every maze size of maze easy, hard and memory (max_dim 15, 25, 31)
SIZES = [(m, d) for m in (15, 25, 31) for d in range(3, m + 1, 2)]


@pytest.mark.parametrize("max_dim,dim", SIZES)
def test_host_build_matches_plain_at_every_size(max_dim, dim):
    _case(max_dim, [dim] * 4, salt=dim)


# the max_dim of every caller: jumper (6, 13, 15), chaser (11, 13, 19),
# heist (9, 13, 23), maze (15, 25, 31); a batch of every size 1..max_dim
@pytest.mark.parametrize("max_dim", [6, 9, 11, 13, 15, 19, 23, 25, 31])
def test_host_build_matches_plain_on_mixed_sizes(max_dim):
    _case(max_dim, list(range(1, max_dim + 1)), salt=1)


@pytest.mark.parametrize("max_dim,dim,draws", [(25, 25, 64), (25, 25, 313), (31, 31, 100),
                                              (15, 9, 20), (3, 3, 2)])
def test_host_build_matches_plain_when_the_cursor_clamps(max_dim, dim, draws):
    """Blocks shorter than the draws: reads clamp at D - 1 and the cursor
    runs on past D."""
    _case(max_dim, [dim] * 3, draws=draws, salt=2)


@pytest.mark.parametrize("dim,num_objs,max_tries", [(3, 1, 32), (3, 6, 2), (5, 12, 1),
                                                    (7, 4, 0), (25, 3, 32)])
def test_host_build_matches_plain_when_placing_many(dim, num_objs, max_tries):
    """More objects than free cells, few retries: placements exhaust their
    redraws and land on taken cells or cell 0, as the plain version's do."""
    _case(25, [dim] * 6, start_obj=5, num_objs=num_objs, max_tries=max_tries, salt=3)


def test_cpu_tensors_run_the_plain_version():
    blk = _block(_seeds(4, 4), 512)
    dims = torch.tensor([3, 9, 15, 25], dtype=I32)
    before = mazegen.launches
    got = ref_maze(blk, dims, 25, 2, 1, 32)
    maze = mazegen.generate_maze(blk, dims, 25)
    rs, placed = mazegen.place_objects(maze.rng, maze, 2, 1, dims, 25)
    assert_same((maze, maze.rng.cursor, placed.replace(rng=rs)), got)
    assert mazegen.launches == before


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the maze kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [512, 4096])
@pytest.mark.parametrize("max_dim", [15, 25, 31])
def test_kernel_matches_plain(card, rows, max_dim):
    rs = np.random.RandomState(rows + max_dim)
    dims = torch.as_tensor(rs.randint(0, (max_dim - 1) // 2, size=rows) * 2 + 3, dtype=I32)
    blk = _block(_seeds(rows, max_dim), 512)
    gblk = _block(_seeds(rows, max_dim), 512, device=card)
    before = mazegen.launches
    maze = mazegen.generate_maze(gblk, dims.to(card), max_dim)
    grs, placed = mazegen.place_objects(maze.rng, maze, 2, 1, dims.to(card), max_dim)
    torch.cuda.synchronize()
    assert mazegen.launches == before + 2
    got = (maze, maze.rng.cursor, placed.replace(rng=grs))
    assert_same(got, ref_maze(blk, dims, max_dim, 2, 1, 32))


def _maze_hard(n):
    cfg = EnvConfig(env_name="maze", num_envs=n, distribution_mode=DistributionMode.hard,
                    rand_seed=31, use_generated_assets=True)
    gd = make_game(cfg)
    return cfg, gd, RenderPack(gd, cfg)


def _fast_run(dev, steps, n=256, bucket=64):
    """Maze hard's fast path from a cold start with random actions; returns
    the states after the start and after each step."""
    cfg, gd, pack = _maze_hard(n)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=bucket)
    actions = np.random.RandomState(5).randint(0, 15, size=(steps, n)).astype(np.int32)
    fs = init.cold(seeded_template(gd, cfg, n, device=dev))
    out = [fs]
    for t in range(steps):
        fs = step(fs, torch.as_tensor(actions[t], device=dev))
        out.append(fs)
    return out


@pytest.mark.cuda
def test_fast_path_refills_match_cpu(card):
    steps = 40
    gpu, cpu = _fast_run(card, steps), _fast_run("cpu", steps)
    refilled = 0
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        g_leaves, c_leaves = tree_leaves_with_names(g), tree_leaves_with_names(c)
        assert [k for k, _ in g_leaves] == [k for k, _ in c_leaves]
        for (k, a), (_, b) in zip(g_leaves, c_leaves):
            assert torch.equal(a.cpu(), b), f"{k} differs at step {t}"
        refilled += int(c.state.done.sum()) if t else 0
    assert refilled > 0, "no episode ended, so no step refilled"


@pytest.mark.cuda
def test_two_launches_per_refill_pass(card):
    from torch.profiler import ProfilerActivity, profile

    before = mazegen.launches
    with profile(activities=[ProfilerActivity.CPU]):
        _fast_run(card, 20)
    snap = telemetry.snapshot()
    passes = snap["spans"][LEVELGEN_SPAN][0]
    assert passes >= 4  # the cold start's 256 rows in buckets of 64, then the steps'
    assert mazegen.launches - before == 2 * passes
    assert snap["counters"]["mazegen.kernel_rows"] == 2 * snap["counters"]["refill.rows"]


# every caller of generate_maze and the launches of its reset: maze's maze
# and goal; chaser and jumper through generate_maze_no_dead_ends, heist
# through generate_maze_with_doors
CALLERS = [("maze", "easy", 2), ("maze", "memory", 2), ("chaser", "easy", 1),
           ("chaser", "hard", 1), ("jumper", "easy", 1), ("jumper", "hard", 1),
           ("jumper", "memory", 1), ("heist", "easy", 1), ("heist", "hard", 1),
           ("heist", "memory", 1)]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """A synthetic asset root: heist reads its sprites' aspect ratios at
    construction."""
    root = synth_assets.write_root(tmp_path_factory.mktemp("assets"), seed=0)
    mp = pytest.MonkeyPatch()
    mp.setenv(assets.ROOT_ENV, str(root))
    assets.clear_caches()
    try:
        yield root
    finally:
        mp.undo()
        assets.clear_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("game,mode,launched", CALLERS)
def test_callers_reset_on_the_card_matches_cpu(card, synth_root, game, mode, launched):
    from procgen_torch.engine.game import reset_env

    cfg = EnvConfig(env_name=game, num_envs=64, distribution_mode=DistributionMode[mode],
                    rand_seed=17, use_generated_assets=True)
    gd = make_game(cfg)
    before = mazegen.launches
    got = reset_env(gd, cfg, seeded_template(gd, cfg, 64, device=card))
    torch.cuda.synchronize()
    assert mazegen.launches - before == launched
    want = reset_env(gd, cfg, seeded_template(gd, cfg, 64, device="cpu"))
    g_leaves, w_leaves = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [k for k, _ in g_leaves] == [k for k, _ in w_leaves]
    differ = [k for (k, a), (_, b) in zip(g_leaves, w_leaves) if not torch.equal(a.cpu(), b)]
    assert not differ, f"{game} {mode}: {differ} differ from the CPU's reset"
