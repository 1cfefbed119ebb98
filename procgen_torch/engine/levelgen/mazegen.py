"""Kruskal maze generation (reference procgen/src/mazegen.cpp); counterpart
of ``procgen_tpu/engine/levelgen/mazegen.py``, batched over a leading env
axis B.

* the wall list is built for the maximum dim and stably compacted per env to
  the reference's construction order (verticals i-major, then horizontals,
  mazegen.cpp:138-151);
* ``vector::erase`` of a random wall becomes a ``removed`` bitmap: the
  logical index drawn by ``randn(walls.size())`` maps to the n-th surviving
  wall through a cumulative count;
* set partitions are a per-cell label array; merging set s0 into s1 is a
  relabel.

Loop trip counts are fixed (W_MAX iterations, inactive tail masked) and
draws are masked, so each env consumes exactly the reference's stream.
That is the plain version (``generate_maze_ref``, ``place_objects_ref``),
which CPU tensors run.  For CUDA tensors ``generate_maze`` and
``place_objects`` launch the kernels of ``procgen_torch/csrc/mazegen.cu``
(one thread per env; same draws, same bits) or raise; ``launches`` counts
them.  The door variant (mazegen.cpp:211-289, ``generate_maze_with_doors``)
runs its breadth-first searches as loops of batched mask dilations.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from procgen_torch import cuda_build, telemetry
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.engine.rand_util import choose_n_erase, choose_nth_masked, first_true
from procgen_torch.state import I32

MAZE_OFFSET = 1  # mazegen.h
DOORS_SPAN = "procgen_torch.mazegen.doors"
# how many rounds a search runs between host reads of whether any env is
# still searching (each read synchronizes the stream)
_SYNC_EVERY = 4
KERNEL_MAX_DIM = 31  # mazegen.cuh: MAX_DIM

launches = 0  # kernel launches since import (reset by callers that count)


@dataclasses.dataclass
class MazeResult:
    rng: R.MTBlock
    grid: torch.Tensor  # int32 (B, AD, AD) indexed [y, x]; AD = max_dim + 2
    free_cells: torch.Tensor  # int32 (B, max_dim**2) in insertion order
    num_free_cells: torch.Tensor  # int32 (B,)

    def replace(self, **kw) -> "MazeResult":
        return dataclasses.replace(self, **kw)


def _static_wall_table(max_dim: int):
    """Wall candidates for the maximum dim, in reference construction order.

    Returns (coords (Wmax, 4) [x1, y1, x2, y2], cond_ij (Wmax, 2), is_vertical
    (Wmax,)); validity for an actual ``maze_dim`` is evaluated per env.
    Vertical group (mazegen.cpp:138-144): i odd, j even, wall (i-1,j,i+1,j).
    Horizontal group (:146-151): i even, j odd, wall (i,j-1,i,j+1).
    """
    walls = []
    conds = []
    for i in range(1, max_dim, 2):
        for j in range(0, max_dim, 2):
            walls.append((i - 1, j, i + 1, j))
            conds.append((i, j))
    n_v = len(walls)
    for i in range(0, max_dim, 2):
        for j in range(1, max_dim, 2):
            walls.append((i, j - 1, i, j + 1))
            conds.append((i, j))
    coords = np.asarray(walls, np.int64)
    cond_ij = np.asarray(conds, np.int64)
    is_vertical = np.arange(len(walls)) < n_v
    return coords, cond_ij, is_vertical


@functools.lru_cache(maxsize=None)
def _wall_tables(max_dim: int, device: str):
    """Device copies of the wall table: (coords, i, j, odd coordinate)."""
    coords, cond_ij, is_vertical = _static_wall_table(max_dim)
    odd = np.where(is_vertical, cond_ij[:, 0], cond_ij[:, 1])
    return tuple(
        torch.as_tensor(a, device=device)
        for a in (coords, cond_ij[:, 0], cond_ij[:, 1], odd)
    )


@functools.lru_cache(maxsize=None)
def _neighbor_offsets(AD: int, device: str):
    """Flat-index steps to the left, up, down and right neighbors."""
    return torch.as_tensor(np.array([-1, -AD, AD, 1], np.int64)).to(device)


def _set_free_cell(grid, free_cells, in_free_set, num_free, md, x, y, do):
    """mazegen.cpp:26-34, applied where ``do`` (all (B,) except the tables)."""
    B, AD, _ = grid.shape
    NC = free_cells.shape[1]
    b = torch.arange(B, device=grid.device)
    gy, gx = y + MAZE_OFFSET, x + MAZE_OFFSET
    grid[b, gy, gx] = torch.where(do, O.SPACE, grid[b, gy, gx])
    cell = md * y + x
    cellc = cell.clamp(0, NC - 1)
    is_new = do & ~in_free_set[b, cellc]
    slot = num_free.clamp(0, NC - 1)
    free_cells[b, slot] = torch.where(is_new, cell.to(I32), free_cells[b, slot])
    in_free_set[b, cellc] = in_free_set[b, cellc] | is_new
    return num_free + is_new.to(I32)


def generate_maze_ref(rs: R.MTBlock, maze_dim, max_dim: int) -> MazeResult:
    """mazegen.cpp:112-187 for a batch; ``maze_dim`` (B,) odd, 3..max_dim."""
    dev = rs.cursor.device
    B = rs.cursor.shape[0]
    AD = max_dim + 2
    NC = max_dim * max_dim
    b = torch.arange(B, device=dev)

    grid = torch.full((B, AD, AD), O.WALL_OBJ, dtype=I32, device=dev)
    grid[:, MAZE_OFFSET, MAZE_OFFSET] = 0  # cell (0,0) := 0 (:119)
    labels = torch.arange(NC, dtype=torch.int64, device=dev).repeat(B, 1)
    free_cells = torch.zeros((B, NC), dtype=I32, device=dev)
    in_free_set = torch.zeros((B, NC), dtype=torch.bool, device=dev)
    num_free = torch.zeros((B,), dtype=I32, device=dev)

    coords, cond_i, cond_j, odd_c = _wall_tables(max_dim, str(dev))
    W_MAX = coords.shape[0]
    # validity vs the actual maze_dim: loop bounds i, j < maze_dim plus the
    # interior guard 0 < odd coordinate < maze_dim - 1
    md = maze_dim.to(torch.int64)
    mdc = md[:, None]
    valid = (cond_i < mdc) & (cond_j < mdc) & (odd_c < mdc - 1) & (odd_c > 0)

    # stable compaction to reference order (entries past n_walls never read)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    walls = coords[order]  # (B, W_MAX, 4)
    n_walls = valid.to(torch.int64).sum(1)

    removed = torch.zeros((B, W_MAX), dtype=torch.bool, device=dev)
    for k in range(W_MAX):
        active = k < n_walls
        remaining = n_walls - k
        rs, n = R.rs_randn(rs, remaining.clamp(min=1), active=active)
        # logical n -> physical index among surviving walls, original order
        alive_pos = torch.cumsum((~removed).to(torch.int64), 1) - 1
        match = ~removed & (alive_pos == n[:, None].to(torch.int64))
        phys = torch.argmax(match.to(torch.uint8), 1)
        w = walls[b, phys]
        x1, y1, x2, y2 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
        s0 = labels[b, (md * y1 + x1).clamp(0, NC - 1)]
        s1 = labels[b, (md * y2 + x2).clamp(0, NC - 1)]
        x0 = torch.div(x1 + x2, 2, rounding_mode="floor")
        y0 = torch.div(y1 + y2, 2, rounding_mode="floor")
        center = md * y0 + x0
        can_remove = (grid[b, y0 + MAZE_OFFSET, x0 + MAZE_OFFSET] == O.WALL_OBJ) & (
            s0 != s1
        )
        do = active & can_remove

        for cx, cy in ((x1, y1), (x0, y0), (x2, y2)):
            num_free = _set_free_cell(
                grid, free_cells, in_free_set, num_free, md, cx, cy, do
            )

        # merge s0 -> s1 and add center (mazegen.cpp:176-183)
        labels = torch.where(do[:, None] & (labels == s0[:, None]), s1[:, None], labels)
        cc = center.clamp(0, NC - 1)
        labels[b, cc] = torch.where(do, s1, labels[b, cc])
        removed[b, phys] = removed[b, phys] | active
    return MazeResult(rs, grid, free_cells, num_free)


def _neighbor_vals(grid):
    """Values of the 4-neighbors of every cell of ``grid`` (B, AD, AD) in
    reference push order (mazegen.cpp:48-67): left (x-1), up (y-1), down
    (y+1), right (x+1).  Out-of-array neighbors read INVALID_OBJ (the
    reference's border get_obj, mazegen.cpp:36-45)."""
    pad = torch.nn.functional.pad(grid, (1, 1, 1, 1), value=O.INVALID_OBJ)
    return (
        pad[:, 1:-1, :-2], pad[:, :-2, 1:-1], pad[:, 2:, 1:-1], pad[:, 1:-1, 2:],
    )


def _dilate(vis):
    """4-neighborhood dilation of a (B, H, W) bool mask."""
    out = vis.clone()
    out[:, :, 1:] |= vis[:, :, :-1]
    out[:, :, :-1] |= vis[:, :, 1:]
    out[:, 1:, :] |= vis[:, :-1, :]
    out[:, :-1, :] |= vis[:, 1:, :]
    return out


def generate_maze_no_dead_ends(rs: R.MTBlock, maze_dim, max_dim: int):
    """mazegen.cpp:189-210: a perfect maze, then a random wall next to every
    dead end opened (MsPacman style).  ``maze_dim`` (B,) odd, <= max_dim.

    The dead-end scan is sequential in ascending cell order (each opened
    wall becomes SPACE and changes the neighbor counts of later cells), so
    it loops over the cells, each step one batched op over envs with masked
    draws.  Cells outside the maze are never dead ends and are not visited.
    Returns (rs, grid) with grid (B, max_dim+2, max_dim+2) int32 [y, x]."""
    res = generate_maze(rs, maze_dim, max_dim)
    rs = res.rng
    B = res.grid.shape[0]
    AD = max_dim + 2
    dev = res.grid.device
    md = maze_dim.to(torch.int64)[:, None]
    flat = res.grid.reshape(B, AD * AD).clone()
    cell = torch.arange(AD * AD, device=dev)
    cx, cy = cell % AD, torch.div(cell, AD, rounding_mode="floor")
    interior = (cx >= 1) & (cx <= md) & (cy >= 1) & (cy <= md)  # (B, AD*AD)
    offs = _neighbor_offsets(AD, str(dev))
    for y in range(1, max_dim + 1):
        for x in range(1, max_dim + 1):
            i = y * AD + x
            nidx = [i - 1, i - AD, i + AD, i + 1]  # l, u, d, r push order
            nvals = torch.where(interior[:, nidx], flat[:, nidx], O.INVALID_OBJ)
            n_space = (nvals == O.SPACE).to(I32).sum(1)
            wall_mask = nvals == O.WALL_OBJ
            n_wall = wall_mask.to(I32).sum(1)
            do = interior[:, i] & (flat[:, i] == O.SPACE) & (n_space == 1) & (n_wall > 0)
            rs, n = R.rs_randn(rs, n_wall.clamp(min=1), active=do)
            # the n-th wall neighbor in l/u/d/r push order
            sel = choose_nth_masked(wall_mask, n)
            widx = (i + offs)[sel][:, None]
            flat.scatter_(1, widx, torch.where(do[:, None], O.SPACE, torch.gather(flat, 1, widx)))
    return rs, flat.reshape(B, AD, AD)


def _door_adjacent(grid):
    """(B, AD * AD): cells with a DOOR_OBJ 4-neighbour."""
    B = grid.shape[0]
    return torch.stack([v == O.DOOR_OBJ for v in _neighbor_vals(grid)]).any(0).reshape(B, -1)


def _grow(vis, space, AD: int):
    """The cells one 4-step from ``vis`` (B, AD * AD) that are ``space`` and
    not yet visited."""
    B = vis.shape[0]
    return _dilate(vis.reshape(B, AD, AD)).reshape(B, -1) & space & ~vis


def generate_maze_with_doors(rs, num_doors, maze_dim, max_dim: int, max_doors: int = 3):
    """mazegen.cpp:211-289: a perfect maze, then doors on forks and a key
    (or, last, the exit) behind each, found in the reference's order.
    ``num_doors`` (B,) <= max_doors, ``maze_dim`` (B,) odd.  Returns (rs,
    grid) with grid (B, max_dim + 2, max_dim + 2) int32 [y, x] holding
    WALL_OBJ / SPACE / AGENT_OBJ / EXIT_OBJ / DOOR_OBJ + k / KEY_OBJ + k.

    The reference's ``std::set`` breadth-first search (expand_to_type)
    visits each wave in ascending cell order, so the door it meets first is
    next to the smallest cell of the first wave that touches one; each wave
    is a batched mask dilation.  The searches run until no env is still
    searching, read on the host every few waves (an env that has stopped
    changes nothing)."""
    with telemetry.span(DOORS_SPAN):
        return _generate_maze_with_doors(rs, num_doors, maze_dim, max_dim, max_doors)


def _generate_maze_with_doors(rs, num_doors, maze_dim, max_dim: int, max_doors: int):
    res = generate_maze(rs, maze_dim, max_dim)
    rs = res.rng
    B = res.grid.shape[0]
    AD = max_dim + 2
    dev = res.grid.device
    b = torch.arange(B, device=dev)
    grid = res.grid

    # forks: space cells with > 2 space neighbours (mazegen.cpp:215-227)
    nsp = sum((v == O.SPACE).to(I32) for v in _neighbor_vals(grid))
    forks = (grid == O.SPACE) & (nsp > 2)
    # chosen = choose_n(forks, num_doors) (mazegen.cpp:229-236)
    rs, picks, ndoors = choose_n_erase(rs, forks.reshape(B, -1), max_doors, num_doors)
    flat = grid.reshape(B, -1).clone()
    for s in range(max_doors):
        p = picks[:, s].to(torch.int64)
        flat[b, p] = torch.where(s < ndoors, O.DOOR_OBJ, flat[b, p])

    # agent cell: choose_one(space), redrawn while next to a door
    # (mazegen.cpp:238-253; the reference package bounds it at 64 draws)
    door_adj = _door_adjacent(flat.reshape(B, AD, AD))
    space = flat == O.SPACE
    n_space = space.to(I32).sum(1)
    rs, m = R.rs_randn(rs, n_space)
    cell = choose_nth_masked(space, m)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    for k in range(64):
        active = active & torch.gather(door_adj, 1, cell[:, None])[:, 0]
        if k % _SYNC_EVERY == 0:
            telemetry.count("host_reads.mazegen.agent_cell_test")
            if not bool(active.any()):
                break
        rs, m = R.rs_randn(rs, n_space, active=active)
        cell = torch.where(active, choose_nth_masked(space, m), cell)
    flat[b, cell] = O.AGENT_OBJ
    visited = torch.zeros((B, AD * AD), dtype=torch.bool, device=dev)
    visited[b, cell] = True

    offs = _neighbor_offsets(AD, str(dev))
    for round_ in range(max_doors + 1):
        round_active = round_ <= ndoors
        search_active = round_ < ndoors
        door_adj = _door_adjacent(flat.reshape(B, AD, AD))
        space = flat == O.SPACE

        # expand_to_type(s0, s1, DOOR_OBJ) (mazegen.cpp:69-98): waves until
        # one touches a door
        vis, wave = visited.clone(), visited.clone()
        found = torch.zeros((B,), dtype=torch.bool, device=dev)
        while True:
            for _ in range(_SYNC_EVERY):
                on = search_active & ~found & wave.any(1)
                hit = on & (wave & door_adj).any(1)
                new = _grow(vis, space, AD)
                grow = (on & ~hit)[:, None]
                vis = torch.where(grow, vis | new, vis)
                wave = torch.where(grow, new, wave)
                found = found | hit
            telemetry.count("host_reads.mazegen.door_search_test")
            if not bool((search_active & ~found & wave.any(1)).any()):
                break
        found_cell = first_true(wave & door_adj)
        # the first DOOR_OBJ neighbour in push order left, up, down, right
        nbr = found_cell[:, None] + offs[None, :]
        is_door = torch.gather(flat, 1, nbr.clamp(0, AD * AD - 1)) == O.DOOR_OBJ
        fd = torch.gather(nbr, 1, torch.where(is_door.any(1), first_true(is_door), 3)[:, None])[:, 0]
        fd = fd.clamp(0, AD * AD - 1)
        rename = search_active & found
        flat[b, fd] = torch.where(rename, O.DOOR_OBJ + round_ + 1, flat[b, fd])
        space = flat == O.SPACE

        # expand_to_type(s0, s1, -999): the whole region a renamed door
        # closes off
        grew = torch.ones((B,), dtype=torch.bool, device=dev)
        while True:
            for _ in range(_SYNC_EVERY):
                on = round_active & grew
                new = _grow(vis, space, AD) & on[:, None]
                vis = vis | new
                grew = on & new.any(1)
            telemetry.count("host_reads.mazegen.region_test")
            if not bool(grew.any()):
                break
        s1 = vis & ~visited
        rs, n = R.rs_randn(rs, s1.to(I32).sum(1).clamp(min=1), active=round_active)
        key_cell = choose_nth_masked(s1, n)
        val = torch.where(round_ == ndoors, O.EXIT_OBJ, O.KEY_OBJ + round_ + 1).to(I32)
        flat[b, key_cell] = torch.where(round_active, val, flat[b, key_cell])
        visited = torch.where(round_active[:, None], vis, visited)
        visited[b, fd] = visited[b, fd] | rename
    return rs, flat.reshape(B, AD, AD)


def place_objects_ref(
    rs: R.MTBlock,
    res: MazeResult,
    start_obj: int,
    num_objs: int,
    maze_dim,
    max_dim: int,
    max_tries: int = 32,
):
    """mazegen.cpp:292-306: place objects on distinct free cells (never cell
    0, the agent start).  Rejection redraws are bounded by ``max_tries``
    (P(exhaust) < (k/num_free)^32).  Returns (rs, res) with the objects
    written into res.grid."""
    grid = res.grid.clone()
    free_cells = res.free_cells.clone()
    NC = max_dim * max_dim
    B = grid.shape[0]
    b = torch.arange(B, device=grid.device)
    md = maze_dim.to(I32)

    def cell_at(m):
        return free_cells[b, m.clamp(0, NC - 1).to(torch.int64)]

    for j in range(num_objs):
        rs, m = R.rs_randn(rs, res.num_free_cells)
        active = torch.ones((B,), dtype=torch.bool, device=grid.device)
        for _ in range(max_tries):
            v = cell_at(m)
            active = active & ((v == -1) | (v == 0))
            rs, m2 = R.rs_randn(rs, res.num_free_cells, active=active)
            m = torch.where(active, m2, m)
        cell = cell_at(m)
        free_cells[b, m.clamp(0, NC - 1).to(torch.int64)] = -1
        cx = cell % md + MAZE_OFFSET
        cy = torch.div(cell, md, rounding_mode="floor") + MAZE_OFFSET
        grid[b, cy.to(torch.int64), cx.to(torch.int64)] = start_obj + j
    return rs, res.replace(grid=grid, free_cells=free_cells)


def _lib():
    lib = cuda_build.load("mazegen")
    if lib.mazegen_generate_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.mazegen_generate_launch.argtypes = [ptr] * 3 + [i] * 5 + [ptr] * 5
        lib.mazegen_place_launch.argtypes = [ptr] * 4 + [i] * 6 + [ptr] * 4
        lib.mazegen_generate_launch.restype = i
        lib.mazegen_place_launch.restype = i
    return lib


def _kernel_inputs(rs, maze_dim, max_dim: int, name: str):
    """Check the block and ``maze_dim`` for a kernel; returns (vals,
    maze_dim as contiguous int32, stream)."""
    dev = rs.cursor.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not 1 <= max_dim <= KERNEL_MAX_DIM:
        raise ValueError(f"{name}: max_dim {max_dim} is outside 1..{KERNEL_MAX_DIM}")
    vals = rs.vals.contiguous()
    B = rs.cursor.shape[0]
    if vals.dim() != 2 or vals.shape[0] != B or vals.dtype != torch.int64 or vals.device != dev:
        raise ValueError(f"{name}: block values {tuple(vals.shape)} {vals.dtype} on {vals.device}")
    if rs.cursor.dtype != I32 or not rs.cursor.is_contiguous():
        raise ValueError(f"{name}: the block cursor must be a contiguous int32 (B,) tensor")
    md = torch.as_tensor(maze_dim, device=dev).to(I32).contiguous()
    if md.shape != (B,):
        raise ValueError(f"{name}: maze_dim {tuple(md.shape)} is not ({B},)")
    return vals, md, torch.cuda.current_stream(dev).cuda_stream


def _launched(name: str, rc: int, rows: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (error {rc})")
    launches += 1
    telemetry.count("mazegen.kernel_rows", rows)


def generate_maze(rs: R.MTBlock, maze_dim, max_dim: int) -> MazeResult:
    """mazegen.cpp:112-187 for a batch; ``maze_dim`` (B,) 1..max_dim.  CPU
    tensors run ``generate_maze_ref``; CUDA tensors launch the kernel
    (``max_dim`` at most ``KERNEL_MAX_DIM``)."""
    if rs.cursor.device.type == "cpu":
        return generate_maze_ref(rs, maze_dim, max_dim)
    vals, md, stream = _kernel_inputs(rs, maze_dim, max_dim, "generate_maze")
    B, D = vals.shape
    AD = max_dim + 2
    dev = vals.device
    grid = torch.empty((B, AD, AD), dtype=I32, device=dev)
    free_cells = torch.empty((B, max_dim * max_dim), dtype=I32, device=dev)
    num_free = torch.empty((B,), dtype=I32, device=dev)
    cursor = torch.empty_like(rs.cursor)
    rc = _lib().mazegen_generate_launch(
        vals.data_ptr(), rs.cursor.data_ptr(), md.data_ptr(), B, D, max_dim,
        O.WALL_OBJ, O.SPACE, grid.data_ptr(), free_cells.data_ptr(),
        num_free.data_ptr(), cursor.data_ptr(), stream,
    )
    _launched("generate_maze", rc, B)
    return MazeResult(rs.replace(cursor=cursor), grid, free_cells, num_free)


def place_objects(
    rs: R.MTBlock,
    res: MazeResult,
    start_obj: int,
    num_objs: int,
    maze_dim,
    max_dim: int,
    max_tries: int = 32,
):
    """mazegen.cpp:292-306, as ``place_objects_ref`` (which CPU tensors
    run); CUDA tensors launch the kernel, which writes the objects into
    copies of ``res.grid`` and ``res.free_cells``."""
    if rs.cursor.device.type == "cpu":
        return place_objects_ref(rs, res, start_obj, num_objs, maze_dim, max_dim, max_tries)
    vals, md, stream = _kernel_inputs(rs, maze_dim, max_dim, "place_objects")
    B, D = vals.shape
    AD = max_dim + 2
    grid = res.grid.to(I32).contiguous().clone()
    free_cells = res.free_cells.to(I32).contiguous().clone()
    num_free = res.num_free_cells.to(I32).contiguous()
    shapes = [(grid, (B, AD, AD)), (free_cells, (B, max_dim * max_dim)), (num_free, (B,))]
    if any(t.shape != shape or t.device != vals.device for t, shape in shapes):
        raise ValueError("place_objects: the maze result does not match the block and max_dim")
    cursor = torch.empty_like(rs.cursor)
    rc = _lib().mazegen_place_launch(
        vals.data_ptr(), rs.cursor.data_ptr(), md.data_ptr(), num_free.data_ptr(), B, D,
        max_dim, start_obj, num_objs, max_tries, grid.data_ptr(), free_cells.data_ptr(),
        cursor.data_ptr(), stream,
    )
    _launched("place_objects", rc, B)
    return rs.replace(cursor=cursor), res.replace(grid=grid, free_cells=free_cells)
