"""RoomGenerator: cellular-automaton caves (reference roomgen.{h,cpp});
counterpart of ``procgen_tpu/engine/levelgen/roomgen.py``, batched over a
leading env axis N.

Every function takes a padded ``(N, Hm, Wm)`` int32 grid (row-major [y, x])
and a per-env ``dim`` (N,): the worlds of the games that use it (jumper,
caveflyer) are square, and cells at or past ``dim`` are not part of them.

Two loops of the reference package run to a fixed point; here they run in
host loops whose bound is read every few iterations (each read is one
device sync):

* ``best_room_mask`` labels components by min-label propagation, here with
  pointer jumping (a label is a cell of its own component with an index no
  larger than the cell's, so reading the label's label is again one);
* ``find_path_mask`` reproduces the reference's FIFO BFS (pushes left, down,
  up, right; the parent chain decides which shortest path is kept) one
  frontier per iteration: within a frontier the queue is ordered by the
  parent's queue position, then by push direction, so the first neighbour
  in that order is the cell's parent.
"""

from __future__ import annotations

import functools

import torch

from procgen_torch import objects as O
from procgen_torch import telemetry
from procgen_torch.state import I32

# (dx, dy) of the reference's neighbour pushes, in push order
# (roomgen.cpp:92-106)
_PUSH = ((-1, 0), (0, -1), (0, 1), (1, 0))
# layers of the BFS, and label-propagation rounds, between two device syncs
_SYNC_EVERY = 8
# profiler span of the path search (read by bench/op_counts.py)
FIND_PATH_SPAN = "procgen_torch.roomgen.find_path"


@functools.lru_cache(maxsize=None)
def _parent_offsets(Wm: int, device: str):
    """Flat step from a cell back to the neighbour that pushed it, per push
    direction (built once per device: a host-to-device copy syncs)."""
    return torch.tensor([-dx - dy * Wm for dx, dy in _PUSH], device=device)


def _in_dim(dim, Hm, Wm):
    dev = dim.device
    xs = torch.arange(Wm, device=dev)[None, None, :]
    ys = torch.arange(Hm, device=dev)[None, :, None]
    d = dim[:, None, None]
    return (xs < d) & (ys < d)


def shift(a, dx, dy, fill):
    """``out[y, x] = a[y + dy, x + dx]`` over the last two axes, ``fill``
    outside."""
    Hm, Wm = a.shape[-2:]
    out = torch.full_like(a, fill)
    ys = slice(max(0, -dy), Hm - max(0, dy))
    xs = slice(max(0, -dx), Wm - max(0, dx))
    yt = slice(max(0, dy), Hm - max(0, -dy))
    xt = slice(max(0, dx), Wm - max(0, -dx))
    out[..., ys, xs] = a[..., yt, xt]
    return out


def ca_update(grid, dim, oob_is_wall=True):
    """RoomGenerator::update (roomgen.cpp:21-36): a cell with >= 5 WALL
    cells among its 3x3 neighbourhood (out of bounds counts as wall while
    ``oob_is_wall``) becomes WALL, else SPACE.  Cells past ``dim`` keep
    their values."""
    Hm, Wm = grid.shape[1:]
    inside = _in_dim(dim, Hm, Wm)
    wall = (inside & (grid == O.WALL_OBJ)).to(I32)
    n_in = inside.to(I32)
    s = torch.zeros_like(wall)
    cnt = torch.zeros_like(wall)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = s + shift(wall, dx, dy, 0)
            cnt = cnt + shift(n_in, dx, dy, 0)
    count = s + (9 - cnt) if oob_is_wall else s
    new = torch.where(count >= 5, O.WALL_OBJ, O.SPACE).to(grid.dtype)
    return torch.where(inside, new, grid)


def best_room_mask(grid, dim):
    """find_best_room (roomgen.cpp:126-145): the largest 4-connected SPACE
    component as a bool mask; ties go to the component holding the smallest
    cell index (the reference keeps the first strictly larger room of its
    ascending scan).

    Each round takes the least label of the 4 neighbours, then the label of
    the label.  Every label stays a cell of the same component with an index
    no larger than the cell's, so the fixed point labels each component with
    its least cell, the reference package's result.  The loop stops at the
    first checked round that changed nothing: one more round at the fixed
    point changes nothing, so the check may come every few rounds."""
    N, Hm, Wm = grid.shape
    G = Hm * Wm
    space = _in_dim(dim, Hm, Wm) & (grid == O.SPACE)
    big = G  # the label of non-space cells; never the least of a room
    idx = torch.arange(G, device=grid.device).reshape(1, Hm, Wm)
    labels = torch.where(space, idx, big)
    while True:
        before = labels
        for _ in range(_SYNC_EVERY):
            m = labels
            for dx, dy in _PUSH:
                m = torch.minimum(m, shift(labels, dx, dy, big))
            m = torch.where(space, m, big).reshape(N, G)
            jump = torch.gather(m, 1, m.clamp(max=G - 1))
            labels = torch.where(space, torch.minimum(m, jump).reshape(N, Hm, Wm), big)
        telemetry.count("host_reads.roomgen.label_test")
        if not bool((labels != before).any()):
            break
    flat = labels.reshape(N, G)
    sizes = torch.zeros((N, G + 1), dtype=I32, device=grid.device)
    sizes.scatter_add_(1, flat, space.reshape(N, G).to(I32))
    # the largest room, ties to the smallest label; fits int32 for the
    # largest world (60x60: 3600 * 3601)
    key = sizes[:, :G] * (G + 1) - torch.arange(G, dtype=I32, device=grid.device)
    best = torch.argmax(key, 1)
    return space & (labels == best[:, None, None])


def expand_mask(grid, dim, mask, n: int):
    """expand_room (roomgen.cpp:147-177): ``n`` rounds of 8-neighbourhood
    growth into SPACE cells."""
    Hm, Wm = grid.shape[1:]
    space = _in_dim(dim, Hm, Wm) & (grid == O.SPACE)
    out = mask
    for _ in range(n):
        src = out & space
        grown = torch.zeros_like(out)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                grown = grown | shift(src, dx, dy, False)
        out = out | (grown & space)
    return out


def find_path_mask(grid, dim, src, dst):
    """find_path (roomgen.cpp:71-124): the reference's BFS from ``src`` to
    ``dst`` (flat indices ``y * dim + x``, (N,)), returned as the cells of
    the backtracked path, a bool (N, Hm * Wm) vector over flat indices in
    dim coordinates.  No path: all False; src == dst: that cell alone.

    The reference queue never marks ``src`` covered, so a neighbour pushes
    it again; popped, it pushes nothing (its neighbours were covered when it
    was first popped) and discovers no cell, so it is marked covered here
    from the start.  A cell of layer d + 1 is discovered by the first popped
    of its layer-d neighbours; the queue orders layer d + 1 by the parent's
    position in layer d, then by push direction."""
    with telemetry.span(FIND_PATH_SPAN):
        return _find_path(grid, dim, src, dst)


def _find_path(grid, dim, src, dst):
    N, Hm, Wm = grid.shape
    G = Hm * Wm
    dev = grid.device
    dim64 = dim.to(torch.int64)
    space = _in_dim(dim, Hm, Wm) & (grid == O.SPACE)
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    sx, sy = src % dim64, torch.div(src, dim64, rounding_mode="floor")
    dx_, dy_ = dst % dim64, torch.div(dst, dim64, rounding_mode="floor")
    # flat (Hm, Wm) cell of src and dst; src itself need not be SPACE
    src_g = (sy.clamp(0, Hm - 1) * Wm + sx.clamp(0, Wm - 1))[:, None]
    dst_g = (dy_.clamp(0, Hm - 1) * Wm + dx_.clamp(0, Wm - 1))[:, None]
    cell = torch.arange(G, device=dev)[None, :]
    frontier = (cell == src_g).reshape(N, Hm, Wm)
    covered = frontier.clone()
    inf = 4 * G
    rank = torch.where(frontier, 0, inf)  # queue order within the frontier
    via = torch.zeros((N, Hm, Wm), dtype=torch.int64, device=dev)  # push dir
    found = (src == dst)
    depth = torch.zeros((N,), dtype=torch.int64, device=dev)
    layer = 0
    while True:
        for _ in range(_SYNC_EVERY):
            # a neighbour at -(dx, dy) pushes the cell in direction d
            key = torch.full((N, Hm, Wm), inf, dtype=torch.int64, device=dev)
            for d, (dx, dy) in enumerate(_PUSH):
                key = torch.minimum(key, shift(rank, -dx, -dy, inf) * 4 + d)
            new = (key < inf) & space & ~covered
            covered = covered | new
            via = torch.where(new, key % 4, via)
            layer += 1
            hit = ~found & torch.gather(new.reshape(N, G), 1, dst_g)[:, 0]
            depth = torch.where(hit, layer, depth)
            found = found | hit
            # dense queue order of the new frontier
            k = torch.where(new, key, inf).reshape(N, G)
            order = torch.sort(k, 1).indices
            dense = torch.empty_like(order).scatter_(1, order, cell.expand(N, G))
            rank = torch.where(new, dense.reshape(N, Hm, Wm), inf)
            frontier = new
        telemetry.count("host_reads.roomgen.frontier_test")
        if not bool((frontier.any((1, 2)) & ~found).any()):
            break

    # backtrack from dst along the push directions
    off = _parent_offsets(Wm, str(dev))
    path = torch.zeros((N, G), dtype=torch.bool, device=dev)
    via_flat = via.reshape(N, G)
    cur = dst_g[:, 0]
    telemetry.count("host_reads.roomgen.path_depth")
    steps = int(depth.max())
    for s in range(steps + 1):
        on = found & (s <= depth)
        path.scatter_(1, cur[:, None], (torch.gather(path, 1, cur[:, None])[:, 0] | on)[:, None])
        d = torch.gather(via_flat, 1, cur[:, None])[:, 0]
        cur = torch.where(on & (s < depth), cur + off[d], cur)
    # (Hm, Wm) cells -> flat dim coordinates
    gx, gy = cell % Wm, torch.div(cell, Wm, rounding_mode="floor")
    in_dim = (gx < dim64[:, None]) & (gy < dim64[:, None])
    tgt = torch.where(in_dim, gy * dim64[:, None] + gx, G)
    out = torch.zeros((N, G + 1), dtype=torch.bool, device=dev)
    out.scatter_(1, tgt, path & in_dim)
    return out[:, :G]


def flat_to_grid_mask(path_flat, dim, Hm: int, Wm: int):
    """Flat dim-coordinate bool (N, G) vector -> (N, Hm, Wm) mask."""
    N, G = path_flat.shape
    dev = path_flat.device
    xs = torch.arange(Wm, device=dev)[None, None, :]
    ys = torch.arange(Hm, device=dev)[None, :, None]
    d = dim.to(torch.int64)[:, None, None]
    flat = (ys * d + xs).clamp(0, G - 1).reshape(N, -1)
    ok = (xs < d) & (ys < d)
    return ok & torch.gather(path_flat, 1, flat).reshape(N, Hm, Wm)
