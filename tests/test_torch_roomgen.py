"""procgen_torch's cave room generator against procgen_tpu's, exact.

Each function of ``procgen_torch/engine/levelgen/roomgen.py`` runs on a
batch of seeded random grids at dims 20, 40 and 45 (jumper's easy, hard and
memory worlds) and must equal ``procgen_tpu.engine.levelgen.roomgen``
through ``jax.vmap`` on every cell.  The grids include rooms of tied size,
src/dst pairs with no path between them and src == dst.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu.engine.levelgen import roomgen as JR

from procgen_torch import objects as O
from procgen_torch.engine.levelgen import roomgen

torch.set_num_threads(1)

DIMS = [20, 40, 45]


def _grids(dim, n, seed, wall_p):
    """Random WALL/SPACE grids, each cell a wall with probability wall_p."""
    rs = np.random.RandomState(seed)
    return np.where(rs.rand(n, dim, dim) < wall_p, O.WALL_OBJ, O.SPACE).astype(np.int32)


def _tied_grids(dim):
    """Two separate rooms of equal size in each of several layouts: the room
    holding the smaller cell index must win."""
    out = []
    for w in (2, 3, 5):
        g = np.full((dim, dim), O.WALL_OBJ, np.int32)
        g[2:2 + w, 2:2 + w] = O.SPACE
        g[dim - 2 - w:dim - 2, dim - 2 - w:dim - 2] = O.SPACE
        out.append(g)
        g2 = np.full((dim, dim), O.WALL_OBJ, np.int32)  # same rows, left/right
        g2[5:5 + w, 1:1 + w] = O.SPACE
        g2[5:5 + w, dim - 1 - w:dim - 1] = O.SPACE
        out.append(g2)
    return np.stack(out)


def _component(g, start):
    """Flat cells of the 4-connected SPACE component holding ``start``."""
    dim = g.shape[0]
    seen, todo = {start}, [start]
    while todo:
        c = todo.pop()
        x, y = c % dim, c // dim
        for nx, ny in ((x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)):
            n = ny * dim + nx
            if 0 <= nx < dim and 0 <= ny < dim and n not in seen and g[ny, nx] == O.SPACE:
                seen.add(n)
                todo.append(n)
    return seen


def _check(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=what)


@pytest.mark.parametrize("dim", DIMS)
def test_ca_update_and_expand_match_reference(dim):
    g = _grids(dim, 12, dim, 0.45)
    d = jnp.full((12,), dim, jnp.int32)
    dt = torch.full((12,), dim, dtype=torch.int32)
    for oob in (True, False):
        want = jax.vmap(lambda x, y: JR.ca_update(x, y, oob))(jnp.asarray(g), d)
        got = roomgen.ca_update(torch.as_tensor(g), dt, oob)
        _check(want, got, f"ca_update oob_is_wall={oob}")
    mask = np.random.RandomState(dim + 1).rand(12, dim, dim) < 0.03
    for n in (1, 4):
        want = jax.vmap(lambda x, y, m: JR.expand_mask(x, y, m, n))(jnp.asarray(g), d, jnp.asarray(mask))
        got = roomgen.expand_mask(torch.as_tensor(g), dt, torch.as_tensor(mask), n)
        _check(want, got, f"expand_mask n={n}")


@pytest.mark.parametrize("dim", DIMS)
def test_best_room_mask_matches_reference(dim):
    g = np.concatenate([_grids(dim, 16, 100 + dim, p) for p in (0.35, 0.45, 0.55)])
    # caves: the CA rounds jumper runs before the search, then its borders
    d = jnp.full((g.shape[0],), dim, jnp.int32)
    for _ in range(2):
        g = np.array(jax.vmap(JR.ca_update)(jnp.asarray(g), d))
    g[:, 0, :] = g[:, -1, :] = g[:, :, 0] = g[:, :, -1] = 6
    g = np.concatenate([g, _tied_grids(dim)])
    d = jnp.full((g.shape[0],), dim, jnp.int32)
    want = jax.vmap(JR.best_room_mask)(jnp.asarray(g), d)
    got = roomgen.best_room_mask(torch.as_tensor(g), torch.full((g.shape[0],), dim, dtype=torch.int32))
    _check(want, got, "best_room_mask")
    assert np.asarray(want).any((1, 2)).mean() > 0.5  # not vacuous


@pytest.mark.parametrize("dim", DIMS)
def test_find_path_matches_reference(dim):
    G = dim * dim
    rs = np.random.RandomState(7 + dim)
    g = np.concatenate([_grids(dim, 20, 200 + dim, p) for p in (0.3, 0.45)])
    n = g.shape[0]
    d = jnp.full((n,), dim, jnp.int32)
    for _ in range(2):
        g = np.array(jax.vmap(JR.ca_update)(jnp.asarray(g), d))
    space = np.flatnonzero
    src = np.zeros(n, np.int32)
    dst = np.zeros(n, np.int32)
    for i in range(n):
        free = space(g[i].reshape(-1) == O.SPACE)
        if i % 10 == 3:  # src == dst
            src[i] = dst[i] = free[rs.randint(len(free))]
        elif i % 10 == 5:  # dst a wall cell: never reached
            src[i] = free[rs.randint(len(free))]
            dst[i] = space(g[i].reshape(-1) != O.SPACE)[0]
        elif i % 10 == 7:  # src a wall cell (the search starts there anyway)
            src[i] = space(g[i].reshape(-1) != O.SPACE)[rs.randint(10)]
            dst[i] = free[rs.randint(len(free))]
        elif i % 10 == 9:  # src and dst in rooms a wall column splits
            g[i][:, dim // 2] = O.WALL_OBJ
            free = space(g[i].reshape(-1) == O.SPACE)
            src[i] = free[rs.randint(len(free))]
            room = _component(g[i], int(src[i]))
            dst[i] = [c for c in free if c not in room][0]
        else:
            src[i], dst[i] = free[rs.randint(len(free), size=2)]
    want = jax.vmap(lambda x, y, s, t: JR.find_path_mask(x, y, s, t, G))(
        jnp.asarray(g), d, jnp.asarray(src), jnp.asarray(dst)
    )
    dt = torch.full((n,), dim, dtype=torch.int32)
    got = roomgen.find_path_mask(torch.as_tensor(g), dt, torch.as_tensor(src), torch.as_tensor(dst))
    _check(want, got, "find_path_mask")
    lengths = np.asarray(want).sum(1)
    assert (lengths[9::10] == 0).all() and (lengths[3::10] == 1).all(), lengths
    assert (lengths > 10).sum() > 5, lengths
    want_g = jax.vmap(lambda p, y: JR.flat_to_grid_mask(p, y, dim, dim))(want, d)
    _check(want_g, roomgen.flat_to_grid_mask(got, dt, dim, dim), "flat_to_grid_mask")
