"""procgen_torch levelgen against procgen_tpu's, exactly.

``generate_maze`` + ``place_objects`` on 8 numpy-seeded streams at maze dims
3..25, then whole ``reset_env`` states for maze easy and hard (converted
with procgen_torch.convert): every field bit for bit.  Then the rand_util
helpers and ``generate_maze_no_dead_ends`` on batched masked draws: equal
results and equal stream consumption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine.game import reset_env as j_reset_env
from procgen_tpu.engine.levelgen import mazegen as j_mazegen
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.games import make_game
from procgen_torch.state import seeded_template

torch.set_num_threads(1)

MAX_DIM = 25


def _jax_maze(seeds, dims):
    def one(seed, md):
        rs = JR.mt_block_open(JR.mt_seed(seed), 512)
        res = j_mazegen.generate_maze(rs, md, MAX_DIM)
        rs, res = j_mazegen.place_objects(res.rng, res, 2, 1, md, MAX_DIM)
        return res, rs

    return jax.jit(jax.vmap(one))(jnp.asarray(seeds), jnp.asarray(dims))


def test_generate_maze_and_place_objects_match_reference():
    rs = np.random.RandomState(3)
    seeds = rs.randint(0, 2**31 - 1, size=8).astype(np.int32)
    dims = np.asarray([3, 5, 9, 13, 17, 21, 23, 25], np.int32)
    j_res, j_rs = _jax_maze(seeds, dims)

    blk = R.mt_block_open(R.mt_seed(torch.as_tensor(seeds)), 512)
    res = mazegen.generate_maze(blk, torch.as_tensor(dims), MAX_DIM)
    t_rs, res = mazegen.place_objects(res.rng, res, 2, 1, torch.as_tensor(dims), MAX_DIM)

    np.testing.assert_array_equal(np.asarray(j_res.grid), res.grid.numpy())
    np.testing.assert_array_equal(np.asarray(j_res.free_cells), res.free_cells.numpy())
    np.testing.assert_array_equal(np.asarray(j_res.num_free_cells), res.num_free_cells.numpy())
    np.testing.assert_array_equal(np.asarray(j_rs.cursor), t_rs.cursor.numpy())
    j_mt, t_mt = JR.mt_block_close(j_rs), R.mt_block_close(t_rs)
    np.testing.assert_array_equal(np.asarray(j_mt.key), t_mt.key.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(j_mt.pos), t_mt.pos.numpy())
    # every maze really was carved: the goal sits on a free cell
    assert ((res.grid == 2).sum((1, 2)) == 1).all()


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_reset_env_matches_reference(mode):
    n = 6
    jcfg = JConfig(
        env_name="maze", num_envs=n, distribution_mode=JMode[mode], rand_seed=17,
        use_generated_assets=True,
    )
    jgd = j_make_game(jcfg)
    tmpl = j_template(jgd, jcfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), tmpl)
    master = JR.HostMT(17)
    seeds = jnp.asarray([master.randint_full() for _ in range(n)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    j_states = jax.jit(jax.vmap(lambda s: j_reset_env(jgd, jcfg, s)))(batched)

    cfg = EnvConfig(
        env_name="maze", num_envs=n, distribution_mode=DistributionMode[mode],
        rand_seed=17, use_generated_assets=True,
    )
    gd = make_game(cfg)
    states = reset_env(gd, cfg, seeded_template(gd, cfg, n, device="cpu"))

    want = convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(j_states)[0])
    got = convert.state_to_numpy(states)
    assert sorted(want) == sorted(got)
    for k in sorted(want):
        a, b = want[k], got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    # round trip through the converter
    again = convert.state_to_numpy(convert.state_from_numpy(got, "cpu"))
    for k in got:
        np.testing.assert_array_equal(got[k], again[k], err_msg=k)


# ---------------------------------------------------------------------------
# rand_util and the no-dead-end maze (chaser's levelgen), batched masked draws
# ---------------------------------------------------------------------------

from procgen_tpu.engine import rand_util as j_ru  # noqa: E402

from procgen_torch.engine import rand_util as ru  # noqa: E402

B = 8


def _seeds(seed):
    return np.random.RandomState(seed).randint(0, 2**31 - 1, size=B).astype(np.int32)


def _assert_same_stream(j_rs, t_rs):
    """Both block cursors consumed the same draws."""
    np.testing.assert_array_equal(np.asarray(j_rs.cursor), t_rs.cursor.numpy())


def _blocks(seeds):
    j_open = jax.vmap(lambda s: JR.mt_block_open(JR.mt_seed(s), 512))
    return j_open(jnp.asarray(seeds)), R.mt_block_open(R.mt_seed(torch.as_tensor(seeds)), 512)


def test_rand_util_matches_reference():
    rs = np.random.RandomState(5)
    seeds = _seeds(9)
    n_dyn = rs.randint(0, 30, size=B).astype(np.int32)  # 0 exercises max(n, 1)
    k_dyn = rs.randint(0, 5, size=B).astype(np.int32)
    mask = rs.rand(B, 40) < 0.3
    mask[0] = False  # no element at all
    k_erase = rs.randint(0, 9, size=B).astype(np.int32)
    k_erase[1] = 40  # more than the row holds: the take-all path
    balls = rs.randint(0, 20, size=B).astype(np.int32)
    nth = rs.randint(0, 15, size=B).astype(np.int32)

    def j_all(blk, n, k, m, ke, x, i):
        blk, a = j_ru.simple_choose(blk, 50, 12)
        blk, b = j_ru.simple_choose_dyn(blk, n, k, 30, 5)
        blk, c, cnt = j_ru.choose_n_erase(blk, m, 8, ke)
        blk, d = j_ru.partition(blk, x, 6, 20)
        return blk, a, b, c, cnt, d, j_ru.choose_nth_masked(m, i)

    j_blk, t_blk = _blocks(seeds)
    j_blk, *j_out = jax.jit(jax.vmap(j_all))(
        j_blk, *(jnp.asarray(v) for v in (n_dyn, k_dyn, mask, k_erase, balls, nth))
    )
    t_blk, a = ru.simple_choose(t_blk, 50, 12)
    t_blk, b = ru.simple_choose_dyn(t_blk, torch.as_tensor(n_dyn), torch.as_tensor(k_dyn), 30, 5)
    t_blk, c, cnt = ru.choose_n_erase(t_blk, torch.as_tensor(mask), 8, torch.as_tensor(k_erase))
    t_blk, d = ru.partition(t_blk, torch.as_tensor(balls), 6, 20)
    e = ru.choose_nth_masked(torch.as_tensor(mask), torch.as_tensor(nth))

    ja, jb, jc, jcnt, jd, je = (np.asarray(v) for v in j_out)
    np.testing.assert_array_equal(ja, a.numpy())
    # simple_choose_dyn leaves entries past k unspecified: compare the first k
    kk = np.arange(5)[None, :] < k_dyn[:, None]
    np.testing.assert_array_equal(np.where(kk, jb, 0), np.where(kk, b.numpy(), 0))
    np.testing.assert_array_equal(jc, c.numpy())
    np.testing.assert_array_equal(jcnt, cnt.numpy())
    np.testing.assert_array_equal(jd, d.numpy())
    np.testing.assert_array_equal(je, e.numpy())
    _assert_same_stream(j_blk, t_blk)
    assert len(set(a[0].tolist())) == 12  # distinct picks


def test_generate_maze_no_dead_ends_matches_reference():
    seeds = _seeds(21)
    dims = np.asarray([5, 7, 9, 11, 13, 15, 17, 19], np.int32)
    max_dim = 19
    j_blk, t_blk = _blocks(seeds)
    j_blk, j_grid = jax.jit(jax.vmap(
        lambda b, d: j_mazegen.generate_maze_no_dead_ends(b, d, max_dim)
    ))(j_blk, jnp.asarray(dims))
    t_blk, grid = mazegen.generate_maze_no_dead_ends(t_blk, torch.as_tensor(dims), max_dim)
    np.testing.assert_array_equal(np.asarray(j_grid), grid.numpy())
    _assert_same_stream(j_blk, t_blk)

    # the neighbor and dilation helpers of the door variant
    j_nv = jax.vmap(j_mazegen._neighbor_vals)(j_grid)
    for want, got in zip(j_nv, mazegen._neighbor_vals(grid)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    vis = grid == 100
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(j_mazegen._dilate)(jnp.asarray(vis.numpy()))),
        mazegen._dilate(vis).numpy(),
    )
    # no dead end is left inside any maze
    l, u, d, r = mazegen._neighbor_vals(grid)
    n_space = sum((v == 100).to(torch.int32) for v in (l, u, d, r))
    assert not ((grid == 100) & (n_space == 1)).any()
