"""procgen_torch maze levelgen against procgen_tpu's, exactly.

``generate_maze`` + ``place_objects`` on 8 numpy-seeded streams at maze dims
3..25, then whole ``reset_env`` states for maze easy and hard (converted
with procgen_torch.convert): every field bit for bit.
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
