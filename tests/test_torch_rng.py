"""procgen_torch.rng against libstdc++ std::mt19937 and procgen_tpu.rng.

Exact: raw words, derived values and generator states are compared bit for
bit.  Inputs (seeds, masks, ranges) come from seeded numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_torch import rng as R

torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 23, 12345, 2**31 - 1, -7])
def test_streams_match_cpp(mt_oracle, seed):
    n = 700  # crosses the first twist boundary
    ref = mt_oracle(seed=seed, n=n)
    mt = R.mt_seed(torch.tensor([seed, seed, seed, seed], dtype=torch.int32))
    mt_raw = mt_int = mt_f = mt_full = mt
    raw, ints, f01, full = [], [], [], []
    for _ in range(n):
        mt_raw, x = R.mt_raw(mt_raw)
        mt_int, vi = R.mt_randint(mt_int, 3, 17)
        mt_f, vf = R.mt_rand01(mt_f)
        mt_full, vr = R.mt_randint_full(mt_full)
        raw.append(int(x[0]))
        ints.append(int(vi[1]))
        f01.append(int(vf[2:3].numpy().view(np.uint32)[0]))
        full.append(int(vr[3]))
    assert raw == ref["raw"]
    assert ints == ref["randint"]
    assert f01 == ref["rand01"]
    assert full == ref["randfull"]
    h = R.HostMT(seed)
    assert [h.raw() for _ in range(n)] == ref["raw"]


_DRAWS = ("raw", "randint", "randn", "rand01", "randbool", "randrange", "full")


def _draw(mod, kind, mt, active, lo, hi):
    if kind == "raw":
        return mod.mt_raw(mt, active)
    if kind == "randint":
        return mod.mt_randint(mt, lo, hi, active)
    if kind == "randn":
        return mod.mt_randn(mt, hi, active)
    if kind == "rand01":
        return mod.mt_rand01(mt, active)
    if kind == "randbool":
        return mod.mt_randbool(mt, active)
    if kind == "randrange":
        return mod.mt_randrange(mt, lo * 0.5, hi * 1.25, active)
    return mod.mt_randint_full(mt, active)


def test_masked_batched_draws_match_reference():
    """16 streams, 700 masked draws of mixed kinds with per-env ranges: the
    values and the whole generator state equal procgen_tpu.rng's."""
    rs = np.random.RandomState(5)
    B = 16
    seeds = rs.randint(-(2**31), 2**31 - 1, size=B).astype(np.int32)
    j_mt = JR.mt_seed(jnp.asarray(seeds))
    t_mt = R.mt_seed(torch.as_tensor(seeds))
    j_fns = {
        k: jax.jit(lambda mt, a, lo, hi, k=k: _draw(JR, k, mt, a, lo, hi))
        for k in _DRAWS
    }
    for step in range(700):
        kind = _DRAWS[rs.randint(len(_DRAWS))]
        active = rs.rand(B) < 0.9
        lo = rs.randint(-50, 50, size=B).astype(np.int32)
        hi = (lo + rs.randint(1, 1000, size=B)).astype(np.int32)
        if kind == "randn":
            lo = np.zeros_like(lo)
        j_mt, jv = j_fns[kind](j_mt, jnp.asarray(active), jnp.asarray(lo), jnp.asarray(hi))
        t_mt, tv = _draw(R, kind, t_mt, torch.as_tensor(active), torch.as_tensor(lo), torch.as_tensor(hi))
        jv = np.asarray(jv)
        tv = tv.numpy()
        if kind == "raw":
            tv = tv.astype(np.uint32)
        if jv.dtype == np.float32:
            jv, tv = jv.view(np.int32), tv.view(np.int32)
        np.testing.assert_array_equal(jv[active], tv[active], err_msg=f"{kind} at {step}")
        np.testing.assert_array_equal(np.asarray(j_mt.key), _u32(t_mt.key), err_msg=f"key at {step}")
        np.testing.assert_array_equal(np.asarray(j_mt.pos), t_mt.pos.numpy(), err_msg=f"pos at {step}")


@pytest.mark.parametrize("warm,n_draws", [(0, 5), (0, 700), (100, 624), (620, 10), (623, 1)])
def test_block_matches_reference(warm, n_draws):
    """Block open, masked scalar and vector draws, close: equal to
    procgen_tpu.rng's block API and to the per-draw stream."""
    rs = np.random.RandomState(warm + n_draws)
    B = 6
    seeds = rs.randint(0, 2**31 - 1, size=B).astype(np.int32)
    j_mt, t_mt = JR.mt_seed(jnp.asarray(seeds)), R.mt_seed(torch.as_tensor(seeds))
    j_raw = jax.jit(JR.mt_raw)
    for _ in range(warm):
        j_mt, _x = j_raw(j_mt)
        t_mt, _x = R.mt_raw(t_mt)
    j_blk = JR.mt_block_open(j_mt, n_draws)
    t_blk = R.mt_block_open(t_mt, n_draws)
    np.testing.assert_array_equal(np.asarray(j_blk.vals), _u32(t_blk.vals))
    np.testing.assert_array_equal(np.asarray(j_blk.keys), _u32(t_blk.keys))
    j_draw = jax.jit(JR.blk_raw)
    j_vec = jax.jit(jax.vmap(lambda b: JR.blk_raw_vec(b, 3)))  # per env
    used = 0
    while used < n_draws:
        if rs.rand() < 0.2 and n_draws - used >= 3:
            j_blk, jv = j_vec(j_blk)
            if rs.rand() < 0.5:
                t_blk, tv = R.blk_raw_vec(t_blk, 3)
                np.testing.assert_array_equal(np.asarray(jv), _u32(tv))
            else:
                t_blk, tf = R.rs_rand01_vec(t_blk, 3)
                want = np.asarray(jv).astype(np.float32) * np.float32(2.0**-32)
                np.testing.assert_array_equal(want.view(np.int32), tf.numpy().view(np.int32))
            used += 3
            continue
        active = rs.rand(B) < 0.7
        j_blk, jv = j_draw(j_blk, jnp.asarray(active))
        t_blk, tv = R.blk_raw(t_blk, torch.as_tensor(active))
        used += 1
        np.testing.assert_array_equal(np.asarray(jv), _u32(tv))
        np.testing.assert_array_equal(np.asarray(j_blk.cursor), t_blk.cursor.numpy())
    assert not bool(R.blk_overflowed(t_blk).any())
    j_end, t_end = JR.mt_block_close(j_blk), R.mt_block_close(t_blk)
    np.testing.assert_array_equal(np.asarray(j_end.key), _u32(t_end.key))
    np.testing.assert_array_equal(np.asarray(j_end.pos), t_end.pos.numpy())
    # the closed state continues the stream of per-draw mt_raw
    cur = t_blk.cursor.numpy()
    for i in range(B):
        one = R.MT(key=t_mt.key[i : i + 1], pos=t_mt.pos[i : i + 1])
        for _ in range(int(cur[i])):
            one, _x = R.mt_raw(one)
        _, want = R.mt_raw(one)
        _, got = R.mt_raw(R.MT(key=t_end.key[i : i + 1], pos=t_end.pos[i : i + 1]))
        assert int(want[0]) == int(got[0])


def test_select_and_host_generator():
    a = R.mt_seed(torch.tensor([1, 2, 3], dtype=torch.int32))
    b = R.mt_seed(torch.tensor([4, 5, 6], dtype=torch.int32))
    s = R.mt_select(torch.tensor([True, False, True]), a, b)
    np.testing.assert_array_equal(s.key[1].numpy(), b.key[1].numpy())
    np.testing.assert_array_equal(s.key[2].numpy(), a.key[2].numpy())
    jh, th = JR.HostMT(77), R.HostMT(77)
    for _ in range(700):
        assert jh.randint(-5, 900) == th.randint(-5, 900)
        assert jh.randint_full() == th.randint_full()
        assert jh.rand01() == th.rand01()
        assert jh.randrange(1.5, 9.25) == th.randrange(1.5, 9.25)
