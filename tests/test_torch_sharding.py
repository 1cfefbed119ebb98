"""procgen_torch/parallel/sharding.py and the sharded fast path on the CPU.

Ranks are spawned processes over gloo (``tests/torch_dist_children.py`` and
``procgen_torch.entry.run_sharded``), meeting through a file store.  The
JAX side runs in the test process, on four of the eight virtual CPU devices
that conftest.py gives JAX:

(a) ``rank_unique_seed`` and ``host_env_slice`` against the JAX functions;
(b) ``shard_env_state`` then ``make_global_env_state`` at W=4 return every
    leaf bit for bit (negative zeros and NaN payloads included);
(c) maze easy over W=4 ranks against the JAX package's fast path sharded
    over a 4-device mesh: 16 envs, refill bucket 4, three envs of rank 0
    two steps from their timeout and an env of rank 3 reset twice (so the
    global bucket takes rank 0's empty queue slots on rank 3's refill
    step), 6 random steps: the state at every step, rewards, dones and
    frames;
(d) dodgeball hard, miner easy and bigfish easy over W=4 ranks against the
    port's one-process run over the global batch (which the per-game test
    files hold against the JAX package): every field bit for bit.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from procgen_torch import entry
from procgen_torch.bench import synth_assets
from procgen_torch.parallel import sharding
from procgen_torch.render import assets

import torch_dist_children as children

torch.set_num_threads(1)

W = 4
# deaths: three envs of rank 0 time out at step 2 (their queue entries
# swapped in, the slots left empty); env 13 of rank 3 is reset at step 3
# (its entry swapped in) and again at step 4, when its slot is empty: the
# global bucket then refills it and rank 0's three empty slots, from rank
# 0's live states of step 4, while a bucket per rank would leave rank 0's
# slots empty
MAZE = dict(env_name="maze", mode="easy", num_envs=16, steps=6, refill_bucket=4, action_seed=3,
            deaths=((0, 2), (1, 2), (2, 2)), resets=((3, 13), (4, 13), (5, 6)))
OTHERS = [dict(env_name=g, mode=m, num_envs=8, steps=6, refill_bucket=1, action_seed=5,
               deaths=((0, 2), (1, 2)), resets=((3, 7), (4, 7), (4, 5))) for g, m in
          (("dodgeball", "hard"), ("miner", "easy"), ("bigfish", "easy"))]


@pytest.fixture(scope="module")
def asset_root(tmp_path_factory):
    """A synthetic PNG root for both packages (as test_torch_assets's
    fixture, whose module imports JAX at its top)."""
    from procgen_tpu.render import assets as j_assets

    def clear():
        j_assets.png_size.cache_clear()
        j_assets.decode_png.cache_clear()
        assets.clear_caches()

    root = synth_assets.write_root(tmp_path_factory.mktemp("assets"), seed=0)
    mp = pytest.MonkeyPatch()
    mp.setenv("PROCGEN_TPU_ASSET_ROOT", str(root))
    mp.setenv(assets.ROOT_ENV, str(root))
    clear()
    try:
        yield root
    finally:
        mp.undo()
        clear()


@pytest.fixture
def jax_x64_off():
    """The JAX package's fast mode runs without x64 (another test file
    turns it on when it is imported: tests/test_torch_dodgeball.py's
    fixture of the same name)."""
    import jax

    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.fixture(scope="module")
def sharded(asset_root):
    """The maze run and the three other games' runs over W=4 gloo ranks
    (one spawn for all four)."""
    return entry.run_sharded([MAZE, *OTHERS], W, "cpu")


# ---------------------------------------------------------------------------
# (a), (b)
# ---------------------------------------------------------------------------


def test_rank_seed_and_slice_match_jax(tmp_path, monkeypatch):
    import jax

    from procgen_tpu.parallel import sharding as jsh

    for pid in range(4):
        assert sharding.rank_unique_seed(2**31 - 40, pid) == jsh.rank_unique_seed(2**31 - 40, pid)
        assert sharding.rank_unique_seed(7, pid) == jsh.rank_unique_seed(7, pid)
    for n in (1, 8, 4096):
        assert sharding.host_env_slice(n) == jsh.host_env_slice(n) == (0, n)
    # the JAX function in a 4-process run, against the port's ranks
    sharding.spawn_ranks(children.roundtrip_rank, W, str(tmp_path), (str(tmp_path), "maze", 8))
    monkeypatch.setattr(jax, "process_count", lambda: W)
    for r in range(W):
        with open(tmp_path / f"roundtrip{r}.pkl", "rb") as f:
            rec = pickle.load(f)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        assert rec["slice"] == jsh.host_env_slice(8) == (2 * r, 2)
        assert rec["seed"] == jsh.rank_unique_seed(1234) == (1234 + 31 * r)
        if r == 0:
            leaves = rec["leaves"]
    assert len(leaves) > 100
    for glob, back, local_rows in leaves:
        assert local_rows * W == glob.shape[0]
        assert glob.dtype == back.dtype and glob.shape == back.shape
        np.testing.assert_array_equal(glob.view(np.uint8), back.view(np.uint8))
    # the last leaves are odd_floats' (neg_zero, nan, flag)
    neg_zero, nan, _ = (g for g, _, _ in leaves[-3:])
    assert np.signbit(neg_zero).all() and np.isnan(nan).all()


def test_make_env_mesh_without_a_group():
    mesh = sharding.make_env_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.sharded) == (0, 1, False)
    assert sharding.env_sharding(mesh, 12) == (0, 12)
    with pytest.raises(ValueError):
        sharding.make_env_mesh(4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharding.init_distributed("file:///nonexistent", 1, 0)


# ---------------------------------------------------------------------------
# (c) maze easy against the JAX package's mesh
# ---------------------------------------------------------------------------


def jax_sharded_maze(job: dict) -> dict:
    """The JAX package's fast path for ``job`` (run_steps's arguments),
    every leaf sharded over ``make_env_mesh(4)``: reset, the warm init, the
    staged timeouts, then one jit of step and frame per step."""
    import jax
    import jax.numpy as jnp

    from procgen_tpu import rng as JR
    from procgen_tpu.config import DistributionMode as JMode
    from procgen_tpu.config import EnvConfig as JConfig
    from procgen_tpu.engine.game import reset_env
    from procgen_tpu.games import make_game
    from procgen_tpu.parallel.fast import make_fast_fns
    from procgen_tpu.parallel.sharding import env_sharding, make_env_mesh, shard_env_state
    from procgen_tpu.render.fast2 import render_frames2
    from procgen_tpu.render.pack import RenderPack
    from procgen_tpu.render.renderer import update_view_params
    from procgen_tpu.state import init_state_template
    from test_torch_fast_path import jax_fields

    n = job["num_envs"]
    cfg = JConfig(env_name=job["env_name"], num_envs=n, distribution_mode=JMode[job["mode"]],
                  rand_seed=entry.SEED)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    tmpl = init_state_template(gd, cfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), tmpl)
    master = JR.HostMT(entry.SEED)
    seeds = jnp.asarray([master.randint_full() for _ in range(n)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    reset = jax.vmap(lambda s: update_view_params(gd, cfg, reset_env(gd, cfg, s)))
    fast_init, fast_step = make_fast_fns(gd, cfg, pack, refill_bucket=job["refill_bucket"])

    def start(batched):
        fs = fast_init(reset(batched))
        k = np.full((n,), -1, np.int32)
        for env, left in job["deaths"]:
            k[env] = left
        k = jnp.asarray(k)
        cur = jnp.where(k >= 0, fs.state.timeout - k, fs.state.cur_time)
        fs = fs._replace(state=fs.state.replace(cur_time=cur))
        return fs, render_frames2(gd, cfg, fs.state, pack)

    def step(fs, actions):
        fs = fast_step(fs, actions)
        return fs, render_frames2(gd, cfg, fs.state, pack)

    mesh = make_env_mesh(W)
    fs, frames = jax.jit(start)(batched)
    fs = shard_env_state(fs, mesh)
    step = jax.jit(step)
    out = dict(states=[jax_fields(fs)], frames=[np.asarray(frames)], reward=[], done=[])
    rs = np.random.RandomState(job["action_seed"])
    for t in range(1, job["steps"] + 1):
        acts = rs.randint(0, 15, size=n).astype(np.int32)
        acts[[env for step, env in job["resets"] if step == t]] = -1
        acts = jax.device_put(jnp.asarray(acts), env_sharding(mesh))
        fs, frames = step(fs, acts)
        assert len(fs.state.done.sharding.device_set) == W
        out["states"].append(jax_fields(fs))
        out["frames"].append(np.asarray(frames))
        out["reward"].append(np.asarray(fs.state.reward))
        out["done"].append(np.asarray(fs.state.done))
    return {k: v if k == "states" else np.stack(v) for k, v in out.items()}


def test_maze_sharded_matches_jax_mesh(sharded, jax_x64_off):
    from test_torch_fast_path import assert_fields_equal

    got = sharded["runs"][0]
    want = jax_sharded_maze(MAZE)
    # the deaths are uneven across ranks, and the refill of step 4 filled
    # rank 0's empty slots
    done = want["done"]
    assert done[1, :3].all() and done[2:4, 13].all() and not done[1, 12:].any()
    valid = np.stack([s["queue_valid"] for s in want["states"]])
    assert not valid[3, :3].any() and valid[4, :3].all()
    for k in ("reward", "done", "frames"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # fields bit for bit, the view fields by test_torch_fast_path's rule
    # (maze easy's view_dim is the XLA:CPU site of ROADMAP section C)
    assert len(got["states"]) == len(want["states"]) == MAZE["steps"] + 1
    for t, (a, b) in enumerate(zip(want["states"], got["states"])):
        assert_fields_equal(a, b, f"at step {t}")
    assert sharded["launches"] == [[0] * 4] * W  # CPU tensors never launch the kernel


# ---------------------------------------------------------------------------
# (d) three games against the port's one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(len(OTHERS)), ids=[j["env_name"] for j in OTHERS])
def test_sharded_equals_one_process(sharded, k):
    job = OTHERS[k]
    want = entry.run_steps(**job, device="cpu")
    assert want["done"].any(axis=1).sum() >= 2
    entry.assert_runs_equal(want, sharded["runs"][k + 1], f"{job['env_name']} W=4 vs one process")
