"""procgen_torch's heist against native/heist_oracle.cpp, procgen_tpu and its
own inline path, in PNG mode on a synthetic asset root (heist reads its
keys' and gem's aspect ratios from the PNG headers when it is built).

* ``mazegen.generate_maze_with_doors`` against the JAX package's on random
  seeds, maze dims 5-23 and 0-3 doors: grid and the rest of the stream;
* levelgen of six seeds per mode (easy, hard, memory) against the
  std::mt19937 C++ oracle (its rand01 already narrows to a float, as the
  reference's does): key count, world grid, the agent's position, every
  entity's type, theme, x and y bit for bit, the key ring, and the next raw
  draws of the step stream; and against the JAX package's ``game_reset``,
  every state field bitwise.  The oracle spawns keys and the exit with ``ry
  = rx`` (heist_oracle.cpp:223-237): the reference applies
  match_aspect_ratio after the spawn, so ``ry`` is held against the JAX
  package only;
* the step, hard mode, 4 envs, 250 steps, and easy and memory (a
  center-agent view) modes, 80 steps: every level is generated by the port
  on the CPU and carried into the JAX package's EnvState (a key and its
  door staged on the agent, a locked door of another colour and, in some
  levels, the gem beside it), then both packages step it and draw its frame;
  every state field and frame bitwise after every step, with
  ``pin_jax_roundings`` of tests/test_torch_fast_path.py (the agent's
  ``face_rotation`` is XLA's arctan2 on the JAX fast path) and
  ``pin_jax_render`` (XLA:CPU contracts the box of the agent's diagonal
  sprite, ``|c| * w + |s| * h``, into an FMA, and folds view_dim's
  division).  Keys taken, doors opened, agents held back by a locked door
  and levels completed are counted; each must occur in the hard run, keys
  and doors in the short ones;
* the port's fast path against its inline path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine.levelgen import mazegen as j_mazegen
from procgen_tpu.games import make_game as j_make_game

from procgen_torch import convert
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.games import heist as H
from procgen_torch.games import make_game
from test_torch_assets import asset_root_fixture
from test_torch_bigfish import jax_direct_reset, port_direct_reset, reset_fields
from test_torch_caveflyer import build_oracle, run_oracle
from test_torch_coinrun import check_fast_path_matches_inline, stepped_against_reference
from test_torch_fast_path import assert_fields_equal, jax_fields, pin_jax_render, pin_jax_roundings

torch.set_num_threads(1)

N = 4
SEED = 31
MODES = [("easy", 0), ("hard", 1), ("memory", 10)]

synth_root = asset_root_fixture()


def test_generate_maze_with_doors_matches_reference():
    max_dim = 23
    rs_np = np.random.RandomState(12)
    B = 12
    seeds = rs_np.randint(0, 2**31 - 1, size=B).astype(np.int32)
    dims = rs_np.choice([5, 7, 9, 13, 17, 23], size=B).astype(np.int32)
    doors = rs_np.randint(0, 4, size=B).astype(np.int32)

    def one(seed, md, nd):
        rs = JR.mt_block_open(JR.mt_seed(seed), 1024)
        rs, grid = j_mazegen.generate_maze_with_doors(rs, nd, md, max_dim)
        return grid, JR.mt_block_close(rs)

    j_grid, j_mt = jax.jit(jax.vmap(one))(jnp.asarray(seeds), jnp.asarray(dims), jnp.asarray(doors))
    rs = R.mt_block_open(R.mt_seed(torch.as_tensor(seeds)), 1024)
    rs, grid = mazegen.generate_maze_with_doors(
        rs, torch.as_tensor(doors), torch.as_tensor(dims).to(torch.int64), max_dim)
    assert not R.blk_overflowed(rs).any()
    np.testing.assert_array_equal(grid.numpy(), np.asarray(j_grid))
    mt = R.mt_block_close(rs)
    np.testing.assert_array_equal(mt.pos.numpy(), np.asarray(j_mt.pos))
    np.testing.assert_array_equal(mt.key.numpy(), np.asarray(j_mt.key))
    # keys were placed (at most one per door requested: a small maze may
    # have fewer forks) and one exit per maze
    g = grid.numpy()
    keys = (g >= O.KEY_OBJ).sum((1, 2))
    assert (keys <= doors).all() and keys.sum() > B and (g == O.EXIT_OBJ).sum() == B


@pytest.fixture(scope="module")
def heist_oracle():
    binary = build_oracle("heist", float_rand01=False)

    def run(seed: int, mode: int):
        world_dim = {0: 9, 1: 13, 10: 23}[mode]
        out = run_oracle(binary, seed, mode)
        num_keys, maze_dim, off_x, off_y = map(int, out[0].split()[1:])
        ax, ay = (float.fromhex(t) for t in out[1].split()[1:])
        rows = [list(map(int, line.split())) for line in out[2:2 + world_dim]]
        n_ents = int(out[2 + world_dim].split()[1])
        ents = []
        for line in out[3 + world_dim:3 + world_dim + n_ents]:
            t = line.split()[1:]
            ents.append((int(t[0]), int(t[1]), float.fromhex(t[2]), float.fromhex(t[3])))
        fp = list(map(int, out[3 + world_dim + n_ents].split()[1:]))
        return dict(num_keys=num_keys, agent=(ax, ay), grid=np.asarray(rows), ents=ents, fp=fp)

    return run


def _bits(v) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("mode,mode_i", MODES)
def test_heist_levelgen_matches_oracle(synth_root, heist_oracle, monkeypatch, mode, mode_i):
    pin_jax_roundings(monkeypatch)  # the random agent spawn's mul+add
    seeds = [3 + 23 * i for i in range(6)]
    cfg = EnvConfig(env_name="heist", num_envs=len(seeds), distribution_mode=DistributionMode[mode])
    state = port_direct_reset(make_game(cfg), cfg, seeds)
    ents = state.ents
    doors = 0
    for i, seed in enumerate(seeds):
        ref = heist_oracle(seed, mode_i)
        nk = ref["num_keys"]
        assert int(state.extra["num_keys"][i]) == nk, seed
        np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=f"seed {seed}")
        assert (_bits(ents.x[i, 0]), _bits(ents.y[i, 0])) == tuple(map(_bits, ref["agent"])), seed
        for k, (t, theme, ex, ey) in enumerate(ref["ents"]):
            slot = k + 1  # slot 0 is the agent, then the oracle's order
            assert int(ents.type[i, slot]) == t, (seed, k)
            assert int(ents.image_theme[i, slot]) == theme, (seed, k)
            assert [_bits(ents.x[i, slot]), _bits(ents.y[i, slot])] == [_bits(ex), _bits(ey)], (seed, k)
            doors += t == H.LOCKED_DOOR
        for r in range(nk):  # the key ring
            slot = 1 + len(ref["ents"]) + r
            assert int(ents.type[i, slot]) == H.KEY_ON_RING and int(ents.image_theme[i, slot]) == r
        assert int(ents.alive[i].sum()) == 1 + len(ref["ents"]) + nk, seed
        one = R.MT(key=state.rng.key[i], pos=state.rng.pos[i])
        for want in ref["fp"]:
            one, x = R.mt_raw(one)
            assert int(x) == want, seed
    assert doors > 0 or mode == "easy"

    j_cfg = JConfig(env_name="heist", num_envs=len(seeds), distribution_mode=JMode[mode])
    j_state, overflowed = jax_direct_reset(j_make_game(j_cfg), j_cfg, seeds)
    assert not np.asarray(overflowed).any()
    assert_fields_equal(reset_fields(jax_fields(j_state)),
                        reset_fields(convert.state_to_numpy(state)), f"heist {mode} reset")


def _cfgs(mode="hard"):
    kw = dict(env_name="heist", num_envs=N, rand_seed=SEED)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    return rs.randint(0, 9, size=N).astype(np.int32)


def _stage(state, which):
    """On the agent: a blue key and a blue door (the door, at the higher
    slot, is met first in the reverse sweep and opens a step later); beside
    it a red locked door, which holds the agent back; and, in levels of
    odd seed, the gem a cell away."""
    ents = state.ents
    a = eo.AGENT
    ax, ay = ents.x[:, a], ents.y[:, a]

    def add(ents, x, y, r, type_, theme, on):
        f = eo.make_entity(x, y, 0.0, 0.0, r, r, type_)
        f.update(image_type=type_, image_theme=theme)
        return eo.append_entity(ents, f, active=on)[0]

    ents = add(ents, ax, ay, 0.375, H.KEY, 0, which)
    ents = add(ents, ax, ay, 0.5, H.LOCKED_DOOR, 0, which)
    right = torch.floor(ax) + 1.5
    ents = add(ents, right, ay, 0.5, H.LOCKED_DOOR, 2, which)
    gem = which & (state.current_level_seed % 2 == 1)
    ents = add(ents, ax, ay + 1.0, 0.375, H.EXIT, 0, gem)
    return state.replace(ents=ents)


@pytest.mark.parametrize("mode,steps", [("hard", 250), ("easy", 80), ("memory", 80)])
def test_heist_step_matches_reference(synth_root, monkeypatch, mode, steps):
    pin_jax_roundings(monkeypatch)
    pin_jax_render(monkeypatch)
    counts = dict(keys=0, doors_opened=0, held_back=0, completed=0)
    prev = None
    for state in stepped_against_reference(*_cfgs(mode), _policy, steps, prepare=_stage):
        ents = state.ents
        counts["completed"] += int(state.level_complete.sum())
        held = prev.extra["has_keys"] if prev is not None else torch.zeros_like(state.extra["has_keys"])
        counts["keys"] += int((state.extra["has_keys"] & ~held).sum())
        if prev is not None:
            p = prev.ents
            door = p.alive & (p.type == H.LOCKED_DOOR)
            counts["doors_opened"] += int((door.sum(1) > (ents.alive & (ents.type == H.LOCKED_DOOR)).sum(1)).sum())
            # a push against a locked red door zeroes the agent's velocity
            red = door & (p.image_theme == 2) & ~held[:, 2:3]
            near = (torch.abs(p.x - ents.x[:, :1]) < 1.0) & (torch.abs(p.y - ents.y[:, :1]) < 0.9)
            counts["held_back"] += int(((red & near).any(1) & (ents.vx[:, 0] == 0)
                                        & (state.action_vx != 0) & ~state.done).sum())
        prev = state
    # every event in the long run; keys and doors in the short ones
    for k in counts if mode == "hard" else ("keys", "doors_opened"):
        assert counts[k] > 0, counts


def test_heist_fast_path_matches_inline(synth_root):
    check_fast_path_matches_inline(_cfgs()[1], _policy)
