"""procgen_torch's coinrun against native/coinrun_oracle.cpp, procgen_tpu and
its own inline path.

* levelgen of six seeds per mode against the std::mt19937 C++ oracle: grid,
  themes, the entity list (x, y, vx bit for bit) and the next raw draws of
  the step stream.  No JAX is compiled;
* the step, hard mode, 4 envs: every level is generated by the port on the
  CPU and carried into the JAX package's EnvState, then both packages step
  it (step_env_no_reset, finish_step, update_view_params) and draw its
  frame.  Every state field and frame must agree after every step, with the
  view_dim rule of tests/test_torch_fast_path.py.  A finished env is reset
  by the port and carried over again, so many levels are stepped.  The
  right-biased seeded actions reach coins, die on saws, enemies and lava,
  stand on crates and leave enemy trails; each is counted;
* the port's fast path against its inline path (step_env with reset),
  forced resets at t = 40, 41 and 90.

The fields of coinrun's state that the oracle does not print (bg_pct_x,
background_index, the agent spawn) come from base_game_reset, whose output
the tests of the other ported games hold against the JAX package.

The step test pins the JAX package's mul+add roundings to the reference's
(``pin_jax_roundings`` of tests/test_torch_fast_path.py): on its fast path
XLA:CPU contracts coinrun's air-control update (coinrun.cpp:158) and the
sub-step's ``x + vx * pct`` at 5 and 6 sub-steps into FMAs.
"""

import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.engine import game as j_game
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.render import fast2 as j_fast2
from procgen_tpu.render import renderer as j_renderer
from procgen_tpu.render.pack import RenderPack as JPack
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import finish_step, reset_env, step_env, step_env_no_reset
from procgen_torch.games import coinrun as C
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render import compositor, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import init_state_template, seeded_template, tree_select
from test_torch_fast_path import assert_fields_equal, jax_fields, pin_jax_roundings

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 4
SEED = 31


@pytest.fixture(scope="session")
def coinrun_oracle():
    src = REPO / "native" / "coinrun_oracle.cpp"
    binary = REPO / "native" / "build" / "coinrun_oracle_torch"
    binary.parent.mkdir(exist_ok=True)
    if not binary.exists() or binary.stat().st_mtime < src.stat().st_mtime:
        tmp = binary.with_name(f"{binary.name}.{os.getpid()}")
        subprocess.run(["g++", "-O2", "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, binary)

    def run(seed: int, mode: int):
        out = subprocess.run(
            [str(binary), str(seed), str(mode)],
            check=True, capture_output=True, text=True,
        ).stdout.splitlines()
        _, _, agent_theme, wall_theme, n_ents = map(int, out[0].split()[1:])
        rows = [list(map(int, line.split())) for line in out[1:65]]
        ents = []
        for line in out[65:65 + n_ents]:
            t = line.split()[1:]
            ents.append((int(t[0]), int(t[1])) + tuple(float.fromhex(v) for v in t[2:5]))
        fp = list(map(int, out[65 + n_ents].split()[1:]))
        return {
            "agent_theme": agent_theme, "wall_theme": wall_theme,
            "grid": np.asarray(rows), "ents": ents, "fp": fp,
        }

    return run


def _bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_coinrun_levelgen_matches_oracle(coinrun_oracle, mode):
    cfg = EnvConfig(env_name="coinrun", num_envs=6, distribution_mode=DistributionMode[mode])
    gd = make_game(cfg)
    seeds = [6 + 43 * i for i in range(6)]
    state = gd.choose_world_dim(cfg, init_state_template(gd, cfg, len(seeds), device="cpu"))
    rs = R.mt_block_open(R.mt_seed(torch.tensor(seeds, dtype=torch.int32)), gd.reset_max_draws)
    state, rs = gd.game_reset(cfg, state, rs)
    assert not R.blk_overflowed(rs).any()
    mt = R.mt_block_close(rs)

    ents = state.ents
    for i, seed in enumerate(seeds):
        ref = coinrun_oracle(seed, int(mode == "hard"))
        np.testing.assert_array_equal(state.grid[i].numpy(), ref["grid"], err_msg=f"seed {seed}")
        assert int(ents.image_theme[i, 0]) == ref["agent_theme"], seed
        assert int(state.extra["wall_theme"][i]) == ref["wall_theme"], seed
        assert int(ents.alive[i].sum()) == len(ref["ents"]), seed
        for k, (t, theme, ex, ey, evx) in enumerate(ref["ents"]):
            assert int(ents.type[i, k]) == t, (seed, k)
            if t in (C.ENEMY, C.CRATE, O.PLAYER):  # the types that carry themes
                assert int(ents.image_theme[i, k]) == theme, (seed, k)
            got = [_bits(float(getattr(ents, f)[i, k])) for f in ("x", "y", "vx")]
            assert got == [_bits(ex), _bits(ey), _bits(evx)], (seed, k)
        one = R.MT(key=mt.key[i], pos=mt.pos[i])
        for want in ref["fp"]:
            one, x = R.mt_raw(one)
            assert int(x) == want, seed


def _cfgs(mode="hard"):
    kw = dict(env_name="coinrun", num_envs=N, rand_seed=SEED, use_generated_assets=True)
    return (
        JConfig(distribution_mode=JMode[mode], **kw),
        EnvConfig(distribution_mode=DistributionMode[mode], **kw),
    )


def _policy(rs):
    """Seeded actions biased to run right and jump (moves 5, 7, 8)."""
    biased = rs.choice([7, 8, 8, 5], size=N)
    return np.where(rs.rand(N) < 0.7, biased, rs.randint(0, 15, size=N)).astype(np.int32)


class JaxCarrier:
    """Carries port states into the JAX package's batched EnvState: the
    inverse of ``jax_fields``, unflattened by key path onto the template."""

    def __init__(self, gd, cfg):
        tmpl = j_template(gd, cfg)
        n = cfg.num_envs
        batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), tmpl)
        pairs, self.treedef = jax.tree_util.tree_flatten_with_path(batched)
        self.names = list(convert.fields_from_keypaths(pairs))
        self.dtypes = [leaf.dtype for _, leaf in pairs]

    def __call__(self, state):
        fields = convert.state_to_numpy(state)
        leaves = [jnp.asarray(fields[n], dtype=d) for n, d in zip(self.names, self.dtypes)]
        return jax.tree_util.tree_unflatten(self.treedef, leaves)


def _port_reset(gd, cfg, pack, state, which):
    """Reset the envs of ``which`` inline, view and static layer included."""
    fresh = update_view_params(gd, cfg, reset_env(gd, cfg, state))
    fresh = fresh.replace(static_layer=fast2.render_static2(gd, cfg, fresh, pack))
    return tree_select(which, fresh, state)


def flush_denormals(fields: dict, names) -> dict:
    """``fields`` with the float32 denormals of ``names`` replaced by zeros
    of their sign: XLA:CPU runs with flush-to-zero, the reference (and the
    port) keep denormals.  A game whose state decays into them compares
    those fields so (e.g. caveflyer's rotation speed, halved every step)."""
    out = dict(fields)
    for n in names:
        v = fields[n]
        out[n] = np.where(np.abs(v) < np.finfo(np.float32).tiny, np.copysign(np.float32(0), v), v)
    return out


def _frames_bitwise(want, got, where):
    np.testing.assert_array_equal(want, got, err_msg=f"frame diverged {where}")


def stepped_against_reference(j_cfg, cfg, policy, steps, prepare=None, ftz_fields=(),
                              frames_equal=None):
    """Step a port batch (``cfg.num_envs`` envs) and the JAX package's side
    by side from port-made levels carried into the JAX EnvState, seeded
    actions ``policy(rs)``.
    After each step every field and the frame must agree (the view_dim
    rule of tests/test_torch_fast_path.py; ``ftz_fields`` compared through
    ``flush_denormals``; frames bitwise unless ``frames_equal(want, got,
    where)`` states another rule); then the port's state is yielded.
    Finished envs get a new level from the port, carried over again;
    ``prepare(state, which)`` may edit the new levels of ``which`` first
    (both packages then step the edited level)."""
    frames_equal = frames_equal or _frames_bitwise
    j_gd, gd = j_make_game(j_cfg), make_game(cfg)
    j_pack, pack = JPack(j_gd, j_cfg), RenderPack(gd, cfg)
    carry = JaxCarrier(j_gd, j_cfg)
    prepare = prepare or (lambda state, which: state)

    @jax.jit
    def j_step(states, acts):
        s = jax.vmap(lambda s, a: j_game.step_env_no_reset(j_gd, j_cfg, s, a))(states, acts)
        s = jax.vmap(lambda s: j_game.finish_step(j_cfg, s))(s)
        s = jax.vmap(lambda s: j_renderer.update_view_params(j_gd, j_cfg, s))(s)
        return s, j_fast2.render_frames2(j_gd, j_cfg, s, j_pack)

    every = torch.ones(cfg.num_envs, dtype=torch.bool)
    state = seeded_template(gd, cfg, cfg.num_envs, device="cpu")
    state = prepare(_port_reset(gd, cfg, pack, state, every), every)
    j_state = carry(state)
    rs = np.random.RandomState(5)
    for t in range(steps):
        acts = policy(rs)
        j_state, j_frame = j_step(j_state, jnp.asarray(acts))
        state = step_env_no_reset(gd, cfg, state, torch.as_tensor(acts))
        state = update_view_params(gd, cfg, finish_step(cfg, state))
        assert_fields_equal(
            jax_fields(j_state), flush_denormals(convert.state_to_numpy(state), ftz_fields),
            f"at step {t}", centered=True,
        )
        frames_equal(np.asarray(j_frame), fast2.render_frames2(gd, cfg, state, pack).numpy(),
                     f"at step {t}")
        yield state
        if bool(state.done.any()):
            done = state.done
            state = prepare(_port_reset(gd, cfg, pack, state, done), done)
            j_state = carry(state)
    assert compositor.launches == 0  # CPU tensors never reach the kernel


def test_coinrun_step_matches_reference(monkeypatch):
    pin_jax_roundings(monkeypatch)
    counts = dict(levels=N, goals=0, deaths=0, on_crate=0, trails=0)
    for state in stepped_against_reference(*_cfgs(), _policy, 150):
        counts["goals"] += int((state.reward > 0).sum())
        counts["deaths"] += int((state.done & (state.reward == 0)).sum())
        counts["on_crate"] += int(state.extra["is_on_crate"].sum())
        counts["trails"] += int((state.ents.alive & (state.ents.type == O.TRAIL)).sum())
        counts["levels"] += int(state.done.sum())
    assert counts["goals"] > 0 and counts["deaths"] > 0, counts
    assert counts["on_crate"] > 0 and counts["trails"] > 0, counts
    assert counts["levels"] >= 2 * N, counts


# Fields a fast-path level carries from the step that generated it: a queue
# entry made for an env that was not yet dying holds that step's action
# bookkeeping, which the inline reset takes from the dying step.  The next
# step rewrites all of them from its action (last_move_action only on a
# move), and no coinrun rule reads them across a reset.
_ACTION_FIELDS = (
    "move_action", "special_action", "last_move_action", "action_vx", "action_vy",
    "action_vrot", "step_rand_int",
)


def check_fast_path_matches_inline(cfg, policy, carried=()):
    """The port's fast path (refill bucket 2) against its inline path
    (step_env with reset), forced resets at t = 40, 41 and 90: every field
    but the action bookkeeping (and ``carried``: other fields a queued level
    takes from the step that generated it, which the next step rewrites
    before reading), and every frame.  The cold-start state also survives a
    numpy round trip through convert.py, dtypes included."""
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=2)
    template = seeded_template(gd, cfg, N, device="cpu")
    fs = init.cold(template)
    inline = _port_reset(gd, cfg, pack, template, torch.ones(N, dtype=torch.bool))

    def fields(state):
        return {
            k: v for k, v in convert.state_to_numpy(state).items()
            if k not in _ACTION_FIELDS and k not in carried
        }

    assert_fields_equal(fields(inline), fields(fs.state), "at cold start")
    flat = convert.state_to_numpy(fs.state)
    back = convert.state_to_numpy(convert.state_from_numpy(flat, "cpu"))
    assert_fields_equal(flat, back, "after a numpy round trip")
    rs = np.random.RandomState(8)
    resets = 0
    for t in range(100):
        acts = np.full((N,), -1, np.int32) if t in (40, 41, 90) else policy(rs)
        fs = step(fs, torch.as_tensor(acts))
        stepped = step_env(gd, cfg, inline, torch.as_tensor(acts))
        stepped = update_view_params(gd, cfg, stepped)
        inline = stepped.replace(
            static_layer=torch.where(
                stepped.done[:, None, None, None],
                fast2.render_static2(gd, cfg, stepped, pack), stepped.static_layer,
            )
        )
        resets += int(inline.done.sum())
        assert_fields_equal(fields(inline), fields(fs.state), f"at step {t}")
        np.testing.assert_array_equal(
            fast2.render_frames2(gd, cfg, inline, pack).numpy(),
            fast2.render_frames2(gd, cfg, fs.state, pack).numpy(),
            err_msg=f"frame diverged at step {t}",
        )
    assert resets >= 3 * N  # the forced resets ran the queue swap
    return fs


def test_coinrun_fast_path_matches_inline():
    check_fast_path_matches_inline(_cfgs()[1], _policy)
