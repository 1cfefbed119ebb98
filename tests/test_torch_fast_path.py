"""procgen_torch's maze fast path against procgen_tpu's, step by step.

Maze easy and hard, 4 envs, 250 steps, refill bucket 2, forced resets
(action -1) at t = 40, 41 and 90 (the pattern of tests/test_fast_path.py).
After the cold start and after every step the whole FastState (live state,
queue and queue_valid) must be equal field for field, floats compared bit
for bit, and the rendered uint8 frames must be identical.  Also: importing
the port loads neither JAX nor procgen_tpu.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu import fmath as j_fmath
from procgen_tpu import rng as JR
from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.parallel.fast import make_fast_fns as j_make_fast_fns
from procgen_tpu.render import fast2 as j_fast2
from procgen_tpu.render.pack import RenderPack as JPack
from procgen_tpu.state import init_state_template as j_template

from procgen_torch import convert
from procgen_torch import fmath as p_fmath
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render import compositor, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 4
SEED = 31


def jax_fields(tree) -> dict:
    return convert.fields_from_keypaths(jax.tree_util.tree_flatten_with_path(tree)[0])


def pin_jax_roundings(monkeypatch):
    """Route procgen_tpu's fadd32 and fmuladd32 through their parity-mode
    form for one test.  On the JAX fast path both are plain mul/add, and
    XLA:CPU contracts the products into FMAs (1 ulp off the reference, which
    rounds each product: coinrun's air control, coinrun.cpp:158; the
    sub-step's x + vx * pct when pct is inexact; the random agent spawn,
    bag.cpp:781-782).  Parity mode routes them through a host callback that
    rounds as the reference does, which is what the port computes.  dcos
    and dsin (the double cos/sin of a float, narrowed) go through glibc in
    a host callback too: on the fast path they are XLA's float cos and sin.
    So does face_rotation (glibc's atan2f, negated, plus a float offset): on
    the fast path it is XLA's arctan2, and XLA folds the ``+ 0.0`` that
    turns the reference's -0.0 into +0.0."""

    def fadd32(cfg, a, b):
        a, b = jnp.broadcast_arrays(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
        return j_fmath._callback(j_fmath._np_fadd, a, a, b)

    def fmuladd32(cfg, r, scale, off):
        r, scale, off = jnp.broadcast_arrays(
            *(jnp.asarray(v, jnp.float32) for v in (r, scale, off))
        )
        return j_fmath._callback(j_fmath._np_fmuladd, r, r, scale, off)

    def double_trig(host):
        # C++ cos(float) of the double overload, narrowed at the float store
        # (ninja's star velocity): XLA's float cos need not give those bits
        def trig(cfg, x):
            x = jnp.asarray(x, jnp.float32)
            return j_fmath._callback(host, x, x)

        return trig

    def face_rotation(cfg, dx, dy, offset=0.0):
        dy, dx = jnp.broadcast_arrays(jnp.asarray(dy, jnp.float32), jnp.asarray(dx, jnp.float32))

        def host(y, x):
            return -p_fmath.atan2f_libm(y, x) + np.float32(offset)

        return j_fmath._callback(host, dy, dy, dx)

    monkeypatch.setattr(j_fmath, "fadd32", fadd32)
    monkeypatch.setattr(j_fmath, "fmuladd32", fmuladd32)
    monkeypatch.setattr(j_fmath, "dcos", double_trig(p_fmath.dcos_libm))
    monkeypatch.setattr(j_fmath, "dsin", double_trig(p_fmath.dsin_libm))
    monkeypatch.setattr(j_fmath, "face_rotation", face_rotation)



def _f32_add(a, b):
    """``a + b`` of two float32 operands in one IEEE rounding on the host:
    an XLA:CPU fusion cannot contract a product feeding it into an FMA."""
    a, b = jnp.broadcast_arrays(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    return j_fmath._callback(j_fmath._np_fadd, a, a, b)


# The mul+add chains of procgen_tpu/render/fast2.py that XLA:CPU contracts
# into FMAs: where the view's unit is not a power of two (a center-agent
# view at visibility 20 or 10: climber's hard mode, caveflyer's easy mode),
# the entity rect's corner (get_object_rect) and the background rect's top
# and left edges; and the box of a rotated sprite off the axis bins
# (heist's diagonal moves).  Each (source line, pinned line) pair is exact
# text.
_RENDER_SITES = {
    "entity_records": (
        ("(ents.x - ents.rx) * unit - x_off,",
         "_f32_add((ents.x - ents.rx) * unit, -x_off),"),
        ("(view_dim - (ents.y + ents.ry)) * unit + y_off,",
         "_f32_add((view_dim - (ents.y + ents.ry)) * unit, y_off),"),
        ("bbw = jnp.abs(c) * r_w + jnp.abs(s) * r_h",
         "bbw = _f32_add(jnp.abs(c) * r_w, jnp.abs(s) * r_h)"),
        ("bbh = jnp.abs(s) * r_w + jnp.abs(c) * r_h",
         "bbh = _f32_add(jnp.abs(s) * r_w, jnp.abs(c) * r_h)"),
    ),
    "bg_pass": (
        ("m_y0 = (view_dim - mh) * unit + y_off",
         "m_y0 = _f32_add((view_dim - mh) * unit, y_off)"),
        ("bx0 = m_x0 + m_w * (-offset_x)",
         "bx0 = _f32_add(m_x0, m_w * (-offset_x))"),
    ),
}


def _f32_div(cfg, a, b):
    a, b = jnp.broadcast_arrays(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    return j_fmath._callback(lambda x, y: np.asarray(x, np.float32) / np.asarray(y, np.float32),
                             a, a, b)


def pin_jax_render(monkeypatch):
    """Route the mul+add chains of ``_RENDER_SITES`` in the JAX package's
    renderer through one host rounding each, as the reference (and the
    port) round them: the functions are recompiled from their source with
    those lines rewritten, for one test.  A site whose text is not found
    fails the test.  ``fdiv`` becomes one IEEE division on the host too:
    XLA folds update_view_params' ``64 / (64 / visibility)`` into
    ``visibility`` (the view_dim rule above), and at visibility 13 (heist's
    hard mode) the offsets that view_dim gives move a sprite's edge across
    a pixel centre."""
    import inspect
    import textwrap

    monkeypatch.setattr(j_fmath, "fdiv", _f32_div)

    for name, sites in _RENDER_SITES.items():
        src = textwrap.dedent(inspect.getsource(getattr(j_fast2, name)))
        for old, new in sites:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        scope = dict(vars(j_fast2), _f32_add=_f32_add)
        exec(compile(src, f"<pinned {name}>", "exec"), scope)
        monkeypatch.setattr(j_fast2, name, scope[name])


# One known XLA:CPU site.  update_view_params computes view_dim = 64 /
# (64 / visibility) (procgen_tpu/render/renderer.py:56-60); in fast mode
# XLA's algebraic simplifier folds a / (b / c) into a * c / b, which gives
# exactly 15.0 at maze easy, while the reference's double division narrowed
# to float (bag.cpp:834) gives 14.999999 -- the port's value.  view_dim is
# held at 1 ulp, and x_off / y_off = unit * (c - view_dim / 2) at the
# difference that ulp makes, unit * spacing(view_dim).
_VIEW_FIELDS = ("view_dim", "x_off", "y_off")


def _check_view_fields(want: dict, got: dict, prefix: str, where: str, centered=False):
    unit = got[prefix + "unit"]
    view_dim = got[prefix + "view_dim"]
    # the port's view_dim is the reference's float(64.0 / double(unit))
    np.testing.assert_array_equal(
        view_dim, (64.0 / unit.astype(np.float64)).astype(np.float32), err_msg=where
    )
    ulps = np.abs(
        want[prefix + "view_dim"].view(np.int32).astype(np.int64)
        - view_dim.view(np.int32).astype(np.int64)
    )
    assert ulps.max() <= 1, f"{prefix}view_dim {ulps.max()} ulp {where}"
    if centered:
        # a center-agent view centres on the agent, so c - view_dim / 2
        # rounds at the agent's magnitude: each package's offsets must be
        # exactly unit * (c - view_dim / 2) of its own view_dim, c and unit
        # (the centres and units are compared bit for bit)
        for f, c in (("x_off", "center_x"), ("y_off", "center_y")):
            for d in (want, got):
                half = d[prefix + "view_dim"] / np.float32(2)
                np.testing.assert_array_equal(
                    d[prefix + f], d[prefix + "unit"] * (d[prefix + c] - half),
                    err_msg=f"{prefix}{f} {where}",
                )
        return
    bound = unit * np.spacing(view_dim)
    for f in ("x_off", "y_off"):
        d = np.abs(want[prefix + f] - got[prefix + f])
        assert (d <= bound).all(), f"{prefix}{f} off by {d.max()} {where}"


def assert_fields_equal(want: dict, got: dict, where: str, centered=False):
    """Every field equal, floats bit for bit, except the view fields, held
    to the view_dim rule above (``centered`` for center-agent views)."""
    assert sorted(want) == sorted(got), where
    for prefix in {k[: -len("view_dim")] for k in want if k.endswith("view_dim")}:
        _check_view_fields(want, got, prefix, where, centered)
    for k in sorted(want):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, f"{k} {where}"
        if k.rsplit(".", 1)[-1] in _VIEW_FIELDS:
            continue
        if a.dtype == np.float32:  # bitwise, signed zeros included
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{k} diverged {where}")


def jax_fast_path(mode):
    cfg = JConfig(
        env_name="maze", num_envs=N, distribution_mode=mode, rand_seed=SEED,
        use_generated_assets=True,
    )
    gd = j_make_game(cfg)
    pack = JPack(gd, cfg)
    tmpl = j_template(gd, cfg)
    batched = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), tmpl)
    master = JR.HostMT(SEED)
    seeds = jnp.asarray([master.randint_full() for _ in range(N)], jnp.int32)
    batched = batched.replace(level_seed_rng=JR.mt_seed(seeds))
    init, step = j_make_fast_fns(gd, cfg, pack, refill_bucket=2)
    render = jax.jit(lambda s: j_fast2.render_frames2(gd, cfg, s, pack))
    return jax.jit(init.cold)(batched), jax.jit(step), render


@pytest.mark.parametrize("mode", ["easy", "hard"])
def test_fast_path_matches_reference(mode):
    j_fs, j_step, j_render = jax_fast_path(JMode[mode])

    cfg = EnvConfig(
        env_name="maze", num_envs=N, distribution_mode=DistributionMode[mode],
        rand_seed=SEED, use_generated_assets=True,
    )
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=2)
    fs = init.cold(seeded_template(gd, cfg, N, device="cpu"))
    assert_fields_equal(jax_fields(j_fs), convert.fast_state_to_numpy(fs), "at cold start")

    rng = np.random.RandomState(7)
    resets = 0
    for t in range(250):
        if t in (40, 41, 90):
            acts = np.full((N,), -1, np.int32)
        else:
            acts = rng.randint(0, 15, size=N).astype(np.int32)
        j_fs = j_step(j_fs, jnp.asarray(acts))
        fs = step(fs, torch.as_tensor(acts))
        resets += int(np.asarray(j_fs.state.done).sum())
        assert_fields_equal(
            jax_fields(j_fs), convert.fast_state_to_numpy(fs), f"at step {t}"
        )
        np.testing.assert_array_equal(
            np.asarray(j_render(j_fs.state)),
            fast2.render_frames2(gd, cfg, fs.state, pack).numpy(),
            err_msg=f"frame diverged at step {t}",
        )
    assert resets >= 3 * N  # the forced resets ran the queue path
    assert compositor.launches == 0  # CPU tensors never reach the kernel


def test_port_imports_no_jax():
    """procgen_torch (all modules: the env surface and every game included)
    and chip_smoke.py load neither jax nor procgen_tpu."""
    code = r"""
import importlib, pkgutil, sys
import procgen_torch.env, procgen_torch.games.miner, procgen_torch.games.chaser
import procgen_torch.games.coinrun, procgen_torch.games.leaper
import procgen_torch.games.ninja, procgen_torch.games.jumper
import procgen_torch.games.caveflyer, procgen_torch.games.dodgeball
import procgen_torch.games.bigfish, procgen_torch.games.climber, procgen_torch.games.heist
import procgen_torch.games.fruitbot, procgen_torch.games.plunder
import procgen_torch.games.starpilot, procgen_torch.games.bossfight
import procgen_torch.engine.rand_util, procgen_torch.engine.levelgen.roomgen
import procgen_torch.render.assets, procgen_torch.bench.synth_assets
import procgen_torch.utils.cppsort
from procgen_torch.games import available_games
assert available_games() == [
    "bigfish", "bossfight", "caveflyer", "chaser", "climber", "coinrun", "dodgeball",
    "fruitbot", "heist", "jumper", "leaper", "maze", "miner", "ninja", "plunder",
    "starpilot"], available_games()
import procgen_torch
for m in pkgutil.walk_packages(procgen_torch.__path__, "procgen_torch."):
    importlib.import_module(m.name)
src = open("chip_smoke.py").read()
compile(src, "chip_smoke.py", "exec")
ns = {"__name__": "chip_smoke_import_check"}
exec(compile(src, "chip_smoke.py", "exec"), ns)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "procgen_tpu"))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("procgen_torch")]))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
