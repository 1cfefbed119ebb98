"""The port's sprite compositor (plain version) against the JAX package's.

Synthetic records from ``compositor.synthetic_case`` at N=8, E=20 (the
inputs of chip_smoke.py's kernel check, smaller), every z_filter:

* texel alpha in {0, 255} and entity alpha 1: the plain version equals
  ``fast2.composite_entities`` and ``composite_entities_pallas`` (Pallas in
  interpret mode) bit for bit;
* fractional alphas: within tolerance.  The JAX CPU path is not IEEE
  there: XLA:CPU turns ``alpha / 255.0`` into a multiply by the reciprocal
  (1 ulp off for about half of the integer numerators) and contracts the
  blend ``s + c * (1 - a)`` into an FMA; the port rounds every op
  separately, as the reference build (no FMA) does.  Those alone move a
  canvas value by a few f32 ulps (measured: <= 1.6e-5 on about 1% of the
  values).  Rarely the 1-ulp premultiplied texel sits on a bf16 rounding
  boundary and the bf16 value moves one step, which for a texel below 256
  is at most 1.0 (measured: <= 0.25, 1 to 3 values in 98,304).  So: every
  value within 1.0, all but 1e-4 of them within 1e-3, uint8 frames within
  1 (measured: equal);
* a CPU tensor runs the plain version and launches no kernel.

The kernel draws each record only over a conservative pixel span of its box
(``compositor.pixel_span`` mirrors the kernel's formula), and skips the
pixels outside, which is exact only while the canvas holds no -0.0.  Two
tests hold those premises here: every pixel that the plain version draws
lies inside the span, on seeded and adversarial boxes; and the canvases
that the main path of each ported game hands the compositor are all >= +0.

The kernel itself needs the card; chip_smoke.py holds it bitwise against
this plain version there.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from procgen_tpu.render import fast2 as j_fast2
from procgen_tpu.render import pallas_compositor as pc

from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.games import make_game
from procgen_torch.parallel.fast import make_fast_fns
from procgen_torch.render import compositor, fast2
from procgen_torch.render.pack import RenderPack
from procgen_torch.state import seeded_template

torch.set_num_threads(1)

N, E, NV, R = 8, 20, 20, 32


def _inputs(binary_alpha):
    rec, atlas, canvas = compositor.synthetic_case(N, E, NV, R, seed=11, binary_alpha=binary_alpha)
    return rec, atlas, canvas


def _jax_tables(atlas):
    return types.SimpleNamespace(
        R=R,
        NV=NV,
        var_flat=atlas.reshape(NV, -1).astype(np.float32),
        var_flat_cs=np.ascontiguousarray(atlas.transpose(0, 1, 3, 2))
        .reshape(NV, -1)
        .astype(np.float32),
    )


def _port(rec, atlas, canvas, z_filter):
    tables = types.SimpleNamespace(var_mips=torch.as_tensor(atlas))
    out = compositor.composite_entities(
        tables, torch.as_tensor(rec), torch.tensor(E), torch.as_tensor(canvas), z_filter
    )
    return out.numpy()


def _einsum(rec, atlas, canvas, z_filter):
    fn = jax.jit(
        lambda r, c: j_fast2.composite_entities(
            None, None, None, _jax_tables(atlas), r, jnp.asarray(E), c, z_filter
        )
    )
    return np.asarray(fn(jnp.asarray(rec), jnp.asarray(canvas)))


def _frames(c):
    return np.clip(c + 0.5, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("z_filter", ["all", "neg", "nonneg"])
def test_binary_alpha_bitwise(z_filter, monkeypatch):
    rec, atlas, canvas = _inputs(binary_alpha=True)
    got = _port(rec, atlas, canvas, z_filter)
    want = _einsum(rec, atlas, canvas, z_filter)
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    assert (got != canvas).mean() > 0.05  # the records really drew

    monkeypatch.setenv("PROCGEN_TPU_PALLAS_INTERPRET", "1")
    pc._build_call.cache_clear()
    planar = pc.composite_entities_pallas(
        _jax_tables(atlas), jnp.asarray(rec), jnp.asarray(E),
        jnp.transpose(jnp.asarray(canvas), (0, 3, 1, 2)), z_filter,
    )
    pc._build_call.cache_clear()
    pallas = np.asarray(jnp.transpose(planar, (0, 2, 3, 1)))
    np.testing.assert_array_equal(pallas.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("z_filter", ["all", "neg", "nonneg"])
def test_fractional_alpha_within_tolerance(z_filter):
    rec, atlas, canvas = _inputs(binary_alpha=False)
    got = _port(rec, atlas, canvas, z_filter)
    want = _einsum(rec, atlas, canvas, z_filter)
    d = np.abs(got - want)
    assert d.max() <= 1.0
    assert (d > 1e-3).mean() <= 1e-4
    fd = np.abs(_frames(got).astype(np.int32) - _frames(want).astype(np.int32))
    assert fd.max() <= 1
    assert (got != canvas).mean() > 0.05


def test_cpu_tensors_run_the_plain_version():
    rec, atlas, canvas = _inputs(binary_alpha=False)
    before = compositor.launches
    tables = types.SimpleNamespace(var_mips=torch.as_tensor(atlas))
    args = (tables, torch.as_tensor(rec), None, torch.as_tensor(canvas))
    out = compositor.composite_entities(*args)
    ref = compositor.composite_entities_ref(*args)
    assert compositor.launches == before == 0
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref.numpy().view(np.int32))
    # kmax bounds the walk: records past it are never drawn
    cut = compositor.composite_entities(tables, torch.as_tensor(rec), 5, torch.as_tensor(canvas))
    rec5 = rec.copy()
    rec5[:, 5:, 7] = 0.0  # ok = 0 past kmax
    same = compositor.composite_entities(tables, torch.as_tensor(rec5), None, torch.as_tensor(canvas))
    np.testing.assert_array_equal(cut.numpy(), same.numpy())
    with pytest.raises(ValueError):
        compositor.composite_entities(*args, z_filter="above")


def _span_case(axis, seed=3):
    """One record per env: the tested axis from seeded and adversarial
    (lo, size) pairs, the other axis covering the screen, tiled and
    reflected at random, over an opaque atlas and a zero canvas."""
    rs = np.random.RandomState(seed)
    lo_r = rs.uniform(-40, 100, 1500).astype(np.float32)
    size_r = np.exp(rs.uniform(np.log(1e-6), np.log(80), 1500)).astype(np.float32)
    lo_e, size_e = compositor.edge_axes(rs, 3000)
    lo, size = np.concatenate([lo_r, lo_e]), np.concatenate([size_r, size_e])
    m = len(lo)
    F = compositor._F
    rec = np.zeros((m, 1, compositor.NF), np.float32)
    rec[:, 0, F["bbx0"]] = rec[:, 0, F["bby0"]] = -1.0
    rec[:, 0, F["bbw"]] = rec[:, 0, F["bbh"]] = 70.0
    a, b = ("bbx0", "bbw") if axis == "x" else ("bby0", "bbh")
    rec[:, 0, F[a]], rec[:, 0, F[b]] = lo, size
    rec[:, 0, F["alpha"]] = rec[:, 0, F["ok"]] = 1.0
    rec[:, 0, F["n_th"]] = rs.choice([1, 2, 3, 7], m)
    rec[:, 0, F["n_tv"]] = rs.choice([1, 2, 3, 7], m)
    rec[:, 0, F["refl"]] = rs.randint(0, 2, m)
    return lo, size, rec


@pytest.mark.parametrize("axis", ["x", "y"])
def test_pixel_span_holds_every_drawn_pixel(axis):
    lo, size, rec = _span_case(axis)
    tables = types.SimpleNamespace(var_mips=torch.full((1, 4, 4, 4), 255, dtype=torch.uint8))
    drawn = []
    for i in range(0, len(lo), 500):
        r = torch.as_tensor(rec[i:i + 500])
        out = compositor.composite_entities_ref(
            tables, r, None, torch.zeros((len(r), 64, 64, 3), dtype=torch.float32))
        hit = (out != 0).any(-1).numpy()  # (n, y, x)
        drawn.append(hit.any(1) if axis == "x" else hit.any(2))
    drawn = np.concatenate(drawn)  # (m, 64) along the tested axis
    first, end = compositor.pixel_span(lo, size)
    pix = np.arange(64)[None, :]
    inside = (pix >= first[:, None]) & (pix < end[:, None])
    bad = np.argwhere(drawn & ~inside)
    assert not len(bad), [(lo[i], size[i], first[i], end[i], x) for i, x in bad[:5]]
    # not vacuous: many boxes draw, some with an edge on a pixel centre
    assert drawn.any(1).mean() > 0.3
    centre = (np.float32(lo) - np.float32(0.5)) % 1 == 0
    assert (drawn.any(1) & centre).sum() > 50
    # and the span clips: a finite on-screen box spans at most 3 pixels more
    finite = (size > 0) & (size < 100) & (np.abs(lo) < 100)
    assert ((end - first) <= np.ceil(size) + 3)[finite].all()


GAMES = ["maze", "miner", "chaser", "coinrun", "leaper"]


@pytest.mark.parametrize("game", GAMES)
def test_main_path_canvases_are_nonnegative(game, monkeypatch):
    """The kernel skips the pixels outside a record's span, where the plain
    version computes c = 0 + c * (1 - 0): the same bits unless c is -0.0 (or
    NaN).  Every canvas the main path hands the compositor is >= +0."""
    cfg = EnvConfig(env_name=game, num_envs=2, distribution_mode=DistributionMode.hard,
                    rand_seed=5, use_generated_assets=True)
    gd = make_game(cfg)
    pack = RenderPack(gd, cfg)
    init, step = make_fast_fns(gd, cfg, pack, refill_bucket=2)
    seen = []
    real = compositor.composite_entities

    def spy(tables, records, kmax, canvas, z_filter="all"):
        seen.append(canvas.clone())
        return real(tables, records, kmax, canvas, z_filter)

    monkeypatch.setattr(compositor, "composite_entities", spy)
    fs = init.cold(seeded_template(gd, cfg, 2, device="cpu"))
    rs = np.random.RandomState(0)
    for t in range(4):
        fs = step(fs, torch.as_tensor(rs.randint(-1 if t == 2 else 0, 15, size=2), dtype=torch.int32))
        fast2.render_frames2(gd, cfg, fs.state, pack)
    assert len(seen) == 4 * (2 if gd.grid_dynamic else 1)
    for c in seen:
        assert torch.isfinite(c).all()
        assert not torch.signbit(c).any(), "a canvas holds -0.0 or a negative value"
