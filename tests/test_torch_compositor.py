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

from procgen_torch.render import compositor

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
