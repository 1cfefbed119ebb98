"""procgen_torch's trig against the host libm (glibc, through ctypes): the
functions the reference binary links.

* ``fmath.face_rotation`` (a 16-entry table keyed on the sign bit and
  zero-ness of each component) against ``-atan2f(dy, dx) + offset`` for
  every key, both IEEE zeros included, at the offsets the ported games use
  (0 and caveflyer's -pi/2), for axis-aligned inputs of any magnitude and
  the 8 unit directions;
* ``fmath.dsincos`` (fdlibm's algorithm as eager float64 ops) against
  glibc's double ``sin``/``cos``: narrowed to float32 (the fast mode) bit
  for bit on 2^17 random angles in [-300, 300] (the range caveflyer's ship
  reaches in a 1000-step episode) and on the hard cases of the argument
  reduction (floats next to multiples of pi/2) and the kernels' branch
  points; in float64 (parity mode) within 1 ulp;
* ninja's star table against glibc's ``cos``/``sin`` of the float64 angle,
  narrowed.  The table is unchanged from its former numpy form.
"""

import numpy as np
import pytest
import torch

from procgen_torch import fmath as fm
from procgen_torch.games import ninja as NJ

PI = float(np.float32(np.pi))


class _Cfg:
    def __init__(self, parity_mode):
        self.parity_mode = parity_mode


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _glibc(name, x):
    fn = getattr(fm.libm(), name)
    return np.array([fn(float(v)) for v in np.asarray(x, np.float32)], np.float64)


@pytest.mark.parametrize("offset", [0.0, -PI / 2])
def test_face_rotation_matches_glibc(offset):
    mags = np.float32([1.0, 0.05, 0.0375, 0.375, 2.5e-3, 1e-30, 3e38])
    dx, dy = [], []
    for m in mags:
        for s in (1.0, -1.0):
            for z in (0.0, -0.0):
                dx += [s * m, z]
                dy += [z, s * m]
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            dx.append(sx)
            dy.append(sy)
    for zx in (0.0, -0.0):  # both components zero (outside every guard)
        for zy in (0.0, -0.0):
            dx.append(zx)
            dy.append(zy)
    dx, dy = np.float32(dx), np.float32(dy)
    got = fm.face_rotation(_Cfg(False), torch.as_tensor(dx), torch.as_tensor(dy), offset)
    want = -fm.atan2f_libm(dy, dx) + np.float32(offset)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the sign of a zero component matters: atan2f(-0.0, -1) = -pi
    flip = fm.face_rotation(_Cfg(True), torch.tensor([-1.0, -1.0]), torch.tensor([0.0, -0.0]))
    assert float(flip[0]) == -PI and float(flip[1]) == PI


def _hard_angles():
    k = np.arange(-191, 192, dtype=np.float64)
    near = (k * (np.pi / 2)).astype(np.float32)
    near = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                           np.nextafter(near, np.float32(-np.inf))])
    edges = np.float32([0.0, -0.0, 1e-30, -1e-30, 3e-40, 0.3, 0.29999998, 0.78125,
                        0.7812501, np.pi / 4, 0.7853981, 0.78539819, 300.0, -300.0])
    return np.concatenate([near, edges, -edges])


def test_dsincos_matches_glibc():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-300, 300, 1 << 17).astype(np.float32), _hard_angles()])
    ws, wc = _glibc("sin", x), _glibc("cos", x)
    s, c = fm.dsincos(_Cfg(False), torch.as_tensor(x))
    assert s.dtype == torch.float32 and c.dtype == torch.float32
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(ws.astype(np.float32)))
    np.testing.assert_array_equal(_bits(c.numpy()), _bits(wc.astype(np.float32)))
    # parity mode keeps the double (the caller narrows at its store)
    s64, c64 = fm.dsincos(_Cfg(True), torch.as_tensor(x))
    assert s64.dtype == torch.float64
    for got, want in ((s64.numpy(), ws), (c64.numpy(), wc)):
        ulps = np.abs(got.view(np.int64) - want.view(np.int64))
        assert ulps[np.sign(got) == np.sign(want)].max() <= 1
        np.testing.assert_array_equal(_bits(got.astype(np.float32)), _bits(want.astype(np.float32)))


def test_ninja_star_table_matches_glibc():
    theta = NJ._star_angles()
    table = NJ._star_velocity_table("cpu").numpy()
    want = np.stack([_glibc("cos", theta), _glibc("sin", theta)], 1).astype(np.float32)
    np.testing.assert_array_equal(_bits(table), _bits(want))
    # the same 8 entries as numpy's cos/sin gave before the switch to glibc
    wide = theta.astype(np.float64)
    old = np.stack([np.cos(wide), np.sin(wide)], 1).astype(np.float32)
    np.testing.assert_array_equal(_bits(table), _bits(old))
