"""procgen_torch's trig against the host libm (glibc, through ctypes): the
functions the reference binary links.

* ``fmath.face_rotation`` (``-atan2f(dy, dx) + offset`` through
  ``fmath.atan2f``) against glibc at the offsets the ported games use (0
  and -pi/2), for axis-aligned inputs of any magnitude with both IEEE
  zeros, the 8 unit directions and random velocities;
* ``fmath.dsincos`` (fdlibm's algorithm as eager float64 ops) against
  glibc's double ``sin``/``cos``: narrowed to float32 (the fast mode) bit
  for bit on 2^17 random angles in [-300, 300] (the range caveflyer's ship
  reaches in a 1000-step episode) and on the hard cases of the argument
  reduction (floats next to multiples of pi/2) and the kernels' branch
  points; in float64 (parity mode) within 1 ulp;
* ninja's star table against glibc's ``cos``/``sin`` of the float64 angle,
  narrowed.  The table is unchanged from its former numpy form;
* ``fmath.atan2f`` (glibc's float atan2f as eager float32 ops) against
  glibc on random and special pairs, bit for bit;
* ``fmath.sqrt32`` against the IEEE float32 square root (numpy's), bit for
  bit: torch's own CPU ``sqrt`` is not correctly rounded.
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
    rs = np.random.RandomState(11)  # starpilot-like velocities
    dx = np.concatenate([np.float32(dx), np.float32(rs.uniform(-1, 1, 4096) * 0.05)])
    dy = np.concatenate([np.float32(dy), np.float32(rs.uniform(-1, 1, 4096) * 0.05)])
    got = fm.face_rotation(torch.as_tensor(dx), torch.as_tensor(dy), offset)
    want = -fm.atan2f_libm(dy, dx) + np.float32(offset)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the sign of a zero component matters: atan2f(-0.0, -1) = -pi
    flip = fm.face_rotation(torch.tensor([-1.0, -1.0]), torch.tensor([0.0, -0.0]))
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


def test_atan2f_matches_glibc():
    """fmath.atan2f (starpilot's enemy bullets face their continuous
    velocity) against glibc's atan2f bit for bit: 3 x 2^16 random pairs at
    three spreads of magnitude, starpilot-like velocities, and every pair of
    signed zeros, ones, tiny and huge values and exact ratios that pick each
    branch of the argument reduction."""
    rs = np.random.RandomState(7)
    n = 1 << 16
    ys, xs = [], []
    for spread in (0.0, 20.0, 80.0):
        for out in (ys, xs):
            out.append(rs.standard_normal(n) * np.exp(rs.uniform(-spread, spread, n)))
    ys.append(rs.uniform(-16, 16, n) * 0.05)
    xs.append(rs.uniform(-16, 16, n) * 0.05)
    special = np.float32([0.0, -0.0, 1.0, -1.0, 0.4375, 0.6875, 1.1875, 2.4375, 7.0 / 16,
                          1e-30, -1e-30, 3e38, -3e38, 0.5, 2.0, 1.5, 0.8, -0.8])
    sy, sx = np.meshgrid(special, special)
    y = np.concatenate([np.float32(v) for v in ys] + [sy.ravel()])
    x = np.concatenate([np.float32(v) for v in xs] + [sx.ravel()])
    got = fm.atan2f(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(fm.atan2f_libm(y, x)))


def test_sqrt32_is_correctly_rounded():
    """fmath.sqrt32 (the sub-step count's and starpilot's aimed bullets'
    square roots) against numpy's float32 sqrt (the IEEE square root),
    bit for bit, over 2^20 floats spread over 80 binades, perfect squares
    and their neighbours."""
    rs = np.random.RandomState(3)
    x = np.float32(np.exp(rs.uniform(-40, 40, 1 << 20)))
    k = np.float32(np.arange(1, 4096)) / np.float32(16)
    sq = np.float32(k * k)
    x = np.concatenate([x, sq, np.nextafter(sq, np.float32(0)), np.nextafter(sq, np.float32(1e9)),
                        np.float32([0.0, 1e-45, 3e38])])
    got = fm.sqrt32(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(x)))
