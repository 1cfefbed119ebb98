"""The yardstick's counts: the IMPALA CNN's FLOPs from its shapes, the
frame composite's bytes and operations (the frame's uint8 work, whatever
canvas an implementation keeps), the union of device intervals, and the
inputs drawn from seeds past 32 bits."""

import numpy as np
import pytest
import torch

from benchmark import inputs, trace, yardstick


def test_impala_forward_is_61_2_mflop():
    # stacks: 3->16 at 64x64, 16->32 at 32x32, 32->32 at 16x16, each with
    # two residual blocks of two convolutions at half the side; dense
    # 2048->256; heads 256->15 and 256->1
    macs = (64 * 64 * 16 * 3 * 9 + 4 * 32 * 32 * 16 * 16 * 9
            + 32 * 32 * 32 * 16 * 9 + 4 * 16 * 16 * 32 * 32 * 9
            + 16 * 16 * 32 * 32 * 9 + 4 * 8 * 8 * 32 * 32 * 9
            + 2048 * 256 + 256 * 16)
    assert yardstick.impala_forward_flops() == 2 * macs
    assert round(yardstick.impala_forward_flops() / 1e6, 1) == 61.2


def test_ppo_iteration_is_about_40_tflop():
    f = yardstick.ppo_iteration_flops(256, 256, 3)
    assert f == (257 * 256 + 3 * 256 * 256 * 3) * yardstick.impala_forward_flops()
    assert round(f / 1e12, 1) == 40.1


def _records(n, e, seed=0):
    rs = np.random.RandomState(seed)
    rec = np.zeros((n, e, 11), np.float32)
    rec[..., 0] = rs.uniform(-10, 60, (n, e))
    rec[..., 1] = rs.uniform(-10, 60, (n, e))
    rec[..., 2] = rs.uniform(1, 20, (n, e))
    rec[..., 3] = rs.uniform(1, 20, (n, e))
    rec[..., 7] = rs.rand(n, e) < 0.7
    return torch.from_numpy(rec)


def test_composite_counts_the_frames_uint8_work():
    rec = _records(16, 5)
    nbytes, flops = yardstick.composite_work(rec, atlas_bytes=4096)
    drawn = int((rec[..., 7] > 0).sum())
    assert nbytes == 2 * 16 * 64 * 64 * 3 + drawn * 11 * 4 + 4096
    # a float32 canvas read and written would count 8 bytes a sample
    assert nbytes < 16 * 64 * 64 * 3 * 4 * 2
    # every covered pixel by brute force
    want = 0
    for r in rec.reshape(-1, 11).tolist():
        if r[7] > 0:
            xs = [x for x in range(64) if 0 <= (x + 0.5 - r[0]) / r[2] < 1]
            ys = [y for y in range(64) if 0 <= (y + 0.5 - r[1]) / r[3] < 1]
            want += len(xs) * len(ys)
    assert flops == 20 * want


@pytest.mark.parametrize("canvas_dtype", [torch.float32, torch.uint8, torch.bfloat16])
def test_composite_count_ignores_the_canvas(canvas_dtype):
    # the count takes the records and the atlas alone: an implementation's
    # canvas, in any dtype, does not enter it
    rec = _records(8, 3, seed=1)
    canvas = torch.zeros((8, 64, 64, 3), dtype=canvas_dtype)
    assert canvas.dtype == canvas_dtype
    assert yardstick.composite_work(rec, 100) == yardstick.composite_work(rec.clone(), 100)


def test_bound_takes_the_larger_side():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)


def test_busy_time_is_a_union_not_a_sum():
    merged = trace.union([(0, 10), (5, 15), (20, 30), (21, 22)])
    assert merged == [[0, 15], [20, 30]]
    assert sum(e - s for s, e in merged) == 25  # the durations sum to 32


def test_inputs_from_seeds_past_32_bits():
    big = 2 ** 31 + 12345
    a, b = inputs.sub_seeds(big), inputs.sub_seeds(big)
    assert a == b and a != inputs.sub_seeds(big + 1)
    p = inputs.phases(1914, 100, 500)
    assert p.dtype == np.int32 and p.min() >= 0 and p.max() < 500
    o = inputs.order(a["order"], 100)
    assert sorted(o) == list(range(100)) and (o == inputs.order(a["order"], 100)).all()
