"""The reference's own pieces against what they state: the C++ standard's
MT19937 outputs, and the PNG reader on every encoding the synthetic assets
use."""

import numpy as np
import pytest

from benchmark import synth_assets
from benchmark.reference import frame
from benchmark.reference.mt import RandGen
from benchmark.reference.png import read_png


def test_mt19937_is_the_standard_generator():
    r = RandGen(5489)  # std::mt19937's default seed
    first = r.raw()
    for _ in range(9998):
        r.raw()
    assert first == 3499211612 and r.raw() == 4123659995  # the 10000th, [rand.predef]
    assert RandGen(1).randint_full() == 1791095845
    assert 0 <= RandGen(3).randn(7) < 7 and RandGen(3).rand01().dtype == np.float32


@pytest.mark.parametrize("color_type,depth", synth_assets.ENCODINGS)
@pytest.mark.parametrize("first_filter", range(5))
def test_png_reader_reads_every_encoding(tmp_path, color_type, depth, first_filter):
    rs = np.random.RandomState(color_type * 10 + depth)
    h, w = 7, 13
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    top = (1 << depth) - 1
    samples = rs.randint(0, top + 1, (h, w, ch)).astype(np.uint8)
    palette = trns = None
    if color_type == 3:
        palette = rs.randint(0, 256, (top + 1, 3)).astype(np.uint8)
        trns = np.full(top + 1, 255, np.uint8)
        trns[0] = 0
    path = tmp_path / "x.png"
    path.write_bytes(synth_assets.encode_png(samples, color_type, depth, palette, trns,
                                             first_filter))
    img = read_png(path)
    s = samples.astype(np.int32)
    if color_type == 0:
        g = s[..., 0] * (255 // top)
        want = np.dstack([g, g, g, np.full((h, w), 255)])
    elif color_type == 2:
        want = np.dstack([s, np.full((h, w), 255)])
    elif color_type == 3:
        want = np.dstack([palette[s[..., 0]], trns[s[..., 0]]])
    elif color_type == 4:
        want = np.dstack([s[..., 0]] * 3 + [s[..., 1]])
    else:
        want = s
    assert (img == want).all()


def test_bfloat16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.0e-3], np.float32)
    assert frame.bf16(x).tolist() == [1.0, 1.0, 1.015625, np.float32(0.0030059814453125)]
