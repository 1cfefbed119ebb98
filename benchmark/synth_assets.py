"""The synthetic asset root, a frozen copy of
``procgen_torch/bench/synth_assets.py`` at commit 46b2158.

The Procgen PNG assets are not in the repository.  ``write_root`` writes,
under a directory, one PNG for every sprite name that a game of the port
reaches and every background (the names, as that commit listed them, are in
``data/asset_names.json``), all drawn from a seed and the name, so the same
seed gives the same bytes.  The names, in sorted order, cycle through every
colour type and bit depth a PNG reader must handle, row y uses filter
``(y + k) % 5``; sprites are 12-96 px with binary alpha, backgrounds
160-400 px wide.  Real assets change the pack's build on the host, not the
per-frame work: every sprite is resampled to a 32x32 mip.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

_NAMES = Path(__file__).resolve().parent / "data" / "asset_names.json"

# (colour type, bit depth) in the order names cycle through them
ENCODINGS = (
    (6, 8), (3, 8), (2, 8), (4, 8), (0, 8),
    (3, 4), (0, 4), (3, 2), (0, 2), (3, 1), (0, 1),
)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def sprite_names() -> list[str]:
    return list(json.loads(_NAMES.read_text())["sprites"])


def background_names() -> list[str]:
    return list(json.loads(_NAMES.read_text())["backgrounds"])


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, first_filter: int) -> bytes:
    """Each scanline (rows (h, stride) uint8) with its filter byte, row y
    filtered with filter (y + first_filter) % 5 (RFC 2083 section 6)."""
    h, stride = rows.shape
    cur = rows.astype(np.int32)
    prior = np.vstack([np.zeros((1, stride), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), cur[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int32), prior[:, :-bpp]])
    preds = (
        np.zeros_like(cur), left, prior, (left + prior) >> 1, _paeth(left, prior, ul),
    )
    out = bytearray()
    for y in range(h):
        f = (y + first_filter) % 5
        out.append(f)
        out += ((cur[y] - preds[f][y]) & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def encode_png(samples: np.ndarray, color_type: int, bit_depth: int,
               palette=None, trns=None, first_filter: int = 0) -> bytes:
    """PNG bytes of ``samples`` (h, w, channels) uint8 sample values (palette
    indices for type 3; values below 2**bit_depth for sub-byte depths)."""
    h, w, ch = samples.shape
    assert ch == _CHANNELS[color_type]
    if bit_depth < 8:
        bits = np.unpackbits(samples[..., 0][..., None], axis=2)[..., 8 - bit_depth:]
        rows = np.packbits(bits.reshape(h, w * bit_depth), axis=1)
    else:
        rows = samples.reshape(h, w * ch)
    bpp = max(1, ch * bit_depth // 8)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    out += _chunk(b"IDAT", zlib.compress(_filtered(rows, bpp, first_filter), 6))
    return out + _chunk(b"IEND", b"")


def _image(rs, w: int, h: int, color_type: int, bit_depth: int,
           inside: np.ndarray, fractional: bool):
    """Samples (and palette, tRNS) of a w x h image: smooth colour bands
    (values 32-255) where ``inside``, transparent outside where the type
    carries alpha."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = rs.randint(32, 256, size=3)
    ramp = ((xx * 7 + yy * 13) % 48)[..., None]
    rgb = np.clip(base[None, None, :] - ramp, 32, 255).astype(np.uint8)
    if fractional:
        alpha = rs.randint(1, 255, size=(h, w)).astype(np.uint8)
    else:
        alpha = np.full((h, w), 255, np.uint8)
    alpha = np.where(inside, alpha, 0).astype(np.uint8)
    if color_type == 6:
        return np.dstack([rgb, alpha]), None, None
    if color_type == 2:
        return rgb, None, None
    gray = rgb.mean(axis=2).astype(np.uint8)
    if color_type == 4:
        return np.dstack([gray, alpha]), None, None
    top = (1 << bit_depth) - 1
    if color_type == 0:
        if bit_depth < 8:  # the upper half of the range: no black pixels
            gray = (top + 1) // 2 + (gray.astype(np.int32) * ((top + 1) // 2 + 1) >> 8)
            gray = np.minimum(gray, top)
        return gray.astype(np.uint8)[..., None], None, None
    # palette: entry 0 transparent, the rest opaque colours
    n = top + 1
    palette = np.clip(base[None, :] - rs.randint(0, 48, size=(n, 3)), 32, 255).astype(np.uint8)
    trns = np.full(n, 255, np.uint8)
    trns[0] = 0
    idx = 1 + ((xx * 3 + yy * 5) % max(n - 1, 1))
    idx = np.where(inside, idx, 0).astype(np.uint8)
    return idx[..., None], palette, trns


def _seed_of(seed: int, name: str) -> int:
    return (seed * 0x9E3779B1 + zlib.crc32(name.encode())) & 0xFFFFFFFF


def write_root(root, seed: int = 0, fractional=()) -> Path:
    """Write the synthetic asset root under ``root`` and return it.
    ``fractional``: sprite names written with alpha 1-254 (RGBA)."""
    root = Path(root)
    fractional = set(fractional)
    sprites = sprite_names()
    unknown = fractional - set(sprites)
    if unknown:
        raise ValueError(f"fractional names are not sprites: {sorted(unknown)}")
    jobs = [(n, False) for n in sprites] + [(n, True) for n in background_names()]
    for k, (name, is_bg) in enumerate(jobs):
        rs = np.random.RandomState(_seed_of(seed, name))
        color_type, bit_depth = ENCODINGS[k % len(ENCODINGS)]
        if is_bg:
            w = int(rs.randint(160, 401))
            h = int(rs.randint(80, w - 20))
            inside = np.ones((h, w), bool)
        else:
            w, h = (int(v) for v in rs.randint(12, 97, size=2))
            if w == h:
                h = h - 1 if h > 12 else h + 1
            yy, xx = np.mgrid[0:h, 0:w]
            u, v = (xx + 0.5) / w - 0.5, (yy + 0.5) / h - 0.5
            inside = u * u + v * v < 0.25 + 0.02 * rs.rand()
        frac = name in fractional
        if frac:
            color_type, bit_depth = 6, 8
        samples, palette, trns = _image(rs, w, h, color_type, bit_depth, inside, frac)
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(encode_png(samples, color_type, bit_depth, palette, trns,
                                    first_filter=k % 5))
    return root
