"""PNG asset pipeline on the host (counterpart of
``procgen_tpu/render/assets.py``).

The reference decodes its PNGs into a QImage cache once per process
(resources.cpp:13-30).  Here each PNG is decoded once on the host (a PNG
reader of its own: zlib for the stream, a small C++ scanline unfilter built
with ``g++`` into ``procgen_torch/_build/`` on first use) and packed into
per-game uint8 atlases (``render/pack.py``).  The asset root is the
directory ``PROCGEN_TORCH_ASSET_ROOT`` names (a procgen ``data/assets``
tree); ``procgen_torch.bench.synth_assets`` writes a synthetic one.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from procgen_torch import cuda_build

ROOT_ENV = "PROCGEN_TORCH_ASSET_ROOT"

# Background groups in load order (resources.cpp:826-954); the per-level
# background_index = randn(len(group)) indexes these lists, so their order
# is part of the determinism contract.  Space backgrounds are appended to
# platform (resources.cpp:949-952).
_SPACE_BACKGROUNDS = [
    "space_backgrounds/deep_space_01.png",
    "space_backgrounds/spacegen_01.png",
    "space_backgrounds/milky_way_01.png",
    "space_backgrounds/ez_space_lite_01.png",
    "space_backgrounds/meyespace_v1_01.png",
    "space_backgrounds/eye_nebula_01.png",
    "space_backgrounds/deep_sky_01.png",
    "space_backgrounds/space_nebula_01.png",
    "space_backgrounds/Background-1.png",
    "space_backgrounds/Background-2.png",
    "space_backgrounds/Background-3.png",
    "space_backgrounds/Background-4.png",
    "space_backgrounds/parallax-space-backgound.png",
]

_PLATFORM_BACKGROUNDS = [
    "platform_backgrounds/alien_bg.png",
    "platform_backgrounds/another_world_bg.png",
    "platform_backgrounds/back_cave.png",
    "platform_backgrounds/caverns.png",
    "platform_backgrounds/cyberpunk_bg.png",
    "platform_backgrounds/parallax_forest.png",
    "platform_backgrounds/scifi_bg.png",
    "platform_backgrounds/scifi2_bg.png",
    "platform_backgrounds/living_tissue_bg.png",
    "platform_backgrounds/airadventurelevel1.png",
    "platform_backgrounds/airadventurelevel2.png",
    "platform_backgrounds/airadventurelevel3.png",
    "platform_backgrounds/airadventurelevel4.png",
    "platform_backgrounds/cave_background.png",
    "platform_backgrounds/blue_desert.png",
    "platform_backgrounds/blue_grass.png",
    "platform_backgrounds/blue_land.png",
    "platform_backgrounds/blue_shroom.png",
    "platform_backgrounds/colored_desert.png",
    "platform_backgrounds/colored_grass.png",
    "platform_backgrounds/colored_land.png",
    "platform_backgrounds/colored_shroom.png",
    "platform_backgrounds/landscape1.png",
    "platform_backgrounds/landscape2.png",
    "platform_backgrounds/landscape3.png",
    "platform_backgrounds/landscape4.png",
    "platform_backgrounds/battleback1.png",
    "platform_backgrounds/battleback2.png",
    "platform_backgrounds/battleback3.png",
    "platform_backgrounds/battleback4.png",
    "platform_backgrounds/battleback5.png",
    "platform_backgrounds/battleback6.png",
    "platform_backgrounds/battleback7.png",
    "platform_backgrounds/battleback8.png",
    "platform_backgrounds/battleback9.png",
    "platform_backgrounds/battleback10.png",
    "platform_backgrounds/sunrise.png",
    "platform_backgrounds_2/beach1.png",
    "platform_backgrounds_2/beach2.png",
    "platform_backgrounds_2/beach3.png",
    "platform_backgrounds_2/beach4.png",
    "platform_backgrounds_2/fantasy1.png",
    "platform_backgrounds_2/fantasy2.png",
    "platform_backgrounds_2/fantasy3.png",
    "platform_backgrounds_2/fantasy4.png",
    "platform_backgrounds_2/candy1.png",
    "platform_backgrounds_2/candy2.png",
    "platform_backgrounds_2/candy3.png",
    "platform_backgrounds_2/candy4.png",
] + _SPACE_BACKGROUNDS

BACKGROUND_GROUPS = {
    "space_backgrounds": _SPACE_BACKGROUNDS,
    "platform_backgrounds": _PLATFORM_BACKGROUNDS,
    "topdown_backgrounds": [
        "topdown_backgrounds/floortiles.png",
        "topdown_backgrounds/backgrounddetailed1.png",
        "topdown_backgrounds/backgrounddetailed2.png",
        "topdown_backgrounds/backgrounddetailed3.png",
        "topdown_backgrounds/backgrounddetailed4.png",
        "topdown_backgrounds/backgrounddetailed5.png",
        "topdown_backgrounds/backgrounddetailed6.png",
        "topdown_backgrounds/backgrounddetailed7.png",
        "topdown_backgrounds/backgrounddetailed8.png",
    ],
    "topdown_simple_backgrounds": ["topdown_backgrounds/floortiles.png"],
    "water_backgrounds": [
        "water_backgrounds/water1.png",
        "water_backgrounds/water2.png",
        "water_backgrounds/water3.png",
        "water_backgrounds/water4.png",
        "water_backgrounds/underwater1.png",
        "water_backgrounds/underwater2.png",
        "water_backgrounds/underwater3.png",
    ],
    "water_surface_backgrounds": [
        "water_backgrounds/water1.png",
        "water_backgrounds/water2.png",
        "water_backgrounds/water3.png",
        "water_backgrounds/water4.png",
    ],
}

@functools.lru_cache(maxsize=1)
def _unfilter_lib() -> ctypes.CDLL:
    """The scanline unfilter (``csrc/png_unfilter.cpp``), built with g++ on
    first use (raises if the build fails)."""
    lib = cuda_build.load("png_unfilter")
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    return lib


def asset_root() -> Path:
    env = os.environ.get(ROOT_ENV)
    if env:
        return Path(env)
    raise FileNotFoundError(
        f"no asset root found; set {ROOT_ENV} to a procgen data/assets "
        "directory (python3 -m procgen_torch.bench.synth_assets DIR writes a "
        "synthetic one)"
    )


def png_size(name: str) -> tuple[int, int]:
    """(width, height) from the IHDR without decoding."""
    return _png_size(str(asset_root() / name))


@functools.lru_cache(maxsize=4096)
def _png_size(path: str) -> tuple[int, int]:
    with open(path, "rb") as f:
        f.read(16)
        w, h = struct.unpack(">II", f.read(8))
    return int(w), int(h)


def aspect_ratio(name: str) -> float:
    """w / h in double; callers narrow it to float32."""
    w, h = png_size(name)
    return w * 1.0 / h


def decode_png(name: str) -> np.ndarray:
    """Decode a PNG to (H, W, 4) uint8 RGBA: colour types 0 (gray), 2 (RGB),
    3 (palette, with tRNS alpha), 4 (gray + alpha) and 6 (RGBA), bit depths
    1, 2 and 4 (gray and palette) and 8, filters 0-4, no interlace.  The
    returned array is shared between callers: do not write to it."""
    return _decode(str(asset_root() / name))


def clear_caches() -> None:
    """Forget every size and image read (cached by path)."""
    _png_size.cache_clear()
    _decode.cache_clear()


@functools.lru_cache(maxsize=2048)
def _decode(path: str) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = []
    palette = trns = None
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", chunk[:10])
            if bit_depth not in (1, 2, 4, 8) or chunk[12] != 0:
                raise ValueError(f"{path}: bit depth {bit_depth} or interlace unsupported")
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    stride = (w * channels * bit_depth + 7) // 8
    bpp = max(1, channels * bit_depth // 8)
    out = np.zeros((h, stride), np.uint8)
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rc = _unfilter_lib().png_unfilter(raw, out.ctypes.data_as(ctypes.c_void_p), h, stride, bpp)
    if rc != 0:
        raise ValueError(f"{path}: bad filter byte")
    if bit_depth < 8:
        # sub-byte depths occur only for gray and palette (one channel)
        bits = np.unpackbits(out, axis=1)[:, :w * bit_depth]
        weights = (1 << np.arange(bit_depth - 1, -1, -1)).astype(np.uint16)
        idx = (bits.reshape(h, w, bit_depth) * weights).sum(axis=2)
        if color_type == 0:
            idx = idx * (255 // ((1 << bit_depth) - 1))
        img = idx.astype(np.uint8).reshape(h, w, 1)
    else:
        img = out.reshape(h, w, channels)
    opaque = np.full((h, w, 1), 255, np.uint8)
    if color_type == 0:
        rgba = np.concatenate([img] * 3 + [opaque], axis=2)
    elif color_type == 2:
        rgba = np.concatenate([img, opaque], axis=2)
    elif color_type == 3:
        idx = img[..., 0]
        alpha_lut = np.full(palette.shape[0], 255, np.uint8)
        if trns is not None:
            n = min(len(trns), len(alpha_lut))
            alpha_lut[:n] = trns[:n]
        rgba = np.dstack([palette[idx], alpha_lut[idx]])
    elif color_type == 4:
        rgba = np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=2)
    else:
        rgba = img
    rgba = np.ascontiguousarray(rgba)
    rgba.flags.writeable = False
    return rgba
