"""A plain PNG reader (RFC 2083): colour types 0, 2, 3 (with tRNS), 4 and
6, bit depths 1, 2, 4 and 8, the five scanline filters, no interlace.
Returns (h, w, 4) uint8 RGBA: gray is copied to the three colours, gray of
1-4 bits is scaled to 8 by 255 // (2**depth - 1), a palette entry takes its
tRNS alpha (255 past the end of tRNS), and types without alpha are opaque.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = int(data[y, 0]), data[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prior) & 0xFF
        elif f == 1:  # Sub: a running sum of each byte lane (stride % bpp == 0)
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif f in (3, 4):
            cur = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad filter byte {f}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def read_png(path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos, idat, palette, trns = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if interlace:
                raise ValueError(f"{path}: interlaced")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        vals = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        if ctype == 0:
            vals = vals * (255 // ((1 << depth) - 1))
        img = vals.astype(np.uint8)[..., None]
    else:
        img = rows.reshape(h, w, ch)
    opaque = np.full((h, w, 1), 255, np.uint8)
    if ctype == 0:
        return np.concatenate([img, img, img, opaque], 2)
    if ctype == 2:
        return np.concatenate([img, opaque], 2)
    if ctype == 4:
        return np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], 2)
    if ctype == 3:
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
        idx = img[..., 0]
        return np.dstack([palette[idx], alpha[idx]])
    return img.copy()
