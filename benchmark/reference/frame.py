"""One env's 64x64 observation, in float32 NumPy, as procgen's draw pass
(basic-abstract-game.cpp:819-1007) states it for a whole-world view (maze
and miner in hard mode do not centre the agent), drawn from fixed-size
sprite images:

- the view: ``unit = 64 / max(world width, height)``, the world's rect
  filling the frame;
- the background: the level's background image, read nearest at 64x64,
  stretched over the world's rect to its own aspect ratio and offset by
  the level's ``bg_pct_x``;
- grid cells: each cell's sprite (a 32x32 nearest resample of its PNG),
  drawn over its cell grown by 0.02 on each side, blended by its alpha:
  ``c = s * a + c * (1 - a)``;
- entities in ``render_z`` order (-1, 0, 1): each sprite nearest-sampled
  over its box, mirrored when the entity is reflected, premultiplied by
  its alpha with the colour and the alpha rounded to bfloat16, and blended
  ``c = s + c * (1 - a)``;
- the per-level layer under the sprites (background, and the grid of a
  static-grid game) rounded to uint8 once per level, and the frame rounded
  to uint8: ``clip(c + 0.5, 0, 255)`` truncated.

Every float operation is one float32 operation, rounded on its own.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from benchmark.reference.png import read_png

F = np.float32
RES = 64
SPRITE_RES = 32
EPS = F(0.02)  # RENDER_EPS, basic-abstract-game.cpp:14
CELL_DIV = F(F(1) + F(F(2) * EPS))
PX = np.arange(RES, dtype=F) + F(0.5)  # pixel centres


def nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest resample: row i reads source row floor((i + 0.5) * H / h)."""
    ys = ((2 * np.arange(h) + 1) * img.shape[0]) // (2 * h)
    xs = ((2 * np.arange(w) + 1) * img.shape[1]) // (2 * w)
    return img[ys[:, None], xs[None, :]]


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (to nearest, ties to even), as float32."""
    b = np.ascontiguousarray(x, F).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F)


def to_uint8(c: np.ndarray) -> np.ndarray:
    return np.clip(c + F(0.5), F(0), F(255)).astype(np.uint8)


def _tex(v: np.ndarray) -> np.ndarray:
    """Texel index of a coordinate in [0, 1): clamp to 0.9999, scale, truncate."""
    return np.clip((np.clip(v, F(0), F(0.9999)) * F(SPRITE_RES)).astype(np.int32), 0,
                   SPRITE_RES - 1)


class Painter:
    """A game's images (read lazily from the asset root) and its view."""

    def __init__(self, game, root):
        self.game, self.root = game, Path(root)
        w = F(game.world_dim)
        self.world = w
        self.unit = F(F(64) / w)
        self.view_dim = F(F(64) / self.unit)
        half = F(self.view_dim * F(0.5))
        self.x_off = F(self.unit * F(F(w * F(0.5)) - half))
        self.y_off = F(self.unit * F(F(w * F(0.5)) - half))
        self._cells()

    @functools.lru_cache(maxsize=None)
    def sprite(self, type_: int) -> np.ndarray:
        img = read_png(self.root / self.game.sprites[type_])
        return nearest(img, SPRITE_RES, SPRITE_RES).astype(F)

    @functools.lru_cache(maxsize=None)
    def background(self, index: int):
        img = read_png(self.root / self.game.backgrounds[index])
        return nearest(img[..., :3], RES, RES).astype(F), F(img.shape[1]), F(img.shape[0])

    def _cells(self):
        """Each pixel column's and row's world cell and texel (the grid of a
        whole-world view is the same every frame)."""
        wx = (PX + self.x_off) / self.unit
        wy = self.view_dim - (PX - self.y_off) / self.unit
        self.cx = np.floor(wx + EPS).astype(np.int32)
        self.cy = np.floor(wy + EPS).astype(np.int32)
        self.tu = _tex((wx - (self.cx.astype(F) - EPS)) / CELL_DIV)
        self.tv = _tex(((self.cy.astype(F) + F(1)) + EPS - wy) / CELL_DIV)

    def bg(self, level) -> np.ndarray:
        img, bw_px, bh_px = self.background(level.background)
        w = h = self.world
        u_ = self.unit
        m_x0 = -self.x_off
        m_y0 = F(F(F(self.view_dim - h) * u_) + self.y_off)
        m_w, m_h = F(w * u_), F(h * u_)
        bg_ar, world_ar = F(bw_px / bh_px), F(w / h)
        offset_x = F(level.bg_pct_x * F(bg_ar - world_ar))
        bx0 = F(m_x0 + F(m_w * -offset_x))
        bw = F(m_w * F(bg_ar / world_ar))
        u = (PX - bx0) / bw
        v = (PX - m_y0) / m_h
        su = np.clip((u * F(RES)).astype(np.int32), 0, RES - 1)
        sv = np.clip((v * F(RES)).astype(np.int32), 0, RES - 1)
        inside = ((v >= 0) & (v < 1))[:, None] & ((u >= 0) & (u < 1))[None, :]
        return np.where(inside[..., None], img[sv[:, None], su[None, :]], F(0))

    def grid(self, level, canvas: np.ndarray) -> np.ndarray:
        g = level.grid
        h, w = g.shape
        in_y = (self.cy >= 0) & (self.cy < h)
        in_x = (self.cx >= 0) & (self.cx < w)
        cells = g[np.clip(self.cy, 0, h - 1)[:, None], np.clip(self.cx, 0, w - 1)[None, :]]
        cells = np.where(in_y[:, None] & in_x[None, :], cells, -1)
        out = canvas.copy()
        for t, image in self.game.grid_images.items():
            m = cells == t
            if not m.any():
                continue
            spr = self.sprite(image)[self.tv[:, None], self.tu[None, :]]
            a = spr[..., 3] / F(255)
            blend = spr[..., :3] * a[..., None] + canvas * (F(1) - a[..., None])
            out = np.where(m[..., None], blend, out)
        return out

    def static_layer(self, level) -> np.ndarray:
        """The uint8 layer baked once per level."""
        canvas = self.bg(level)
        if not self.game.grid_dynamic:
            canvas = self.grid(level, canvas)
        return to_uint8(canvas)

    def entities(self, level, canvas: np.ndarray, zs) -> np.ndarray:
        order = sorted((i for i, e in enumerate(level.ents) if e.z in zs),
                       key=lambda i: (max(-1, min(1, level.ents[i].z)), i))
        u_ = self.unit
        for i in order:
            e = level.ents[i]
            x0 = F(F(F(e.x - e.rx) * u_) - self.x_off)
            y0 = F(F(F(self.view_dim - F(e.y + e.ry)) * u_) + self.y_off)
            bw = F(F(F(2) * e.rx) * u_)
            bh = F(F(F(2) * e.ry) * u_)
            bx0 = F(F(x0 + F(bw / F(2))) - F(bw / F(2)))
            by0 = F(F(y0 + F(bh / F(2))) - F(bh / F(2)))
            bw, bh = max(bw, F(1e-6)), max(bh, F(1e-6))
            col = (PX - bx0) / bw
            row = (PX - by0) / bh
            inside = ((row >= 0) & (row < 1))[:, None] & ((col >= 0) & (col < 1))[None, :]
            su, sv = _tex(col), _tex(row)
            if e.reflected:
                su = SPRITE_RES - 1 - su
            tex = self.sprite(e.type)[sv[:, None], su[None, :]]
            a = tex[..., 3] * F(e.alpha / F(255))
            s_rgb, s_a = bf16(tex[..., :3] * a[..., None]), bf16(a)
            blend = s_rgb + canvas * (F(1) - s_a[..., None])
            canvas = np.where(inside[..., None], blend, canvas)
        return canvas

    def frame(self, level, static: np.ndarray) -> np.ndarray:
        canvas = static.astype(F)
        if self.game.grid_dynamic:  # the grid goes between the z < 0 sprites and the rest
            canvas = self.entities(level, canvas, (-1,))
            canvas = self.grid(level, canvas)
            canvas = self.entities(level, canvas, (0, 1))
        else:
            canvas = self.entities(level, canvas, (-1, 0, 1))
        return to_uint8(canvas)
