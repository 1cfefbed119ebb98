"""Procedural sprite/background generator (host-side numpy painter).

Reimplements the reference's AssetGen (assetgen.cpp:1-195): recursive blotch
painting for block assets, bars+shapes for sprites, a correlated ColorGen
palette.  Drives a bit-exact MT19937 (rng.HostMT) in the reference's exact
call order, so generated textures are deterministic per (seed, type) just as
the reference's are (basic-abstract-game.cpp:100-110 seeds asset_rand_gen
with fixed_asset_seed + type per sprite).

Rasterization approximates QPainter's non-antialiased fill rules (pixel
centers, ARGB32 source-over blending); pixel-level Qt parity is not a goal
here -- the reference itself cannot serialize state with generated assets on
(basic-abstract-game.cpp:1176), so no conformance protocol ever sees these
pixels.

Textures are painted once per (game, config) at pack build time and shipped
to the device as ordinary atlas constants.
"""

from __future__ import annotations

import numpy as np

from procgen_torch.rng import HostMT


class _ColorGen:
    """assetgen.cpp:3-29: palette correlated within one resource."""

    def __init__(self, rand_gen: HostMT):
        self.rg = rand_gen
        self.rgb_start = [0.0, 0.0, 0.0]
        self.rgb_len = [0.0, 0.0, 0.0]

    def roll(self) -> None:
        for i in range(3):
            self.rgb_len[i] = float(self.rg.rand01())
        for i in range(3):
            self.rgb_start[i] = float(self.rg.rand01()) * (1 - self.rgb_len[i])
        self.p_rect = float(self.rg.rand01())

    def rand_color(self) -> tuple[int, int, int]:
        return tuple(
            int(255 * (float(self.rg.rand01()) * self.rgb_len[i] + self.rgb_start[i]))
            for i in range(3)
        )


def _randbool(rg: HostMT) -> bool:
    return float(rg.rand01()) > 0.5  # randgen.cpp:25-27


def _fill_rect(img: np.ndarray, rect, rgba) -> None:
    """Source-over fill of a float rect (Qt grid-intersection rounding)."""
    x, y, w, h = rect
    H, W = img.shape[:2]
    x0 = max(int(np.ceil(x - 0.5)), 0)
    y0 = max(int(np.ceil(y - 0.5)), 0)
    x1 = min(int(np.ceil(x + w - 0.5)), W)
    y1 = min(int(np.ceil(y + h - 0.5)), H)
    if x1 <= x0 or y1 <= y0:
        return
    r, g, b = rgba[0], rgba[1], rgba[2]
    a = (rgba[3] if len(rgba) > 3 else 255) / 255.0
    dst = img[y0:y1, x0:x1]
    src_rgb = np.array([r, g, b], np.float32)
    dst[..., :3] = src_rgb * a + dst[..., :3].astype(np.float32) * (1 - a)
    dst[..., 3] = 255 * a + dst[..., 3].astype(np.float32) * (1 - a)


def _clear_rect(img: np.ndarray, rect) -> None:
    """CompositionMode_Source with transparent (assetgen.cpp:160-161)."""
    x, y, w, h = rect
    H, W = img.shape[:2]
    x0 = max(int(np.ceil(x - 0.5)), 0)
    y0 = max(int(np.ceil(y - 0.5)), 0)
    x1 = min(int(np.ceil(x + w - 0.5)), W)
    y1 = min(int(np.ceil(y + h - 0.5)), H)
    img[y0:y1, x0:x1] = 0


def _draw_ellipse(img: np.ndarray, rect, brush_rgb, pen_rgb) -> None:
    """drawEllipse with brush fill + 1px pen outline (assetgen.cpp:92-96)."""
    x, y, w, h = rect
    if w <= 0 or h <= 0:
        return
    H, W = img.shape[:2]
    cx, cy = x + w / 2, y + h / 2
    rx, ry = max(w / 2, 0.5), max(h / 2, 0.5)
    x0 = max(int(np.floor(x)), 0)
    y0 = max(int(np.floor(y)), 0)
    x1 = min(int(np.ceil(x + w)) + 1, W)
    y1 = min(int(np.ceil(y + h)) + 1, H)
    if x1 <= x0 or y1 <= y0:
        return
    px = np.arange(x0, x1, dtype=np.float32) + 0.5
    py = np.arange(y0, y1, dtype=np.float32) + 0.5
    d = ((px[None, :] - cx) / rx) ** 2 + ((py[:, None] - cy) / ry) ** 2
    inside = d <= 1.0
    # pen ring: inside pixels within ~1px of the boundary
    ring = inside & (
        ((px[None, :] - cx) / max(rx - 1, 0.25)) ** 2
        + ((py[:, None] - cy) / max(ry - 1, 0.25)) ** 2
        > 1.0
    )
    sub = img[y0:y1, x0:x1]
    for mask, rgb in ((inside & ~ring, brush_rgb), (ring, pen_rgb)):
        sub[..., 0] = np.where(mask, rgb[0], sub[..., 0])
        sub[..., 1] = np.where(mask, rgb[1], sub[..., 1])
        sub[..., 2] = np.where(mask, rgb[2], sub[..., 2])
        sub[..., 3] = np.where(mask, 255, sub[..., 3])


class AssetGen:
    """assetgen.cpp painter over a numpy (H, W, 4) uint8 canvas."""

    def __init__(self, rand_gen: HostMT):
        self.rg = rand_gen

    # -- geometry helpers ------------------------------------------------

    def choose_sub_rect(self, rect, min_dim: float, max_dim: float):
        # assetgen.cpp:35-50; note w/h truncate to int as the C++ does
        x, y, rw, rh = rect
        w, h = int(rw), int(rh)
        smaller = h if w > h else w
        del_dim = max_dim - min_dim
        rdx = (float(self.rg.rand01()) * del_dim + min_dim) * smaller
        rdy = (float(self.rg.rand01()) * del_dim + min_dim) * smaller
        rx_off = float(self.rg.rand01()) * (w - rdx)
        ry_off = float(self.rg.rand01()) * (h - rdy)
        return (rx_off + x, ry_off + y, rdx, rdy)

    @staticmethod
    def split_rect(rect, num_splits: int, is_horizontal: bool):
        x, y, w, h = rect
        dw, dh = w / num_splits, h / num_splits
        if is_horizontal:
            return [(x + i * dw, y, dw, h) for i in range(num_splits)]
        return [(x, y + i * dh, w, dh) for i in range(num_splits)]

    def create_bar(self, rect, is_horizontal: bool):
        # assetgen.cpp:134-149 (note the reference uses rect.height() for
        # the horizontal offset too -- reproduced faithfully)
        x, y, rw, rh = rect
        k1 = 0.45 + float(self.rg.rand01()) * 0.4
        k2 = 0.45 + float(self.rg.rand01()) * 0.4
        w = rw * k1 * k1
        h = rh * k2 * k2
        pct = float(self.rg.rand01())
        if not is_horizontal:
            return (0.0, (rh - h) * pct, rw, h)
        return ((rh - w) * pct, 0.0, w, rh)

    # -- painters ---------------------------------------------------------

    def paint_shape(self, img, main_rect, cgen: _ColorGen) -> None:
        k = self.rg.randn(10)
        num_splits = (k * k) // 50 + 1
        split_rects = self.split_rect(main_rect, num_splits, _randbool(self.rg))
        use_rect = _randbool(self.rg)
        regen_colors = _randbool(self.rg)
        c1 = cgen.rand_color()
        c2 = cgen.rand_color()
        for rect in split_rects:
            if regen_colors:
                c1 = cgen.rand_color()
                c2 = cgen.rand_color()
            if use_rect:
                _fill_rect(img, rect, c1)
            else:
                _draw_ellipse(img, rect, c1, c2)

    def paint_rect_resource(self, img, rect, num_recurse: int, blotch_scale: int) -> None:
        cgen = _ColorGen(self.rg)
        cgen.roll()
        bgcolor = cgen.rand_color()
        _fill_rect(img, rect, bgcolor)
        scale = 0.3 + 0.7 * float(self.rg.rand01())
        max_rand_dim = 0.5 * scale
        min_rand_dim = 0.05 * scale
        num_blotches = self.rg.randint(blotch_scale, 2 * blotch_scale)
        p_recurse = float(self.rg.rand01()) * 0.75
        for _ in range(num_blotches):
            dst3 = self.choose_sub_rect(rect, min_rand_dim, max_rand_dim)
            # short-circuit preserved: no rand01 draw when num_recurse == 0
            if num_recurse > 0 and float(self.rg.rand01()) < p_recurse:
                self.paint_rect_resource(img, dst3, num_recurse - 1, 10)
            else:
                self.paint_shape(img, dst3, cgen)
        _fill_rect(img, rect, bgcolor + (200,))

    def paint_shape_resource(self, img, rect) -> None:
        cgen = _ColorGen(self.rg)
        cgen.roll()
        horizontal_first = _randbool(self.rg)
        nbar1 = self.rg.randn(3) // 2 + 1
        nbar2 = self.rg.randn(3) // 2 + 1
        _clear_rect(img, rect)
        for _ in range(nbar1):
            self.paint_shape(img, self.create_bar(rect, horizontal_first), cgen)
        for _ in range(nbar2):
            self.paint_shape(img, self.create_bar(rect, not horizontal_first), cgen)
        num_blotches = self.rg.randint(1, 5)
        for _ in range(num_blotches):
            self.paint_shape(img, self.choose_sub_rect(rect, 0.1, 0.6), cgen)

    def generate_resource(
        self, img: np.ndarray, num_recurse: int = 1, blotch_scale: int = 50,
        is_rect: bool = True,
    ) -> np.ndarray:
        rect = (0.0, 0.0, float(img.shape[1]), float(img.shape[0]))
        if is_rect:
            self.paint_rect_resource(img, rect, num_recurse, blotch_scale)
        else:
            self.paint_shape_resource(img, rect)
        return img


def generated_sprite(fixed_asset_seed: int, type_: int, is_block: bool) -> np.ndarray:
    """64x64 ARGB sprite for ``use_generated_assets`` -- the exact seeding of
    initialize_asset_if_necessary (bag.cpp:100-110): asset_rand_gen seeded
    with fixed_asset_seed + type, generate_resource(img, 0, 5, block)."""
    rg = HostMT((fixed_asset_seed + type_) & 0xFFFFFFFF)
    img = np.zeros((64, 64, 4), np.uint8)
    AssetGen(rg).generate_resource(img, 0, 5, is_block)
    return img


def generated_background(seed: int) -> np.ndarray:
    """500x500 opaque procgen background (bag.cpp:62-63, 769-773).

    The reference paints this at every reset from the level rand_gen; here a
    pool is pregenerated from dedicated seeds and selected per level, so the
    level RNG stream stays unchanged (trajectories under
    ``use_generated_assets`` are NOT reference-exact -- the reference cannot
    serialize that mode either, bag.cpp:1176)."""
    rg = HostMT(seed & 0xFFFFFFFF)
    img = np.zeros((500, 500, 4), np.uint8)
    img[..., 3] = 255
    AssetGen(rg).generate_resource(img)
    out = img[..., :3].copy()
    return out
