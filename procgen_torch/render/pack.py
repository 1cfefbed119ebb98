"""Per-game texture atlases built on the host (counterpart of
``procgen_tpu/render/pack.py``).

The reference resolves (type, theme) -> QImage through asset_for_type and a
lazy cache (bag.cpp:79-123).  Here each game declares its asset map once and
every sprite is painted into a fixed-slot atlas with dense lookup tables.

Sprites come from the PNG asset root (``render/assets.py``, the default)
or from the generated-asset painter (``use_generated_assets``); either may
be replaced by monochrome tiles (``use_monochrome_assets``).
"""

from __future__ import annotations

import numpy as np

from procgen_torch import objects as O
from procgen_torch.render import assets

GRID_TYPE_LUT_SIZE = 1104  # covers all grid object ids incl. chaser's 1002

# Size of the pregenerated procgen-background pool under
# use_generated_assets (the reference repaints one 500x500 image per reset,
# bag.cpp:769-773; a pool keeps level resets on the device).
PROCGEN_BG_POOL = 16
_BG_POOL_SALT = 0x5EED_B6


def color_for_type(type_: int, theme: int) -> tuple[int, int, int]:
    """Monochrome color hash (bag.cpp:455-481): k=4 color cube, primes
    29/19 avoid type/theme collisions."""
    k = 4
    kcubed = k * k * k
    chunk = 256 // k
    assert type_ < kcubed, type_
    new_type = (29 * (type_ + 1)) % kcubed
    new_type = (new_type + 19 * theme) % kcubed
    return (
        chunk * (new_type // (k * k) + 1) - 1,
        chunk * ((new_type // k) % k + 1) - 1,
        chunk * (new_type % k + 1) - 1,
    )


def _monochrome_tile(gd, cfg, type_: int, theme: int) -> np.ndarray:
    if cfg.restrict_themes and not gd.should_preserve_type_themes(type_):
        theme = 0  # mask_theme_if_necessary inside color_for_type (bag.cpp:459)
    r, g, b = color_for_type(type_, theme)
    tile = np.zeros((8, 8, 4), np.uint8)
    tile[..., 0], tile[..., 1], tile[..., 2], tile[..., 3] = r, g, b, 255
    return tile


class RenderPack:
    """Static render data for one (game, config) pair, as numpy arrays.
    The renderer keeps device copies (render/fast2.get_tables)."""

    def __init__(self, gd, cfg):
        amap = gd.asset_map(cfg)
        names: list[str] = []
        types_of_slot: list[int] = []
        themes_of_slot: list[int] = []
        slot_lut = np.full((O.MAX_ASSETS, O.MAX_IMAGE_THEMES), -1, np.int32)
        num_themes = np.zeros((O.MAX_ASSETS,), np.int32)
        for type_, theme_names in amap.items():
            assert 0 <= type_ < O.MAX_ASSETS, type_
            num_themes[type_] = len(theme_names)
            for theme, name in enumerate(theme_names):
                # restrict_themes masks non-preserved types to theme 0 at
                # asset-lookup time (mask_theme_if_necessary, bag.cpp:450-453,
                # applied in initialize_asset_if_necessary, bag.cpp:86):
                # every theme slot packs theme 0's image
                if cfg.restrict_themes and not gd.should_preserve_type_themes(type_):
                    name = theme_names[0]
                slot_lut[type_, theme] = len(names)
                names.append(name)
                types_of_slot.append(type_)
                themes_of_slot.append(theme)

        fas = cfg.effective_fixed_asset_seed
        if cfg.use_generated_assets:
            # AssetGen procedural sprites (bag.cpp:93-110): every type paints
            # one 64x64 texture from fixed_asset_seed + type; all themes map
            # to it
            from procgen_torch.render.assetgen import generated_sprite

            by_type = {
                t: generated_sprite(fas, t, gd.use_block_asset(t))
                for t in sorted(set(types_of_slot))
            }
            imgs = [by_type[t] for t in types_of_slot]
        else:
            imgs = [assets.decode_png(n) for n in names]
        if cfg.use_monochrome_assets:
            # color_for_type hash fills replace every sprite draw
            # (bag.cpp:884-918, 455-481)
            imgs = [
                _monochrome_tile(gd, cfg, t, th)
                for t, th in zip(types_of_slot, themes_of_slot)
            ]
        if imgs:
            S_h = max(i.shape[0] for i in imgs)
            S_w = max(i.shape[1] for i in imgs)
        else:
            S_h = S_w = 1
        atlas = np.zeros((max(len(imgs), 1), S_h, S_w, 4), np.uint8)
        dims = np.ones((max(len(imgs), 1), 2), np.int32)
        for k, img in enumerate(imgs):
            h, w = img.shape[:2]
            atlas[k, :h, :w] = img
            dims[k] = (w, h)

        self.atlas = atlas
        self.dims = dims  # (slot, [w, h])
        self.slot_lut = slot_lut
        self.num_themes = num_themes

        if cfg.use_generated_assets:
            from procgen_torch.render.assetgen import generated_background

            bgs = [
                generated_background(fas + _BG_POOL_SALT + i)
                for i in range(PROCGEN_BG_POOL)
            ]
        else:
            bgs = [assets.decode_png(n) for n in assets.BACKGROUND_GROUPS[gd.background_group]]
        BH = max(b.shape[0] for b in bgs)
        BW = max(b.shape[1] for b in bgs)
        bg_atlas = np.zeros((len(bgs), BH, BW, 3), np.uint8)
        bg_dims = np.ones((len(bgs), 2), np.int32)
        for k, b in enumerate(bgs):
            h, w = b.shape[:2]
            # backgrounds load as Format_RGB32: alpha dropped (resources.cpp)
            bg_atlas[k, :h, :w] = b[..., :3]
            bg_dims[k] = (w, h)
        self.bg_atlas = bg_atlas
        self.bg_dims = bg_dims

        # ---- fixed-res mip atlases for the sampling paths ----
        R = getattr(gd, "sprite_sample_res", 32)
        self.sprite_res = R
        self.sprite_mips = np.zeros((max(len(imgs), 1), R, R, 4), np.uint8)
        for k, img in enumerate(imgs):
            self.sprite_mips[k] = _nearest_resize(img, R, R)

        BR = getattr(gd, "bg_sample_res", 128)
        self.bg_res = BR
        self.bg_mips = np.zeros((len(bgs), BR, BR, 3), np.uint8)
        for k, b in enumerate(bgs):
            self.bg_mips[k] = _nearest_resize(b[..., :3], BR, BR)

        # grid-type render tables
        self.grid_image_lut = gd.grid_image_lut(cfg)  # (GRID_TYPE_LUT_SIZE,)
        self.grid_theme_lut = gd.grid_theme_lut(cfg)

        # composite per-cell-type lut: 0 = draw nothing, k >= 1 = sprite slot
        # k-1; row d applies the per-env dynamic theme d to the themed types
        themed = set(gd.grid_themed_types())
        n_themes = max(gd.grid_theme_count, 1)
        gsl = np.zeros((n_themes, GRID_TYPE_LUT_SIZE), np.int32)
        for d in range(n_themes):
            for t in range(GRID_TYPE_LUT_SIZE):
                img = int(self.grid_image_lut[t])
                theme = d if t in themed else int(self.grid_theme_lut[t])
                if t == O.SPACE or img < 0 or img >= O.MAX_ASSETS:
                    continue
                s = int(slot_lut[img, min(theme, O.MAX_IMAGE_THEMES - 1)])
                if s >= 0:
                    gsl[d, t] = s + 1
        self.grid_slot_lut_themed = gsl
        self.grid_slot_lut = gsl[0]
        mask = np.zeros((GRID_TYPE_LUT_SIZE,), bool)
        for t in themed:
            mask[t] = True
        self.grid_themed_mask = mask

        # rotation-variant atlas: each slot carries A prerendered rotation
        # bins; monochrome fills ignore painter rotation (bag.cpp:884-886)
        self.rot_bins = (
            1
            if cfg.use_monochrome_assets
            else {"none": 1, "axis": 4, "free": 16}[gd.entity_rotations]
        )
        self.var_mips = _make_rotation_variants(self.sprite_mips, self.rot_bins)

        # entity image-type -> theme-0 base slot (slot = base + image_theme)
        self.ent_types = np.asarray(sorted(amap.keys()), np.int32)
        self.ent_bases = np.asarray(
            [slot_lut[t, 0] for t in self.ent_types], np.float32
        )

        # grid cell classes: the cell types a grid can contain, each mapping
        # to a base slot (+ per-env theme when themed)
        explicit = gd.grid_cell_types(cfg)
        if explicit is not None:
            cand = [int(t) for t in explicit]
        else:
            cand = [
                int(t)
                for t in np.nonzero(gsl[0])[0]
                if int(self.grid_image_lut[t]) != O.PLAYER
            ]
        self.grid_class_types = np.asarray(cand, np.int32)
        self.grid_class_bases = np.asarray(
            [gsl[0, t] - 1 for t in cand], np.float32
        )
        self.grid_class_themed = np.asarray([bool(mask[t]) for t in cand], bool)

        # fixed-res bg mips for the batched bg pass
        self.bg_mip64 = np.zeros((len(bgs), 64, 64, 3), np.uint8)
        for k, b in enumerate(bgs):
            self.bg_mip64[k] = _nearest_resize(b[..., :3], 64, 64)


def _make_rotation_variants(mips: np.ndarray, A: int) -> np.ndarray:
    """(n, R, R, 4) -> (n * A, R, R, 4): bin a holds the sprite rotated by
    2*pi*a/A, prerendered into its rotated bounding box."""
    n, R = mips.shape[0], mips.shape[1]
    if A == 1:
        return mips.copy()
    out = np.zeros((n * A, R, R, 4), np.uint8)
    pu = (np.arange(R) + 0.5) / R - 0.5
    for a in range(A):
        th = 2 * np.pi * a / A
        c, s = np.cos(th), np.sin(th)
        if abs(c) < 1e-9:
            c = 0.0
        if abs(s) < 1e-9:
            s = 0.0
        c = round(c) if abs(c - round(c)) < 1e-9 else c
        s = round(s) if abs(s - round(s)) < 1e-9 else s
        f = abs(c) + abs(s)
        # u/v in sprite space for each variant texel (inverse painter rotate)
        U = c * f * pu[None, :] + s * f * pu[:, None] + 0.5  # (vy, vx)
        V = -s * f * pu[None, :] + c * f * pu[:, None] + 0.5
        su = np.floor(U * R).astype(np.int64)
        sv = np.floor(V * R).astype(np.int64)
        inside = (su >= 0) & (su < R) & (sv >= 0) & (sv < R)
        su_c = np.clip(su, 0, R - 1)
        sv_c = np.clip(sv, 0, R - 1)
        for k in range(n):
            img = mips[k][sv_c, su_c]
            img[~inside] = 0
            out[k * A + a] = img
    return out


def _nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = np.floor((np.arange(h) + 0.5) * img.shape[0] / h).astype(np.int64)
    xs = np.floor((np.arange(w) + 0.5) * img.shape[1] / w).astype(np.int64)
    return img[ys[:, None], xs[None, :]]


def default_grid_image_lut() -> np.ndarray:
    """image_for_type default: abs(type) (bag.cpp:438-440)."""
    return np.abs(np.arange(GRID_TYPE_LUT_SIZE, dtype=np.int32))


def default_grid_theme_lut() -> np.ndarray:
    return np.zeros((GRID_TYPE_LUT_SIZE,), np.int32)
