"""Batched 64x64 renderer (counterpart of ``procgen_tpu/render/fast2.py``).

The JAX package samples every table with one-hot matmuls because gathers are
slow on a TPU.  Each of those products has exactly one nonzero term, so
direct indexing picks the same values bit for bit; this port indexes.  The
sprite compositor is a hand-written CUDA kernel
(procgen_torch/render/compositor.py).

Render classes covered: static-grid games (maze's bg + grid baked per
level, entities composited per step), grid-dynamic games (miner, chaser: bg
baked per level, grid drawn per step between two composites, colour-rect
cells), center-agent views (coinrun, ninja, jumper, maze and miner memory),
screen-space HUD overlays drawn after the sprites (ninja's charge bar,
jumper's compass, plunder's bars) and a background that scrolls every step
(starpilot's, drawn from the cached 64x64 mip by ``dynamic_bg_pass``).
"""

from __future__ import annotations

import numpy as np
import torch

from procgen_torch.fmath import div_const, f32
from procgen_torch.render import compositor
from procgen_torch.render.renderer import (
    _CELL_DIV,
    RENDER_EPS,
    RES,
    _paint_hud,
    _paint_vel_info,
    _pixel_world_coords,
    to_frames,
)
from procgen_torch.state import F32, I32

TWO_PI = float(2 * np.pi)

# entity record layout (fast2._RF of the reference package)
_RF = dict(
    bbx0=0, bby0=1, bbw=2, bbh=3, var=4, refl=5, alpha=6, ok=7,
    n_th=8, n_tv=9, z=10,
)
_NF = len(_RF)


# ---------------------------------------------------------------------------
# Device-side tables (built once per (game, cfg, pack, device))
# ---------------------------------------------------------------------------


class FrameTables:
    """Device copies of the pack's render tables, plus host constants."""

    def __init__(self, gd, cfg, pack, device):
        dev = torch.device(device)
        self.A = pack.rot_bins
        self.R = pack.sprite_res
        # (NV, R, R, 4) uint8 variant atlas, read directly by the compositor
        self.var_mips = torch.as_tensor(np.ascontiguousarray(pack.var_mips)).to(dev)
        self.NV = int(pack.var_mips.shape[0])
        # rotation-bin cos/sin lookup (A, 2); axis bins exact
        a = np.arange(self.A)
        ang = 2 * np.pi * a / self.A
        cs = np.stack([np.cos(ang), np.sin(ang)], -1)
        cs[np.abs(cs) < 1e-9] = 0.0
        cs[np.abs(cs - 1) < 1e-9] = 1.0
        cs[np.abs(cs + 1) < 1e-9] = -1.0
        self.bin_cs = torch.as_tensor(cs.astype(np.float32)).to(dev)
        # entity image-type -> base slot (theme-consecutive, pack order)
        self.ent_types = np.asarray(pack.ent_types, np.int32)
        self.ent_bases = np.asarray(pack.ent_bases, np.float32)
        # grid cell classes
        self.gtypes = np.asarray(pack.grid_class_types, np.int32)
        self.gbases = torch.as_tensor(np.asarray(pack.grid_class_bases, np.float32)).to(dev)
        self.gthemed = torch.as_tensor(np.asarray(pack.grid_class_themed, bool)).to(dev)
        self.K = int(pack.grid_class_types.shape[0])
        # colour-rect cell classes (draw_grid_obj overrides, e.g. chaser's
        # orbs): type, centred square's cell fraction, RGB
        crl = gd.grid_color_rect_lut(cfg)
        dim_lut, rgb_lut = (
            (np.zeros((0,), np.float32), np.zeros((0, 3), np.float32))
            if crl is None else (np.asarray(a) for a in crl)
        )
        ts = np.nonzero(dim_lut > 0)[0]
        self.crect_types = ts.astype(np.int32)
        self.crect_dims = dim_lut[ts].astype(np.float32)
        self.crect_rgb = torch.as_tensor(rgb_lut[ts].astype(np.float32)).to(dev)
        # backgrounds at fixed 64x64 (nearest mip of the full image)
        self.bg_mip = torch.as_tensor(pack.bg_mip64).to(dev)  # (NB, 64, 64, 3) u8
        self.bg_dims = torch.as_tensor(np.asarray(pack.bg_dims, np.float32)).to(dev)
        self.NB = int(pack.bg_mip64.shape[0])


def get_tables(gd, cfg, pack, device) -> FrameTables:
    cache = pack.__dict__.setdefault("_frame_tables", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = FrameTables(gd, cfg, pack, device)
    return cache[key]


def _sample(atlas: torch.Tensor, ids, sv, su, valid=None):
    """Texels ``atlas[ids[n], sv[n, y], su[n, x]]`` as float32 (N, 64, 64, C)
    for an (M, R, R, C) uint8 atlas; ``valid`` (N,) zeroes envs whose id
    matches no atlas entry (the one-hot product's empty row)."""
    M, R, _, C = atlas.shape
    flat = atlas.reshape(M * R * R, C)
    ids = ids.to(torch.int64).clamp(0, M - 1)
    idx = (ids[:, None, None] * R + sv[:, :, None].to(torch.int64)) * R + su[
        :, None, :
    ].to(torch.int64)
    tex = flat[idx].to(F32)
    if valid is not None:
        tex = torch.where(valid[:, None, None, None], tex, 0.0)
    return tex


def _exact_id(v: torch.Tensor, n: int):
    """(int id, valid) for float ids: valid where v is an integer in [0, n)."""
    i = v.to(torch.int64)
    return i, (i.to(F32) == v) & (i >= 0) & (i < n)


# ---------------------------------------------------------------------------
# Background passes
# ---------------------------------------------------------------------------


def _select_bg(tables, background_index):
    """Per-env 64x64 background mip as float32 (N, 64, 64, 3)."""
    return tables.bg_mip[background_index.to(torch.int64)].to(F32)


def bg_pass(gd, cfg, states, tables, bm_f32):
    """Background blit (bag.cpp:979-1007), sampled from the per-env 64x64
    mip ``bm_f32``.  Returns an f32 (N, 64, 64, 3) canvas, black outside the
    background rect."""
    N = states.num_envs
    dev = bm_f32.device
    if not cfg.use_backgrounds:
        return torch.zeros((N, RES, RES, 3), dtype=F32, device=dev)
    px = (torch.arange(RES, dtype=F32, device=dev) + 0.5)[None, :]
    mw = states.main_width.to(F32)
    mh = states.main_height.to(F32)
    unit, view_dim = states.unit, states.view_dim
    m_x0 = -states.x_off
    m_y0 = (view_dim - mh) * unit + states.y_off
    m_w = mw * unit
    m_h = mh * unit
    if gd.bg_tile_ratio < 0:
        n_t = torch.clamp(
            (m_h / (m_w * f32(-gd.bg_tile_ratio))).to(I32), min=1
        ).to(F32)
        u = (px - m_x0[:, None]) / m_w[:, None]
        vraw = (px - m_y0[:, None]) / (m_h / n_t)[:, None]
        v = vraw - torch.floor(vraw)
        in_x = (u >= 0) & (u < 1)
        in_y = (px >= m_y0[:, None]) & (px < (m_y0 + m_h)[:, None])
    else:
        dims = tables.bg_dims[states.background_index.to(torch.int64)]
        bg_ar = dims[:, 0] / dims[:, 1]
        world_ar = mw / mh
        offset_x = states.bg_pct_x * (bg_ar - world_ar)
        bx0 = m_x0 + m_w * (-offset_x)
        bw = m_w * (bg_ar / world_ar)
        u = (px - bx0[:, None]) / bw[:, None]
        v = (px - m_y0[:, None]) / m_h[:, None]
        in_x = (u >= 0) & (u < 1)
        in_y = (v >= 0) & (v < 1)
    su = (u * RES).to(I32).clamp(0, RES - 1).to(torch.int64)
    sv = (v * RES).to(I32).clamp(0, RES - 1).to(torch.int64)
    n = torch.arange(N, device=dev)[:, None, None]
    out = bm_f32[n, sv[:, :, None], su[:, None, :]]  # (N, 64, 64, 3)
    inside = in_y[:, :, None] & in_x[:, None, :]
    return torch.where(inside[..., None], out, 0.0)


def dynamic_bg_pass(gd, cfg, states, tables):
    """The scrolling background (starpilot.cpp:110-127), a horizontally
    tiled blit of the cached 64x64 background mip (``static_layer``) with
    the game's ``dynamic_bg_rect``.  The blit is separable: each row reads
    one mip row, each column one mip column.  The reference package draws
    it as two one-hot bf16 products whose operands are integers 0-255
    (exact in bf16); the gathers here pick the same values.  The divisions
    are tensor by tensor, so IEEE on the card too."""
    N = states.num_envs
    bm = states.static_layer
    if not cfg.use_backgrounds:
        return torch.zeros((N, RES, RES, 3), dtype=F32, device=bm.device)
    px = (torch.arange(RES, dtype=F32, device=bm.device) + 0.5)[None, :]
    x0, tile_w, w_total, y0, h = (v[:, None] for v in gd.dynamic_bg_rect(cfg, states))
    u_raw = (px - x0) / tile_w
    u = u_raw - torch.floor(u_raw)
    v = (px - y0) / h
    in_x = (px >= x0) & (px < x0 + w_total)
    in_y = (v >= 0) & (v < 1)
    su = (u * RES).to(I32).clamp(0, RES - 1).to(torch.int64)
    sv = (v * RES).to(I32).clamp(0, RES - 1).to(torch.int64)
    n = torch.arange(N, device=bm.device)[:, None, None]
    out = bm[n, sv[:, :, None], su[:, None, :]].to(F32)  # (N, 64, 64, 3)
    inside = in_y[:, :, None] & in_x[:, None, :]
    return torch.where(inside[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# Grid pass
# ---------------------------------------------------------------------------


def _pixel_cells(states):
    """Per-pixel world cell indices + within-cell texel coords (all (N, 64),
    separable by axis)."""
    _, _, wx, wy = _pixel_world_coords(states)
    wx, wy = wx[:, 0, :], wy[:, :, 0]
    cxi = torch.floor(wx + RENDER_EPS).to(I32)
    cyi = torch.floor(wy + RENDER_EPS).to(I32)
    cu = div_const(wx - (cxi.to(F32) - RENDER_EPS), _CELL_DIV)
    cv = div_const((cyi.to(F32) + 1 + RENDER_EPS) - wy, _CELL_DIV)
    return cxi, cyi, cu, cv


def grid_pass(gd, cfg, states, tables, canvas):
    """Grid tiles (bag.cpp:941-955) blended over ``canvas``: grid -> per-game
    class codes -> per-pixel codes -> the K class textures, then the
    colour-rect cells."""
    K = tables.K
    n_crect = len(tables.crect_types)
    if K == 0 and n_crect == 0:
        return canvas
    N = states.num_envs
    R, A = tables.R, tables.A
    dev = canvas.device
    grid = states.grid
    Hm, Wm = grid.shape[1], grid.shape[2]
    cxi, cyi, cu, cv = _pixel_cells(states)
    in_cx = (cxi >= 0) & (cxi < states.main_width[:, None])
    in_cy = (cyi >= 0) & (cyi < states.main_height[:, None])

    # class codes, 0 = draw nothing
    code = torch.zeros_like(grid)
    for j in range(K):
        code = torch.where(grid == int(tables.gtypes[j]), j + 1, code)
    for j in range(n_crect):
        code = torch.where(grid == int(tables.crect_types[j]), K + 1 + j, code)
    n = torch.arange(N, device=dev)[:, None, None]
    code_pix = code[
        n,
        cyi.clamp(0, Hm - 1).to(torch.int64)[:, :, None],
        cxi.clamp(0, Wm - 1).to(torch.int64)[:, None, :],
    ]
    in_grid_pix = in_cy[:, :, None] & in_cx[:, None, :]
    code_pix = torch.where(in_grid_pix, code_pix, 0)

    if gd.center_agent(cfg):
        # moving-view window + out-of-bounds cells (bag.cpp:928-939)
        margin = states.visibility / 2 + 1
        low_x = (states.center_x - margin).to(I32)[:, None]
        high_x = (states.center_x + margin).to(I32)[:, None]
        low_y = (states.center_y - margin).to(I32)[:, None]
        high_y = (states.center_y + margin).to(I32)[:, None]
        in_wx = (cxi >= low_x) & (cxi <= high_x)
        in_wy = (cyi >= low_y) & (cyi <= high_y)
        in_window = in_wy[:, :, None] & in_wx[:, None, :]
        oob_code = torch.zeros_like(states.out_of_bounds_object)
        for j in range(K):
            oob_code = torch.where(
                states.out_of_bounds_object == int(tables.gtypes[j]), j + 1, oob_code
            )
        code_pix = torch.where(
            in_window & ~in_grid_pix, oob_code[:, None, None], code_pix
        )
        code_pix = torch.where(in_window, code_pix, 0)

    # per-env class slots (themed classes take the env's dynamic theme)
    theme = gd.grid_theme_state(cfg, states)
    theme_b = (
        theme.to(F32) if theme is not None
        else torch.zeros((N,), dtype=F32, device=dev)
    )
    slots = tables.gbases[None, :] + torch.where(
        tables.gthemed[None, :], theme_b[:, None], 0.0
    )  # (N, K) float slot ids; variant bin 0
    var_ids, var_ok = _exact_id(slots * A, tables.NV)

    tsu = (torch.clamp(cu, 0.0, 0.9999) * R).to(I32).clamp(0, R - 1)
    tsv = (torch.clamp(cv, 0.0, 0.9999) * R).to(I32).clamp(0, R - 1)
    for k in range(K):
        spr = _sample(tables.var_mips, var_ids[:, k], tsv, tsu, var_ok[:, k])
        m = code_pix == (k + 1)
        a = div_const(spr[..., 3], 255.0) * m
        canvas = spr[..., :3] * a[..., None] + canvas * (1 - a[..., None])

    # colour-rect cells: a centred square of the cell in a flat colour
    for j in range(n_crect):
        d = float(tables.crect_dims[j])
        lo, hi = f32((1 - d) / 2), f32((1 + d) / 2)
        inside = (
            (code_pix == K + 1 + j)
            & ((cu >= lo) & (cu < hi))[:, None, :]
            & ((cv >= lo) & (cv < hi))[:, :, None]
        )
        canvas = torch.where(inside[..., None], tables.crect_rgb[j], canvas)
    return canvas


# ---------------------------------------------------------------------------
# Entity records
# ---------------------------------------------------------------------------


def entity_records(gd, cfg, states, tables):
    """Per-entity draw records (N, E, 11) float32 in the ``_RF`` layout,
    sorted by render_z (drawable z -1/0/1 first, skipped slots last, slot
    order within a bucket: bag.cpp:957-958, 1060-1066), plus ``kmax``, the
    largest drawable count over envs (0-d int32 tensor)."""
    ents = states.ents
    N, E = ents.x.shape
    A = tables.A
    dev = ents.x.device

    dm = gd.entity_draw_mask(cfg, states)
    draw_mask = dm if dm is not None else torch.ones((N, E), dtype=torch.bool, device=dev)
    io = gd.entity_image_override(cfg, states)
    img_t = io if io is not None else ents.image_type

    # screen rect (get_object_rect, bag.cpp:811-817)
    unit = states.unit[:, None]
    view_dim = states.view_dim[:, None]
    x_off = states.x_off[:, None]
    y_off = states.y_off[:, None]
    abs_c = ents.use_abs_coords
    r_x0 = torch.where(
        abs_c, view_dim * (ents.x - ents.rx) * unit, (ents.x - ents.rx) * unit - x_off
    )
    r_y0 = torch.where(
        abs_c,
        view_dim * (ents.y + ents.ry) * unit,
        (view_dim - (ents.y + ents.ry)) * unit + y_off,
    )
    r_w = torch.where(abs_c, 2 * view_dim * ents.rx * unit, 2 * ents.rx * unit)
    r_h = torch.where(abs_c, 2 * view_dim * ents.ry * unit, 2 * ents.ry * unit)

    # monochrome fills paint the unadjusted base rect at full opacity with
    # no tiling (draw_image short-circuits to draw_grid_obj, bag.cpp:884-886)
    mono = cfg.use_monochrome_assets
    adj = None if mono else gd.image_rect_adjust(img_t)
    if adj is not None:
        aox, aoy, asw, ash = adj
        r_x0 = r_x0 + r_w * aox
        r_y0 = r_y0 + r_h * aoy
        r_w = r_w * asw
        r_h = r_h * ash

    # slot resolution: image types -> theme-0 base slot
    base = torch.full((N, E), -1.0, dtype=F32, device=dev)
    for t, b in zip(tables.ent_types, tables.ent_bases):
        base = torch.where(img_t == int(t), float(b), base)
    slot = base + ents.image_theme.to(F32)

    # rotation bin; reflected draws use the mirrored bin (A - a) % A
    if A > 1:
        bin_ = torch.remainder(
            torch.round(ents.rotation * f32(A / TWO_PI)).to(I32), A
        )
    else:
        bin_ = torch.zeros((N, E), dtype=I32, device=dev)
    bin_eff = torch.where(ents.is_reflected & (A > 1), (A - bin_) % A, bin_)
    cs = tables.bin_cs[bin_.to(torch.int64)]
    c, s = cs[..., 0], cs[..., 1]
    bbw = torch.abs(c) * r_w + torch.abs(s) * r_h
    bbh = torch.abs(s) * r_w + torch.abs(c) * r_h
    bbx0 = r_x0 + r_w / 2 - bbw / 2
    bby0 = r_y0 + r_h / 2 - bbh / 2

    # tiling (tile_image, bag.cpp:840-869; unrotated draws only)
    ratio = None if mono else gd.tile_ratio_for(img_t, ents.rx, ents.ry)
    n_th = torch.ones((N, E), dtype=F32, device=dev)
    n_tv = torch.ones((N, E), dtype=F32, device=dev)
    if ratio is not None:
        unrot = bin_ == 0
        n_th = torch.where(
            unrot & (ratio > 0),
            torch.clamp((r_w / (r_h * torch.abs(ratio) + f32(1e-9))).to(I32), min=1).to(F32),
            1.0,
        )
        n_tv = torch.where(
            unrot & (ratio < 0),
            torch.clamp((r_h / (r_w * torch.abs(ratio) + f32(1e-9))).to(I32), min=1).to(F32),
            1.0,
        )

    ok = ents.alive & draw_mask & (base >= 0)
    var = slot * A + bin_eff.to(F32)
    alpha = torch.ones_like(ents.alpha) if mono else ents.alpha
    refl = torch.zeros((N, E), dtype=F32, device=dev) if mono else ents.is_reflected.to(F32)

    rec = torch.stack(
        [
            bbx0, bby0, torch.clamp(bbw, min=f32(1e-6)), torch.clamp(bbh, min=f32(1e-6)),
            var, refl, alpha, ok.to(F32), n_th, n_tv, ents.render_z.to(F32),
        ],
        dim=-1,
    )  # (N, E, F)

    # 4-bucket counting sort: z -1/0/1 -> 0/1/2 for drawable, 3 for skipped;
    # a stable sort on the bucket gives the same rank
    bucket = torch.where(ok, torch.clamp(ents.render_z, -1, 1) + 1, 3)
    order = torch.sort(bucket, dim=1, stable=True).indices
    sorted_rec = torch.gather(rec, 1, order[..., None].expand(N, E, _NF))
    kmax = ok.to(I32).sum(1).max()
    return sorted_rec, kmax


def _pad_records(records):
    """Append a zero (ok=0) record, as the reference package's chunked draw
    loop does."""
    N, E, F = records.shape
    return torch.cat([records, records.new_zeros((N, 1, F))], 1)


# ---------------------------------------------------------------------------
# Frame + static entry points
# ---------------------------------------------------------------------------


def base_canvas(gd, cfg, states, tables) -> torch.Tensor:
    """The f32 canvas under a frame's first sprite composite: the scrolling
    background; for a moving view the background and, unless the game is
    grid-dynamic (its grid goes between two composites), the grid, drawn
    from the cached 64x64 background mip; else the baked static layer."""
    if gd.dynamic_background(cfg):
        return dynamic_bg_pass(gd, cfg, states, tables)
    canvas = states.static_layer.to(F32)
    if gd.center_agent(cfg):
        canvas = bg_pass(gd, cfg, states, tables, canvas)
        if not gd.grid_dynamic:
            canvas = grid_pass(gd, cfg, states, tables, canvas)
    return canvas


def render_frames2(gd, cfg, states, pack) -> torch.Tensor:
    """Per-step batched frames -> (N, 64, 64, 3) uint8.  The sprite
    composite runs the CUDA kernel for CUDA tensors: once per frame, or
    twice for grid-dynamic games, whose grid is drawn between the entities
    under it (z < 0) and the rest (fast2.py:670-680 of the reference
    package), then the velocity patch and the HUD."""
    tables = get_tables(gd, cfg, pack, states.done.device)
    canvas = base_canvas(gd, cfg, states, tables)
    records, kmax = entity_records(gd, cfg, states, tables)
    records = _pad_records(records)
    if gd.grid_dynamic:
        canvas = compositor.composite_entities(tables, records, kmax, canvas, "neg")
        canvas = grid_pass(gd, cfg, states, tables, canvas)
        canvas = compositor.composite_entities(tables, records, kmax, canvas, "nonneg")
    else:
        canvas = compositor.composite_entities(tables, records, kmax, canvas)
    canvas = _paint_vel_info(gd, cfg, states, canvas)
    canvas = _paint_hud(gd, cfg, states, canvas)
    return to_frames(canvas)


def render_static2(gd, cfg, states, pack) -> torch.Tensor:
    """Per-level static layer (batched) -> (N, 64, 64, 3) uint8: static-grid
    games bake bg + grid, grid-dynamic games the bg only; center-agent views
    and scrolling backgrounds cache the selected bg mip."""
    tables = get_tables(gd, cfg, pack, states.done.device)
    bm = _select_bg(tables, states.background_index)
    if gd.center_agent(cfg) or gd.dynamic_background(cfg):
        return to_frames(bm)
    canvas = bg_pass(gd, cfg, states, tables, bm)
    if not gd.grid_dynamic:
        canvas = grid_pass(gd, cfg, states, tables, canvas)
    return to_frames(canvas)
