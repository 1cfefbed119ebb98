"""The direct gather renderer (counterpart of ``procgen_tpu/render/renderer.py``).

``update_view_params`` (prepare_for_drawing) runs on every step path.  The
rest is the single-pass renderer at any resolution: background, grid tiles
and entities sampled pixel by pixel from the full-resolution pack atlases
(``render_static_env``, ``render_env``), the path of the 512x512
``render_mode`` info frame (env.py).  The 64x64 observations come from
``render/fast2.py`` instead (fixed-size mips and the CUDA compositor).

Draw-order semantics follow bag.cpp:819-1012: background, grid cells
(x-major, RENDER_EPS overlap resolved toward the later-drawn cell), entities
by render_z in {-1, 0, 1} passes in slot order, the velocity-info patch,
the per-game HUD.  Every function takes a batch (leading env axis N); the
entity pass loops on the host over draw positions, as far as the batch's
largest live count.

Not ported: the reference package's matmul formulations
(``render_static_fast``, ``_grid_fast_one``, ``render_static_dispatch``,
``render_frames``, ``_composite_entities_matmul``,
``_paint_vel_info_batched``).  They compute the frames that fast2 computes
(ROADMAP A11).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch.engine import entity_ops as eo
from procgen_torch.state import F32, I32, EnvState

RES = 64
RENDER_EPS = fm.f32(0.02)  # bag.cpp:14
# "/ (1 + 2 * RENDER_EPS)" with the float32 constant of the reference package
_CELL_DIV = float(np.float32(1) + np.float32(2) * np.float32(RENDER_EPS))
_I64 = torch.int64


def update_view_params(gd, cfg, state: EnvState) -> EnvState:
    """prepare_for_drawing (bag.cpp:819-838) at rect_height = 64, batched."""
    mw = state.main_width.to(F32)
    mh = state.main_height.to(F32)
    if gd.center_agent(cfg):
        cx, cy, visibility = gd.choose_center(cfg, state)
    else:
        cx = mw * 0.5
        cy = mh * 0.5
        visibility = torch.maximum(torch.maximum(mw, mh), state.min_visibility)
    # raw_unit = 64 / visibility is a float division (bag.cpp:831)
    unit = fm.fdiv(cfg, 64.0, visibility)  # rect_height == 64
    # view_dim = 64.0 / raw_unit is a double division narrowed on assignment
    # (the 64.0 literal, bag.cpp:834)
    view_dim = fm.fdiv(cfg, 64.0, unit)
    x_off = unit * (cx - view_dim / 2)
    y_off = unit * (cy - view_dim / 2)
    return state.replace(
        center_x=cx, center_y=cy, visibility=visibility,
        unit=unit, view_dim=view_dim, x_off=x_off, y_off=y_off,
    )


def _pixel_world_coords(states: EnvState, res: int = RES):
    """Pixel centres of a res x res frame in 64-pixel units (so the view
    transform and the HUD rects do not depend on ``res``), (1, 1, res) and
    (1, res, 1), and their world coordinates, (N, 1, res) and (N, res, 1)."""
    dev = states.unit.device
    p = (torch.arange(res, dtype=F32, device=dev) + 0.5) * fm.f32(RES / res)
    SX, SY = p[None, None, :], p[None, :, None]
    unit = states.unit[:, None, None]
    wx = (SX + states.x_off[:, None, None]) / unit
    wy = states.view_dim[:, None, None] - (SY - states.y_off[:, None, None]) / unit
    return SX, SY, wx, wy


@functools.lru_cache(maxsize=None)
def rgb_constant(rgb: tuple, device) -> torch.Tensor:
    """A float32 RGB triple on ``device``, made once per device (a
    host-to-device copy synchronizes the stream)."""
    return torch.tensor(rgb, dtype=F32).to(device)


def to_frames(canvas: torch.Tensor) -> torch.Tensor:
    """f32 canvas -> uint8 frames, ``clip(x + 0.5, 0, 255)`` truncated."""
    return torch.clamp(canvas + 0.5, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# HUD overlays (shared with fast2)
# ---------------------------------------------------------------------------


def _paint_vel_info(gd, cfg, states, out):
    """bag.cpp:960-969, on a canvas of any resolution."""
    if not (gd.has_useful_vel_info and cfg.paint_vel_info):
        return out
    ents = states.ents
    res = out.shape[1]
    p = (torch.arange(res, dtype=F32, device=out.device) + 0.5) * fm.f32(RES / res)
    SX, SY = p[None, :], p[:, None]
    infodim = fm.f32(RES * 0.2)
    s1 = torch.clamp(
        ((0.5 * ents.vx[:, eo.AGENT] / states.maxspeed + 0.5) * 255).to(I32), 0, 255
    ).to(F32)
    s2 = torch.clamp(
        ((0.5 * ents.vy[:, eo.AGENT] / states.max_jump + 0.5) * 255).to(I32), 0, 255
    ).to(F32)
    in1 = ((SX < infodim) & (SY < infodim))[None, ..., None]
    in2 = ((SX >= infodim) & (SX < 2 * infodim) & (SY < infodim))[None, ..., None]
    out = torch.where(in1, s1[:, None, None, None], out)
    return torch.where(in2, s2[:, None, None, None], out)


def _paint_hud(gd, cfg, states, out):
    """Per-game screen-space overlays after the sprites (renderer.py:492-506
    of the reference package): the fillRects of ``hud_color_rects`` (world
    units times ``unit``, from the top-left), then ``hud_overlay``."""
    if not gd.has_hud(cfg):
        return out
    SX, SY, _, _ = _pixel_world_coords(states, out.shape[1])
    hud = gd.hud_color_rects(cfg, states)
    if hud is not None:
        rects, colors = hud
        unit = states.unit[:, None, None]
        for k, color in enumerate(colors):
            x0, y0, w, h = (rects[:, k, i][:, None, None] * unit for i in range(4))
            inside = (SX >= x0) & (SX < x0 + w) & (SY >= y0) & (SY < y0 + h)
            out = torch.where(inside[..., None], rgb_constant(tuple(color), out.device), out)
    return gd.hud_overlay(cfg, states, out, SX, SY)


# ---------------------------------------------------------------------------
# Device copies of the pack's full-resolution tables
# ---------------------------------------------------------------------------


class GatherTables:
    """The pack's atlases and lookup tables on one device."""

    def __init__(self, gd, cfg, pack, device):
        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        self.atlas = t(pack.atlas)  # (slots, H, W, 4) uint8
        self.dims = t(pack.dims)  # (slots, 2) [w, h]
        self.slot_lut = t(pack.slot_lut)  # (MAX_ASSETS, 10)
        self.bg_atlas = t(pack.bg_atlas)  # (NB, H, W, 3) uint8
        self.bg_dims = t(pack.bg_dims)
        self.grid_image_lut = t(pack.grid_image_lut)
        self.grid_theme_lut = t(pack.grid_theme_lut)
        self.grid_themed_mask = t(pack.grid_themed_mask)
        crl = gd.grid_color_rect_lut(cfg)
        self.crect = None if crl is None else (t(np.asarray(crl[0], np.float32)),
                                               t(np.asarray(crl[1], np.float32)))


def get_gather_tables(gd, cfg, pack, device) -> GatherTables:
    cache = pack.__dict__.setdefault("_gather_tables", {})
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = GatherTables(gd, cfg, pack, device)
    return cache[key]


def _sample_atlas(tables, slot, u, v, reflected):
    """Nearest gather from atlas[slot] at normalized (u, v); u flips when
    reflected (mirrored asset, bag.cpp:121-122).  ``slot`` and
    ``reflected`` broadcast against u (N, 1 or res, res) and v."""
    w = tables.dims[:, 0][slot]
    h = tables.dims[:, 1][slot]
    su = torch.minimum(torch.clamp((u * w.to(F32)).to(I32), min=0), w - 1)
    sv = torch.minimum(torch.clamp((v * h.to(F32)).to(I32), min=0), h - 1)
    su = torch.where(reflected, w - 1 - su, su)
    texel = tables.atlas[slot, sv.to(_I64), su.to(_I64)]
    rgb = texel[..., :3].to(F32)
    a = fm.div_const(texel[..., 3].to(F32), 255.0)
    return rgb, a


def _env(v):
    return v[:, None, None]


# ---------------------------------------------------------------------------
# Background and grid
# ---------------------------------------------------------------------------


def _bg_gather(gd, cfg, states, tables, out, SX, SY):
    """The background blit from the full image (bag.cpp:979-1007)."""
    mw = states.main_width.to(F32)
    mh = states.main_height.to(F32)
    unit, view_dim = states.unit, states.view_dim
    bgi = states.background_index.to(_I64)
    bgw_i, bgh_i = tables.bg_dims[bgi, 0], tables.bg_dims[bgi, 1]
    bgw, bgh = bgw_i.to(F32), bgh_i.to(F32)
    m_x0 = -states.x_off
    m_y0 = (view_dim - mh) * unit + states.y_off
    m_w = mw * unit
    m_h = mh * unit
    if gd.bg_tile_ratio < 0:
        # tile_image vertically over the main rect (bag.cpp:842-853)
        n_t = torch.clamp((m_h / (m_w * fm.f32(-gd.bg_tile_ratio))).to(I32), min=1).to(F32)
        u = (SX - _env(m_x0)) / _env(m_w)
        vraw = (SY - _env(m_y0)) / _env(m_h / n_t)
        v = vraw - torch.floor(vraw)
        inside = (u >= 0) & (u < 1) & (SY >= _env(m_y0)) & (SY < _env(m_y0 + m_h))
    else:
        bg_ar = bgw / bgh
        world_ar = mw / mh
        offset_x = states.bg_pct_x * (bg_ar - world_ar)
        bx0 = m_x0 + m_w * (-offset_x)
        bw = m_w * (bg_ar / world_ar)
        u = (SX - _env(bx0)) / _env(bw)
        v = (SY - _env(m_y0)) / _env(m_h)
        inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    su = torch.minimum(torch.clamp((u * _env(bgw)).to(I32), min=0), _env(bgw_i) - 1)
    sv = torch.minimum(torch.clamp((v * _env(bgh)).to(I32), min=0), _env(bgh_i) - 1)
    col = tables.bg_atlas[_env(bgi), sv.to(_I64), su.to(_I64)].to(F32)
    return torch.where(inside[..., None], col, out)


def _grid_cells(gd, cfg, states, tables, res):
    """Per-pixel grid cells (bag.cpp:921-955): clipped cell type, whether
    the cell is drawn at all, its sprite slot, whether that slot draws, and
    the within-cell coordinates (cu (N, 1, res), cv (N, res, 1))."""
    _, _, wx, wy = _pixel_world_coords(states, res)
    grid = states.grid
    N, Hm, Wm = grid.shape
    cxi = torch.floor(wx + RENDER_EPS).to(I32)  # (N, 1, res)
    cyi = torch.floor(wy + RENDER_EPS).to(I32)  # (N, res, 1)
    in_grid = ((cxi >= 0) & (cxi < _env(states.main_width))
               & (cyi >= 0) & (cyi < _env(states.main_height)))
    n = torch.arange(N, device=grid.device)[:, None, None]
    grid_at = grid[n, cyi.clamp(0, Hm - 1).to(_I64), cxi.clamp(0, Wm - 1).to(_I64)]
    if gd.center_agent(cfg):
        # cells outside the world render as out_of_bounds_object; the drawn
        # window is center +- (visibility/2 + 1) (bag.cpp:928-939)
        margin = states.visibility / 2 + 1
        low_x = _env((states.center_x - margin).to(I32))
        high_x = _env((states.center_x + margin).to(I32))
        low_y = _env((states.center_y - margin).to(I32))
        high_y = _env((states.center_y + margin).to(I32))
        in_window = (cxi >= low_x) & (cxi <= high_x) & (cyi >= low_y) & (cyi <= high_y)
        cell_type = torch.where(in_grid, grid_at, _env(states.out_of_bounds_object))
        cell_valid = in_window & (cell_type != O.INVALID_OBJ)
    else:
        cell_type = torch.where(in_grid, grid_at, O.INVALID_OBJ)
        cell_valid = in_grid & (cell_type != O.INVALID_OBJ)
    cell_type_c = cell_type.clamp(0, tables.grid_image_lut.shape[0] - 1).to(_I64)
    img_type = tables.grid_image_lut[cell_type_c]
    theme = tables.grid_theme_lut[cell_type_c]
    gts = gd.grid_theme_state(cfg, states)
    if gts is not None:
        theme = torch.where(tables.grid_themed_mask[cell_type_c], _env(gts).to(theme.dtype), theme)
    has_asset = (img_type >= 0) & (img_type < O.MAX_ASSETS)
    draw_cell = cell_valid & has_asset & (cell_type != O.SPACE)
    slot = tables.slot_lut[img_type.clamp(0, O.MAX_ASSETS - 1).to(_I64), theme.clamp(0, 9).to(_I64)]
    draw_cell = draw_cell & (slot >= 0)
    cu = fm.div_const(wx - (cxi.to(F32) - RENDER_EPS), _CELL_DIV)
    cv = fm.div_const((cyi.to(F32) + 1 + RENDER_EPS) - wy, _CELL_DIV)
    return cell_type_c, cell_valid, slot.clamp(min=0).to(_I64), draw_cell, cu, cv


def _blend_cells(tables, out, slot, draw_cell, cu, cv):
    rgb, a = _sample_atlas(tables, slot, torch.clamp(cu, 0.0, 0.9999),
                           torch.clamp(cv, 0.0, 0.9999), torch.zeros((), dtype=torch.bool,
                                                                     device=out.device))
    a = torch.where(draw_cell, a, 0.0)
    return rgb * a[..., None] + out * (1 - a[..., None])


def render_static_env(gd, cfg, states, pack, parts=("bg", "grid"), res: int = RES):
    """Background + grid layer of the current level -> (N, res, res, 3)
    uint8.  ``parts`` selects the passes (grid-dynamic games draw the bg
    only here)."""
    tables = get_gather_tables(gd, cfg, pack, states.done.device)
    SX, SY, _, _ = _pixel_world_coords(states, res)
    N = states.num_envs
    out = torch.zeros((N, res, res, 3), dtype=F32, device=states.done.device)  # bag.cpp:980
    if cfg.use_backgrounds and "bg" in parts:
        out = _bg_gather(gd, cfg, states, tables, out, SX, SY)
    if "grid" in parts:
        _, _, slot, draw_cell, cu, cv = _grid_cells(gd, cfg, states, tables, res)
        out = _blend_cells(tables, out, slot, draw_cell, cu, cv)
    return to_frames(out)


def render_grid_over(gd, cfg, states, pack, canvas, res: int = RES):
    """The grid pass blended over an f32 canvas (the direct path of
    grid-dynamic games)."""
    return _grid_pass_gather(gd, cfg, states, get_gather_tables(gd, cfg, pack, canvas.device),
                             canvas, res)


def _grid_pass_gather(gd, cfg, states, tables, out, res: int = RES):
    """Grid tiles over ``out``, then the colour-rect cells."""
    cell_type_c, cell_valid, slot, draw_cell, cu, cv = _grid_cells(gd, cfg, states, tables, res)
    out = _blend_cells(tables, out, slot, draw_cell, cu, cv)
    return _grid_color_rects(tables, cell_type_c, cell_valid, cu, cv, out)


def _grid_color_rects(tables, cell_type_c, cell_valid, cu, cv, out):
    """Per-game draw_grid_obj colour rects (e.g. chaser's orbs)."""
    if tables.crect is None:
        return out
    dim_lut, rgb_lut = tables.crect
    d = dim_lut[cell_type_c]
    lo = (1 - d) / 2
    hi = (1 + d) / 2
    inside = cell_valid & (d > 0) & (cu >= lo) & (cu < hi) & (cv >= lo) & (cv < hi)
    return torch.where(inside[..., None], rgb_lut[cell_type_c], out)


# ---------------------------------------------------------------------------
# Entities
# ---------------------------------------------------------------------------


def _entity_draw_order(ents):
    """render_z passes -1/0/1, slot-ascending within each (bag.cpp:957-958,
    1060-1066); dead slots sort last.  (N, E) slot indices."""
    E = ents.capacity
    slots = torch.arange(E, device=ents.x.device)
    key = torch.where(ents.alive, (ents.render_z.to(_I64) + 1) * E + slots, 10 * E + slots)
    return torch.argsort(key, dim=1)


def _entity_rect(states, e):
    """get_object_rect (bag.cpp:811-817) -> screen-space (x0, y0, w, h),
    (N,) each, for per-env entity fields ``e``."""
    unit, view_dim = states.unit, states.view_dim
    x, y, rx, ry = e["x"], e["y"], e["rx"], e["ry"]
    abs_c = e["use_abs_coords"]
    r_x0 = torch.where(abs_c, view_dim * (x - rx) * unit, (x - rx) * unit - states.x_off)
    r_y0 = torch.where(abs_c, view_dim * (y + ry) * unit,
                       (view_dim - (y + ry)) * unit + states.y_off)
    r_w = torch.where(abs_c, 2 * view_dim * rx * unit, 2 * rx * unit)
    r_h = torch.where(abs_c, 2 * view_dim * ry * unit, 2 * ry * unit)
    return r_x0, r_y0, r_w, r_h


_DRAW_FIELDS = ("x", "y", "rx", "ry", "use_abs_coords", "image_type", "image_theme",
                "render_z", "rotation", "is_reflected", "alpha", "alive")


def _composite_entities_gather(gd, cfg, states, tables, out, z_filter="all", res: int = RES):
    """Entities in draw order, each sampled per pixel (rotation, tiling,
    reflection, alpha).  The rotation's cos/sin are the double ``cos``/``sin``
    narrowed (``fmath.sincos64``), the same bits on the CPU and the card."""
    ents = states.ents
    order = _entity_draw_order(ents)
    kmax = int(ents.alive.sum(1).max())
    if kmax == 0:
        return out
    SX, SY, _, _ = _pixel_world_coords(states, res)
    draw_mask = gd.entity_draw_mask(cfg, states)
    img_override = gd.entity_image_override(cfg, states)
    mono = cfg.use_monochrome_assets
    for k in range(kmax):
        i = order[:, k:k + 1]
        e = {f: getattr(ents, f).gather(1, i)[:, 0] for f in _DRAW_FIELDS}
        ok = e["alive"]
        if draw_mask is not None:
            ok = ok & draw_mask.gather(1, i)[:, 0]
        if z_filter == "neg":
            ok = ok & (e["render_z"] < 0)
        elif z_filter == "nonneg":
            ok = ok & (e["render_z"] >= 0)
        r_x0, r_y0, r_w, r_h = _entity_rect(states, e)
        img_t = e["image_type"] if img_override is None else img_override.gather(1, i)[:, 0]
        e_slot = tables.slot_lut[img_t.clamp(0, O.MAX_ASSETS - 1).to(_I64),
                                 e["image_theme"].clamp(0, 9).to(_I64)]
        ok = ok & (img_t >= 0) & (img_t < O.MAX_ASSETS) & (e_slot >= 0)

        # monochrome: a solid fill of the unadjusted rect, no rotation,
        # tiling or opacity (draw_image -> draw_grid_obj, bag.cpp:884-886)
        adj = None if mono else gd.image_rect_adjust(img_t)
        if adj is not None:
            aox, aoy, asw, ash = adj
            r_x0 = r_x0 + r_w * aox
            r_y0 = r_y0 + r_h * aoy
            r_w = r_w * asw
            r_h = r_h * ash

        rot = torch.zeros_like(e["rotation"]) if mono else e["rotation"]
        cxp = _env(r_x0 + r_w / 2)
        cyp = _env(r_y0 + r_h / 2)
        dxp = SX - cxp
        dyp = SY - cyp
        sin_r, cos_r = (_env(t.to(F32)) for t in fm.sincos64(rot.to(torch.float64)))
        lx = cos_r * dxp + sin_r * dyp
        ly = -sin_r * dxp + cos_r * dyp
        u = (lx + _env(r_w / 2)) / _env(r_w)
        v = (ly + _env(r_h / 2)) / _env(r_h)
        inside = (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
        ratio = None if mono else gd.tile_ratio_for(img_t, e["rx"], e["ry"])
        if ratio is not None:
            eps = fm.f32(1e-9)
            n_th = torch.clamp(torch.where(
                ratio > 0, (r_w / (r_h * torch.abs(ratio) + eps)).to(I32), 1), min=1)
            n_tv = torch.clamp(torch.where(
                ratio < 0, (r_h / (r_w * torch.abs(ratio) + eps)).to(I32), 1), min=1)
            unrot = _env(rot == 0)
            uraw = u * _env(n_th.to(F32))
            u = torch.where(unrot & _env(ratio > 0), uraw - torch.floor(uraw), u)
            vraw = v * _env(n_tv.to(F32))
            v = torch.where(unrot & _env(ratio < 0), vraw - torch.floor(vraw), v)
        rgb, a = _sample_atlas(tables, _env(e_slot.clamp(min=0).to(_I64)),
                               torch.clamp(u, 0.0, 0.9999), torch.clamp(v, 0.0, 0.9999),
                               _env(e["is_reflected"]))
        if not mono:
            a = a * _env(e["alpha"])
        a = torch.where(inside & _env(ok), a, 0.0)
        out = rgb * a[..., None] + out * (1 - a[..., None])
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def render_env(gd, cfg, states, pack, res: int = RES) -> torch.Tensor:
    """Direct single-pass render -> (N, res, res, 3) uint8: 64 for an
    observation-sized frame, 1024 for the render_mode info frame (which the
    env box-filters to 512; vecgame.cpp:363-376 renders the large frame with
    antialiasing, this path with nearest sampling)."""
    tables = get_gather_tables(gd, cfg, pack, states.done.device)
    if gd.dynamic_background(cfg):
        # a background drawn per step (starpilot's scroll); no grid content
        SX, SY, _, _ = _pixel_world_coords(states, res)
        out = torch.zeros((states.num_envs, res, res, 3), dtype=F32, device=states.done.device)
        out = gd.paint_dynamic_background(cfg, states, out, SX, SY, tables)
        out = _composite_entities_gather(gd, cfg, states, tables, out, res=res)
    elif gd.grid_dynamic:
        out = render_static_env(gd, cfg, states, pack, parts=("bg",), res=res).to(F32)
        out = _composite_entities_gather(gd, cfg, states, tables, out, "neg", res=res)
        out = render_grid_over(gd, cfg, states, pack, out, res=res)
        out = _composite_entities_gather(gd, cfg, states, tables, out, "nonneg", res=res)
    else:
        out = render_static_env(gd, cfg, states, pack, res=res).to(F32)
        out = _composite_entities_gather(gd, cfg, states, tables, out, res=res)
    out = _paint_vel_info(gd, cfg, states, out)
    out = _paint_hud(gd, cfg, states, out)
    return to_frames(out)


def render_frame(gd, cfg, states, pack) -> torch.Tensor:
    """A 64x64 frame over the cached static layer; a moving view (whose
    static cache is invalid) takes the direct path.  The entities are drawn
    by the gather pass: the reference package's matmul pass is not ported
    (it draws unrotated, unadjusted sprites, which the gather pass covers)."""
    if gd.center_agent(cfg):
        return render_env(gd, cfg, states, pack)
    tables = get_gather_tables(gd, cfg, pack, states.done.device)
    out = states.static_layer.to(F32)
    out = _composite_entities_gather(gd, cfg, states, tables, out)
    out = _paint_vel_info(gd, cfg, states, out)
    out = _paint_hud(gd, cfg, states, out)
    return to_frames(out)
