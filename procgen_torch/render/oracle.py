"""Observation oracle: the readable specification of the 64x64 observation
(counterpart of ``procgen_tpu/render/oracle.py``).

``render/fast2.py`` draws observations from fixed-resolution sprite mips,
prerendered rotation bins and premultiplied-alpha blending, with the sprite
compositor as a CUDA kernel (``csrc/compositor.cu``).  This module states
the same frame record by record, with plain gathers: every float expression
mirrors the batched path, so ``fast2.render_frames2`` (and so the kernel)
and ``fast2.render_static2`` must reproduce ``oracle_obs`` and
``oracle_static`` bit for bit, on the CPU and on the card.  It shares no
code with fast2 or the compositor beyond the pack tables and the HUD
painters (render/renderer.py).

What it models (the reference's draw pass, bag.cpp:819-1007):
  * the world-to-screen transform and the main-rect background blit
    (bag.cpp:979-1007), with vertical background tiling (bag.cpp:842-853);
  * grid tiles with RENDER_EPS cell overlap, the center-agent moving window
    and out-of-bounds cells (bag.cpp:921-955, 928-939);
  * entities z-sorted into render_z passes {-1, 0, 1} in slot order
    (bag.cpp:957-958, 1060-1066), nearest-sampled with reflection, tiling
    (tile_image, bag.cpp:840-869) and alpha blending;
  * the velocity-info patch (bag.cpp:960-969) and the per-game HUD.

The deviations from the Qt rasterizer are those of every path: fixed-size
mips instead of the full PNGs, ``pack.rot_bins`` prerendered rotations, and
the static layer rounded to uint8 once per level.
"""

from __future__ import annotations

import torch

from procgen_torch import fmath as fm
from procgen_torch.render.fast2 import TWO_PI, get_tables
from procgen_torch.render.renderer import (
    _CELL_DIV,
    RENDER_EPS,
    RES,
    _paint_hud,
    _paint_vel_info,
    to_frames,
)
from procgen_torch.state import F32, I32

__all__ = ["oracle_obs", "oracle_static"]

_I64 = torch.int64


def _px(dev):
    return torch.arange(RES, dtype=F32, device=dev) + 0.5  # pixel centres


def _col(v):
    """(N,) -> (N, 1) against the (64,) pixel centres."""
    return v[:, None]


def _texels(img, n, sv, su):
    """``img[n, sv, su]`` for per-env row and column indices (N, 64) each:
    an (N, 64, 64, C) nearest gather."""
    return img[n[:, None, None], sv.to(_I64)[:, :, None], su.to(_I64)[:, None, :]]


# ---------------------------------------------------------------------------
# Background
# ---------------------------------------------------------------------------


def _bg(gd, cfg, states, tables, bm):
    """The background blit from each env's 64x64 mip ``bm`` (N, 64, 64, 3)
    f32 (bag.cpp:979-1007)."""
    N = states.num_envs
    if not cfg.use_backgrounds:
        return torch.zeros((N, RES, RES, 3), dtype=F32, device=bm.device)
    px = _px(bm.device)
    mw = states.main_width.to(F32)
    mh = states.main_height.to(F32)
    unit, view_dim = states.unit, states.view_dim
    m_x0 = -states.x_off
    m_y0 = (view_dim - mh) * unit + states.y_off
    m_w = mw * unit
    m_h = mh * unit
    if gd.bg_tile_ratio < 0:
        n_t = torch.clamp((m_h / (m_w * fm.f32(-gd.bg_tile_ratio))).to(I32), min=1).to(F32)
        u = (px - _col(m_x0)) / _col(m_w)
        vraw = (px - _col(m_y0)) / _col(m_h / n_t)
        v = vraw - torch.floor(vraw)
        in_x = (u >= 0) & (u < 1)
        in_y = (px >= _col(m_y0)) & (px < _col(m_y0 + m_h))
    else:
        bgd = tables.bg_dims[states.background_index.to(_I64)]
        bg_ar = bgd[:, 0] / bgd[:, 1]
        world_ar = mw / mh
        offset_x = states.bg_pct_x * (bg_ar - world_ar)
        bx0 = m_x0 + m_w * (-offset_x)
        bw = m_w * (bg_ar / world_ar)
        u = (px - _col(bx0)) / _col(bw)
        v = (px - _col(m_y0)) / _col(m_h)
        in_x = (u >= 0) & (u < 1)
        in_y = (v >= 0) & (v < 1)
    su = torch.clamp((u * RES).to(I32), 0, RES - 1)
    sv = torch.clamp((v * RES).to(I32), 0, RES - 1)
    texel = _texels(bm, torch.arange(N, device=bm.device), sv, su)
    mask = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(mask, texel, 0.0)


def _dynamic_bg(gd, cfg, states, tables):
    """The scrolling tiled background (starpilot.cpp:110-127) from the
    cached 64x64 mip in the static layer."""
    N = states.num_envs
    bm = states.static_layer.to(F32)
    if not cfg.use_backgrounds:
        return torch.zeros((N, RES, RES, 3), dtype=F32, device=bm.device)
    px = _px(bm.device)
    x0, tile_w, w_total, y0, h = (_col(v) for v in gd.dynamic_bg_rect(cfg, states))
    u_raw = (px - x0) / tile_w
    u = u_raw - torch.floor(u_raw)
    v = (px - y0) / h
    in_x = (px >= x0) & (px < x0 + w_total)
    in_y = (v >= 0) & (v < 1)
    su = torch.clamp((u * RES).to(I32), 0, RES - 1)
    sv = torch.clamp((v * RES).to(I32), 0, RES - 1)
    texel = _texels(bm, torch.arange(N, device=bm.device), sv, su)
    mask = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(mask, texel, 0.0)


# ---------------------------------------------------------------------------
# Grid tiles
# ---------------------------------------------------------------------------


def _pixel_cells(states):
    """Per-pixel world cell indices and within-cell texel coordinates,
    (N, 64) each (x for columns, y for rows)."""
    px = _px(states.unit.device)
    wx = (px + _col(states.x_off)) / _col(states.unit)
    wy = _col(states.view_dim) - (px - _col(states.y_off)) / _col(states.unit)
    cxi = torch.floor(wx + RENDER_EPS).to(I32)
    cyi = torch.floor(wy + RENDER_EPS).to(I32)
    cu = fm.div_const(wx - (cxi.to(F32) - RENDER_EPS), _CELL_DIV)
    cv = fm.div_const((cyi.to(F32) + 1 + RENDER_EPS) - wy, _CELL_DIV)
    return cxi, cyi, cu, cv


def _grid(gd, cfg, states, tables, canvas):
    """Grid tiles (bag.cpp:941-955) blended over ``canvas``: each pixel's
    cell class, then one blend per class texture, then the colour-rect
    cells."""
    K = tables.K
    n_crect = len(tables.crect_types)
    if K == 0 and n_crect == 0:
        return canvas
    R, A = tables.R, tables.A
    grid = states.grid
    N, Hm, Wm = grid.shape
    dev = canvas.device
    cxi, cyi, cu, cv = _pixel_cells(states)
    in_cx = (cxi >= 0) & (cxi < _col(states.main_width))
    in_cy = (cyi >= 0) & (cyi < _col(states.main_height))

    # class codes, 0 = draw nothing
    code = torch.zeros_like(grid)
    for j in range(K):
        code = torch.where(grid == int(tables.gtypes[j]), j + 1, code)
    for j in range(n_crect):
        code = torch.where(grid == int(tables.crect_types[j]), K + 1 + j, code)
    cell_in = in_cy[:, :, None] & in_cx[:, None, :]
    code_pix = torch.where(
        cell_in,
        _texels(code, torch.arange(N, device=dev), cyi.clamp(0, Hm - 1), cxi.clamp(0, Wm - 1)),
        0,
    )

    if gd.center_agent(cfg):
        # moving-view window + out-of-bounds cells (bag.cpp:928-939)
        margin = states.visibility / 2 + 1
        low_x = _col((states.center_x - margin).to(I32))
        high_x = _col((states.center_x + margin).to(I32))
        low_y = _col((states.center_y - margin).to(I32))
        high_y = _col((states.center_y + margin).to(I32))
        in_wx = (cxi >= low_x) & (cxi <= high_x)
        in_wy = (cyi >= low_y) & (cyi <= high_y)
        in_window = in_wy[:, :, None] & in_wx[:, None, :]
        oob_code = torch.zeros_like(states.out_of_bounds_object)
        for j in range(K):
            oob_code = torch.where(states.out_of_bounds_object == int(tables.gtypes[j]), j + 1,
                                   oob_code)
        code_pix = torch.where(in_window & ~cell_in, oob_code[:, None, None], code_pix)
        code_pix = torch.where(in_window, code_pix, 0)

    if K > 0:
        theme = gd.grid_theme_state(cfg, states)
        theme_b = theme.to(F32) if theme is not None else torch.zeros((N,), dtype=F32, device=dev)
        tsu = torch.clamp((torch.clamp(cu, 0.0, 0.9999) * R).to(I32), 0, R - 1)
        tsv = torch.clamp((torch.clamp(cv, 0.0, 0.9999) * R).to(I32), 0, R - 1)
        for k in range(K):
            slot = tables.gbases[k] + torch.where(tables.gthemed[k], theme_b, 0.0)
            var_id = (slot * A).to(I32).clamp(0, tables.NV - 1)
            spr = _texels(tables.var_mips, var_id, tsv, tsu).to(F32)  # (N, 64, 64, 4)
            m = (code_pix == (k + 1)).to(F32)
            a = fm.div_const(spr[..., 3], 255.0) * m
            canvas = spr[..., :3] * a[..., None] + canvas * (1 - a[..., None])

    for j in range(n_crect):
        d = float(tables.crect_dims[j])
        lo, hi = fm.f32((1 - d) / 2), fm.f32((1 + d) / 2)
        inside = (
            (code_pix == K + 1 + j)
            & ((cu >= lo) & (cu < hi))[:, None, :]
            & ((cv >= lo) & (cv < hi))[:, :, None]
        )
        canvas = torch.where(inside[..., None], tables.crect_rgb[j], canvas)
    return canvas


# ---------------------------------------------------------------------------
# Entities
# ---------------------------------------------------------------------------

# record fields, in the order of fast2's records
_FIELDS = ("bbx0", "bby0", "bbw", "bbh", "var", "refl", "alpha", "ok", "n_th", "n_tv", "z")


def _entity_records(gd, cfg, states, tables):
    """Per-entity draw records, a dict of (N, E) tensors in draw order:
    z passes -1/0/1 in slot order, records that draw nothing last."""
    ents = states.ents
    N, E = ents.x.shape
    A = tables.A
    dev = ents.x.device

    dm = gd.entity_draw_mask(cfg, states)
    draw_mask = dm if dm is not None else torch.ones((N, E), dtype=torch.bool, device=dev)
    io = gd.entity_image_override(cfg, states)
    img_t = io if io is not None else ents.image_type

    # screen rect (get_object_rect, bag.cpp:811-817)
    unit, view_dim = _col(states.unit), _col(states.view_dim)
    abs_c = ents.use_abs_coords
    r_x0 = torch.where(abs_c, view_dim * (ents.x - ents.rx) * unit,
                       (ents.x - ents.rx) * unit - _col(states.x_off))
    r_y0 = torch.where(abs_c, view_dim * (ents.y + ents.ry) * unit,
                       (view_dim - (ents.y + ents.ry)) * unit + _col(states.y_off))
    r_w = torch.where(abs_c, 2 * view_dim * ents.rx * unit, 2 * ents.rx * unit)
    r_h = torch.where(abs_c, 2 * view_dim * ents.ry * unit, 2 * ents.ry * unit)

    mono = cfg.use_monochrome_assets
    adj = None if mono else gd.image_rect_adjust(img_t)
    if adj is not None:
        aox, aoy, asw, ash = adj
        r_x0 = r_x0 + r_w * aox
        r_y0 = r_y0 + r_h * aoy
        r_w = r_w * asw
        r_h = r_h * ash

    # (type, theme) -> variant-atlas base slot
    base = torch.full((N, E), -1.0, dtype=F32, device=dev)
    for t, b in zip(tables.ent_types, tables.ent_bases):
        base = torch.where(img_t == int(t), float(b), base)
    slot = base + ents.image_theme.to(F32)

    if A > 1:
        bin_ = torch.remainder(torch.round(ents.rotation * fm.f32(A / TWO_PI)).to(I32), A)
    else:
        bin_ = torch.zeros((N, E), dtype=I32, device=dev)
    bin_eff = torch.where(ents.is_reflected & (A > 1), (A - bin_) % A, bin_)
    cs = tables.bin_cs[bin_.to(_I64)]
    c, s = cs[..., 0], cs[..., 1]
    bbw = torch.abs(c) * r_w + torch.abs(s) * r_h
    bbh = torch.abs(s) * r_w + torch.abs(c) * r_h
    bbx0 = r_x0 + r_w / 2 - bbw / 2
    bby0 = r_y0 + r_h / 2 - bbh / 2

    ratio = None if mono else gd.tile_ratio_for(img_t, ents.rx, ents.ry)
    n_th = torch.ones((N, E), dtype=F32, device=dev)
    n_tv = torch.ones((N, E), dtype=F32, device=dev)
    if ratio is not None:
        unrot = bin_ == 0
        eps = fm.f32(1e-9)
        n_th = torch.where(unrot & (ratio > 0), torch.clamp(
            (r_w / (r_h * torch.abs(ratio) + eps)).to(I32), min=1).to(F32), 1.0)
        n_tv = torch.where(unrot & (ratio < 0), torch.clamp(
            (r_h / (r_w * torch.abs(ratio) + eps)).to(I32), min=1).to(F32), 1.0)

    ok = ents.alive & draw_mask & (base >= 0)
    rec = dict(
        bbx0=bbx0, bby0=bby0,
        bbw=torch.clamp(bbw, min=fm.f32(1e-6)), bbh=torch.clamp(bbh, min=fm.f32(1e-6)),
        var=slot * A + bin_eff.to(F32),
        refl=torch.zeros((N, E), dtype=F32, device=dev) if mono else ents.is_reflected.to(F32),
        alpha=torch.ones_like(ents.alpha) if mono else ents.alpha,
        ok=ok.to(F32), n_th=n_th, n_tv=n_tv, z=ents.render_z.to(F32),
    )
    # z passes -1/0/1 in slot order, non-drawable last (bag.cpp:957-958)
    slots = torch.arange(E, device=dev)
    zb = torch.clamp(ents.render_z, -1, 1).to(_I64) + 1
    order = torch.argsort(torch.where(ok, zb * E + slots, 4 * E + slots), dim=1)
    return {f: rec[f].gather(1, order) for f in _FIELDS}, int(ok.sum(1).max())


def _composite(tables, records, kmax, canvas, z_filter="all"):
    """Z-ordered, nearest-sampled, premultiplied blend of the records, one
    record at a time: ``c = s + c * (1 - a)``, each op rounded, with the
    premultiplied texels rounded to bf16 (the reference package's MXU
    dtype), so that frames are the same on every device."""
    R = tables.R
    N = canvas.shape[0]
    px = _px(canvas.device)
    for k in range(kmax):  # records past the largest drawable count draw nothing
        g = {f: records[f][:, k] for f in _FIELDS}
        ok = g["ok"] > 0
        if z_filter == "neg":
            ok = ok & (g["z"] < 0)
        elif z_filter == "nonneg":
            ok = ok & (g["z"] >= 0)
        col = (px - _col(g["bbx0"])) / _col(g["bbw"])
        row = (px - _col(g["bby0"])) / _col(g["bbh"])
        in_x = (col >= 0) & (col < 1)
        in_y = (row >= 0) & (row < 1)
        uraw = col * _col(g["n_th"])
        u = torch.where(_col(g["n_th"] > 1), uraw - torch.floor(uraw), col)
        vraw = row * _col(g["n_tv"])
        v = torch.where(_col(g["n_tv"] > 1), vraw - torch.floor(vraw), row)
        su = torch.clamp((torch.clamp(u, 0.0, 0.9999) * R).to(I32), 0, R - 1)
        sv = torch.clamp((torch.clamp(v, 0.0, 0.9999) * R).to(I32), 0, R - 1)
        su = torch.where(_col(g["refl"] > 0), R - 1 - su, su)
        var = g["var"].to(I32).clamp(0, tables.NV - 1)
        tex = _texels(tables.var_mips, var, sv, su).to(F32)  # (N, 64, 64, 4)
        a_tex = tex[..., 3:4] * fm.div_const(g["alpha"], 255.0)[:, None, None, None]
        tex_p = torch.cat([tex[..., :3] * a_tex, a_tex], dim=-1)
        spr = tex_p.to(torch.bfloat16).to(F32)
        mask = (in_y[:, :, None] & in_x[:, None, :] & ok[:, None, None])[..., None]
        spr = torch.where(mask, spr, 0.0)
        canvas = spr[..., :3] + canvas * (1 - spr[..., 3:])
    return canvas


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def oracle_static(gd, cfg, states, pack) -> torch.Tensor:
    """The per-level static layer -> (N, 64, 64, 3) uint8; the statement of
    ``fast2.render_static2``."""
    tables = get_tables(gd, cfg, pack, states.done.device)
    bm = tables.bg_mip[states.background_index.to(_I64)].to(F32)
    if gd.center_agent(cfg) or gd.dynamic_background(cfg):
        return to_frames(bm)
    canvas = _bg(gd, cfg, states, tables, bm)
    if not gd.grid_dynamic:
        canvas = _grid(gd, cfg, states, tables, canvas)
    return to_frames(canvas)


def oracle_obs(gd, cfg, states, pack) -> torch.Tensor:
    """The observations -> (N, 64, 64, 3) uint8; the statement of
    ``fast2.render_frames2`` and so of the compositor kernel."""
    tables = get_tables(gd, cfg, pack, states.done.device)
    dyn_bg = gd.dynamic_background(cfg)
    center = gd.center_agent(cfg)
    if dyn_bg:
        canvas = _dynamic_bg(gd, cfg, states, tables)
    elif center:
        canvas = _bg(gd, cfg, states, tables, states.static_layer.to(F32))
    else:
        canvas = states.static_layer.to(F32)

    records, kmax = _entity_records(gd, cfg, states, tables)
    if gd.grid_dynamic:
        canvas = _composite(tables, records, kmax, canvas, "neg")
        canvas = _grid(gd, cfg, states, tables, canvas)
        canvas = _composite(tables, records, kmax, canvas, "nonneg")
    elif center and not dyn_bg:
        canvas = _grid(gd, cfg, states, tables, canvas)
        canvas = _composite(tables, records, kmax, canvas)
    else:
        canvas = _composite(tables, records, kmax, canvas)

    canvas = _paint_vel_info(gd, cfg, states, canvas)
    canvas = _paint_hud(gd, cfg, states, canvas)
    return to_frames(canvas)
