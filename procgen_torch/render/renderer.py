"""View parameters (counterpart of ``procgen_tpu/render/renderer.py``).

Ported: ``update_view_params`` and ``_pixel_world_coords``; the gather/spec
render path (render_env, render_frame) follows later (ROADMAP A11)."""

from __future__ import annotations

import torch

from procgen_torch import fmath as fm
from procgen_torch.state import F32, EnvState


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


def _pixel_world_coords(states: EnvState):
    """Pixel centres of the 64x64 frame, (1, 1, 64) and (1, 64, 1), and
    their world coordinates, (N, 1, 64) and (N, 64, 1)."""
    dev = states.unit.device
    p = torch.arange(64, dtype=F32, device=dev) + 0.5
    SX, SY = p[None, None, :], p[None, :, None]
    unit = states.unit[:, None, None]
    wx = (SX + states.x_off[:, None, None]) / unit
    wy = states.view_dim[:, None, None] - (SY - states.y_off[:, None, None]) / unit
    return SX, SY, wx, wy
