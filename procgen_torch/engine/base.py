"""GameDef: the per-game behavior contract, plus the BasicAbstractGame-level
step/reset bodies shared by all games (counterpart of
``procgen_tpu/engine/base.py``).

A GameDef holds a game's constants as class attributes and its virtual
methods as functions ``(cfg, state, ...) -> state`` over a whole batch: every
hook receives and returns batched state (leading env axis N).
"""

from __future__ import annotations

import torch

from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch import telemetry
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import physics as ph
from procgen_torch.fmath import dmul, f32, fadd32, fmuladd32
from procgen_torch.render.assets import BACKGROUND_GROUPS
from procgen_torch.state import (
    F32,
    EnvState,
    default_entity_fields,
    empty_entity_table,
)

PAIRS_SPAN = "procgen_torch.pair_collisions"
# the sequential agent-collision sweeps of bigfish and heist
AGENT_SWEEP_SPAN = "procgen_torch.agent_collision_sweep"

MAXVTHETA = f32(15 * 3.141592653589793 / 180)  # bag.cpp:6 (float const)
MIXRATEROT = f32(0.5)  # bag.cpp:7

class GameDef:
    """Base per-game definition with BasicAbstractGame defaults
    (ctor values: basic-abstract-game.cpp:22-46, game.cpp:25-37)."""

    name: str = "?"

    # Game-level constants
    timeout: int = 1000
    default_action: int = 4  # bag.cpp:38

    # Static capacities (tensor shapes)
    world_w_max: int = 64
    world_h_max: int = 64
    max_entities: int = 16
    max_substeps: int = 12

    # Physics feature gates
    agent_only_smart: bool = True
    # upper bound on simultaneously alive smart_step entities (caps the
    # smart sub-step batch; None = max_entities)
    max_smart_entities = None
    block_zeroes_velocity_types: tuple = ()
    uses_entity_reflect: bool = False
    uses_entity_block: bool = False
    uses_entity_push: bool = False
    uses_pair_collisions: bool = False
    smart_entities_grid_collide: bool = False

    # BasicAbstractGame ctor values
    char_dim: float = 5.0
    visibility: float = 16.0
    min_visibility: float = 0.0
    mixrate: float = 0.5
    maxspeed: float = 0.5
    max_jump: float = 0.5
    random_agent_start: bool = True
    has_useful_vel_info: bool = True
    out_of_bounds_object: int = O.INVALID_OBJ
    bg_tile_ratio: float = 0.0

    # ---- rendering declarations ----
    background_group: str = "topdown_backgrounds"
    entity_rotations: str = "none"  # "none" / "axis" / "free"
    grid_dynamic: bool = False

    # Worst-case RNG draws consumed by one reset (sizes the prefetch block).
    reset_max_draws: int = 512

    # ``extra`` fields the reference keeps across a reset (members of the
    # C++ game that game_reset leaves alone): the fast path's level swap
    # takes them from the dying step, as the inline reset does
    kept_across_reset: tuple = ()

    def image_rect_adjust(self, img_type):
        """get_adjusted_image_rect (bag.cpp:807-809) as (ox, oy, sw, sh)
        fractions, or None."""
        return None

    def tile_ratio_for(self, img_type, rx=None, ry=None):
        """get_tile_aspect_ratio (bag.cpp:409-411), or None when the game
        never tiles."""
        return None

    @property
    def num_backgrounds(self) -> int:
        return len(BACKGROUND_GROUPS[self.background_group])

    def asset_map(self, cfg) -> dict:
        """type -> theme-ordered sprite paths (asset_for_type)."""
        return {}

    def should_preserve_type_themes(self, type_: int) -> bool:
        """Types whose themes survive restrict_themes (bag.cpp:446-453)."""
        return False

    def use_block_asset(self, type_: int) -> bool:
        """Generated assets of this type paint as full-canvas blocks
        (bag.cpp:400-406)."""
        return False

    def center_agent(self, cfg) -> bool:
        """Effective options.center_agent (games may force it per mode)."""
        return cfg.center_agent

    def grid_image_lut(self, cfg):
        from procgen_torch.render import pack

        return pack.default_grid_image_lut()

    def grid_theme_lut(self, cfg):
        from procgen_torch.render import pack

        return pack.default_grid_theme_lut()

    def grid_cell_types(self, cfg):
        """Cell types a grid can contain, or None to derive them."""
        return None

    # dynamic grid theming (theme_for_grid_obj with game state)
    grid_theme_count: int = 1

    def grid_themed_types(self):
        return ()

    def grid_theme_state(self, cfg, states):
        """Per-env theme (N,) for grid_themed_types, or None."""
        return None

    def grid_color_rect_lut(self, cfg):
        """draw_grid_obj color-rect overrides: None, or (dim_lut, rgb_lut)."""
        return None

    def entity_draw_mask(self, cfg, states):
        """should_draw_entity (bag.cpp:1048-1050) as (N, E) bool, or None."""
        return None

    def entity_image_override(self, cfg, states):
        """Dynamic image_for_type for entities: (N, E) image types or None."""
        return None

    def hud_color_rects(self, cfg, states):
        """Post-entity screen-space fillRects (per-game game_draw overlays):
        None, or (rects (N, K, 4) [x, y_top, w, h] in world units scaled by
        ``unit`` from the top-left -- get_abs_rect, bag.cpp:803-805 -- and
        colors, K RGB triples of Python numbers)."""
        return None

    def hud_overlay(self, cfg, states, out, SX, SY):
        """Free-form screen-space overlay drawn after hud_color_rects on the
        f32 canvas ``out`` (N, 64, 64, 3); ``SX``/``SY`` are the pixel-centre
        coordinates, (1, 1, 64) and (1, 64, 1).  Default: none."""
        return out

    def dynamic_bg_rect(self, cfg, states):
        """The scrolling background of games that draw one per step
        (starpilot's tiled space background, starpilot.cpp:110-127):
        (x0, tile_w, w_total, y0, h), each an (N,) float32 tensor in screen
        pixels, for a horizontally tiled blit of the cached 64x64 background
        mip.  Default: None, a background baked once per level."""
        return None

    def dynamic_background(self, cfg) -> bool:
        """True for games whose background is drawn per step from
        ``dynamic_bg_rect`` (render/fast2.dynamic_bg_pass)."""
        return type(self).dynamic_bg_rect is not GameDef.dynamic_bg_rect

    def paint_dynamic_background(self, cfg, states, out, SX, SY, tables):
        """The per-step background of the direct render path
        (render/renderer.render_env) at any resolution: the tiled blit of
        ``dynamic_bg_rect`` sampled from the full background image (the
        reference package's ``GameDef.dynamic_background`` painter;
        starpilot.cpp:110-127).  ``out`` is the f32 canvas (N, res, res, 3),
        ``SX``/``SY`` the pixel centres in 64-pixel units, (1, 1, res) and
        (1, res, 1), ``tables`` the renderer's device copies of the pack
        (``bg_atlas``, ``bg_dims``)."""
        if not cfg.use_backgrounds:
            return out
        x0, tile_w, w_total, y0, h = (v[:, None, None] for v in self.dynamic_bg_rect(cfg, states))
        u_raw = (SX - x0) / tile_w
        u = u_raw - torch.floor(u_raw)
        v = (SY - y0) / h
        inside = (SX >= x0) & (SX < x0 + w_total) & (v >= 0) & (v < 1)
        bgi = states.background_index.to(torch.int64)
        dims = tables.bg_dims[bgi]
        bw, bh = dims[:, 0, None, None], dims[:, 1, None, None]
        su = torch.minimum(torch.clamp((u * bw.to(F32)).to(torch.int32), min=0), bw - 1)
        sv = torch.minimum(torch.clamp((v * bh.to(F32)).to(torch.int32), min=0), bh - 1)
        col = tables.bg_atlas[bgi[:, None, None], sv.to(torch.int64), su.to(torch.int64)].to(F32)
        return torch.where(inside[..., None], col, out)

    def has_hud(self, cfg) -> bool:
        """True for games with screen-space overlays."""
        return (
            type(self).hud_color_rects is not GameDef.hud_color_rects
            or type(self).hud_overlay is not GameDef.hud_overlay
        )

    # ---- per-game state extras ----
    def init_extra(self, cfg, num_envs: int, device) -> dict:
        return {}

    # ---- state codec hooks (utils/serialize.py) ----
    def serialize_extra(self, w, s, i) -> None:
        """Write env ``i``'s game fields (the game's own serialize) from the
        host-side flat dict ``s`` (``s["extra.maze_dim"][i]``)."""

    def deserialize_extra(self, r) -> dict:
        """Read them back: {extra key: per-env value}; keys left out keep
        the template state's values."""
        return {}

    # ---- virtuals (bag.h:34-55) ----
    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        return state

    def game_reset(self, cfg, state: EnvState, rs):
        """Level generation; draws through ``rs`` (an open MTBlock).
        Returns (state, rs)."""
        return base_game_reset(self, cfg, state, rs)

    def game_step(self, cfg, state: EnvState) -> EnvState:
        return base_game_step(self, cfg, state)

    def set_action_xy(self, cfg, state, move_action):
        """bag.cpp:658-662; returns (action_vx, action_vy, action_vrot), or
        those and the state for games whose override also writes state
        (coinrun's has_support probe)."""
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        avy = (move_action % 3 - 1).to(F32)
        return avx, avy, torch.zeros_like(avx)

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        """bag.cpp:669-679 (+ decay_agent_velocity :681-684)."""
        ents = state.ents
        v_scale = self.get_agent_acceleration_scale(cfg, state)
        mix = state.mixrate
        # "vx += mixrate * maxspeed * action_vx * v_scale": the add of the
        # product chain rounds separately (no FMA on ivybridge)
        vx = fadd32(
            cfg, (1 - mix) * ents.vx[:, eo.AGENT],
            mix * state.maxspeed * state.action_vx * v_scale,
        )
        vy = fadd32(
            cfg, (1 - mix) * ents.vy[:, eo.AGENT],
            mix * state.maxspeed * state.action_vy * v_scale,
        )
        vx = dmul(cfg, vx, 0.9)
        vy = dmul(cfg, vy, 0.9)
        return state.replace(ents=eo.write_slot(ents, eo.AGENT, vx=vx, vy=vy))

    def get_agent_acceleration_scale(self, cfg, state):
        return 1.0

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        """bag.cpp:485-492 (vectorized over target types)."""
        oob = state.out_of_bounds_object.reshape(
            (-1,) + (1,) * (target_type.dim() - 1)
        )
        return (target_type == O.WALL_OBJ) | (target_type == oob)

    def is_blocked_ents(self, cfg, state, src_type, target_type, is_horizontal):
        return self.is_blocked(cfg, state, src_type, target_type, is_horizontal)

    def is_blocked_ents_vals(self, cfg, state, src_type, tgt, is_horizontal):
        """is_blocked_ents against blocker field values ``tgt`` (a dict of
        type/image_theme/y/ry tensors broadcasting against ``src_type``,
        leading env axis N); games whose blocking depends on more than the
        type (coinrun's crates) override this."""
        return self.is_blocked_ents(cfg, state, src_type, tgt["type"], is_horizontal)

    def note_entity_blocks(self, cfg, state, idxs, blocked_mat, is_horizontal):
        """Observe which entities blocked the movers during a sub-step (the
        reference lets is_blocked_ents carry side effects, e.g. coinrun's
        is_on_crate, coinrun.cpp:187-202).  ``idxs`` (N, M) mover slots,
        ``blocked_mat`` (N, M, E') over the first E' slots.  Default: no-op."""
        return state

    def will_reflect(self, cfg, state, src_type, target_type):
        return torch.zeros(
            torch.broadcast_shapes(src_type.shape, target_type.shape),
            dtype=torch.bool, device=target_type.device,
        )

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        """mask: (N, E) bool -- entities currently overlapping the agent."""
        return state

    def agent_collision_phase(self, cfg, state: EnvState) -> EnvState:
        """Agent-collision dispatch (bag.cpp:722-724): the collision mask is
        computed once and handed to handle_agent_collision."""
        ents = state.ents
        a = eo.AGENT
        tx = (ents.rx[:, a:a + 1] + ents.rx) + ents.collision_margin
        ty = (ents.ry[:, a:a + 1] + ents.ry) + ents.collision_margin
        mask = (torch.abs(ents.x[:, a:a + 1] - ents.x) < tx) & (
            torch.abs(ents.y[:, a:a + 1] - ents.y) < ty
        )
        mask = mask & ents.alive & (ents.type != O.PLAYER)
        return self.handle_agent_collision(cfg, state, mask)

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """pair_mask: (N, L, L) bool over the first L slots (L bounds every
        env's live count) -- [i, j]: slot i collides with slot j and
        collides_with_entities, both alive and not marked for erasure
        (bag.cpp:725-736).  Default: no-op."""
        return state

    def handle_grid_collision(self, cfg, state, ent_idx, cell_type, cx, cy, valid):
        """One overlapped cell of entity ``ent_idx`` (an int, or (N,) per-env
        slots); ``cell_type``/``cx``/``cy``/``valid`` are (N,)."""
        return state

    def choose_center(self, cfg, state):
        """bag.cpp:664-667: view center (and visibility) when
        options.center_agent.  Returns (cx, cy, visibility)."""
        return state.ents.x[:, eo.AGENT], state.ents.y[:, eo.AGENT], state.visibility


# ---------------------------------------------------------------------------
# BasicAbstractGame::game_reset (bag.cpp:758-797)
# ---------------------------------------------------------------------------


def base_game_reset(gd: GameDef, cfg, state: EnvState, rs):
    from procgen_torch.render.pack import PROCGEN_BG_POOL

    state = gd.choose_world_dim(cfg, state)
    N = state.num_envs
    dev = state.done.device

    rs, bg_pct_x = R.rs_rand01(rs)
    # Under use_generated_assets the reference paints one procgen background
    # per reset (bag.cpp:62-63, 769-773); here a pregenerated pool is
    # selected per level instead, as the reference package does.
    n_bgs = PROCGEN_BG_POOL if cfg.use_generated_assets else gd.num_backgrounds
    rs, background_index = R.rs_randn(rs, n_bgs)

    # entities.clear(); agent spawn (bag.cpp:775-793)
    a_r = f32(0.4)
    if gd.random_agent_start:
        rs, u1 = R.rs_rand01(rs)
        rs, u2 = R.rs_rand01(rs)
        # "rand01() * (main_width - 2 * a_r) + a_r", separate roundings
        ax = fmuladd32(cfg, u1, state.main_width.to(F32) - 2 * a_r, a_r)
        ay = fmuladd32(cfg, u2, state.main_height.to(F32) - 2 * a_r, a_r)
    else:
        ax = a_r
        ay = a_r

    ents = empty_entity_table(N, gd.max_entities, dev)
    agent = default_entity_fields(ax, ay, 0.0, 0.0, a_r, a_r, O.PLAYER)
    agent["smart_step"] = True
    agent["render_z"] = 1
    ents = eo.write_slot(ents, eo.AGENT, **agent)

    grid = torch.full_like(state.grid, O.SPACE)
    return state.replace(
        bg_pct_x=bg_pct_x,
        background_index=background_index,
        ents=ents,
        grid=grid,
    ), rs


# ---------------------------------------------------------------------------
# BasicAbstractGame::game_step (bag.cpp:686-746)
# ---------------------------------------------------------------------------


def base_game_step(gd: GameDef, cfg, state: EnvState) -> EnvState:
    mt, sri = R.mt_randint(state.rng, 0, 1000000)
    action = state.action
    move = action % 9
    special = torch.where(action >= 9, action - 8, 0)
    move = torch.where(action >= 9, 4, move)
    last_move = torch.where(move != 4, move, state.last_move_action)
    zero = torch.zeros_like(state.action_vx)
    state = state.replace(
        rng=mt,
        step_rand_int=sri,
        move_action=move,
        special_action=special,
        last_move_action=last_move,
        action_vx=zero,
        action_vy=zero,
        action_vrot=zero,
    )
    res = gd.set_action_xy(cfg, state, move)
    if len(res) == 4:
        avx, avy, avrot, state = res
    else:
        avx, avy, avrot = res
    state = state.replace(action_vx=avx, action_vy=avy, action_vrot=avrot)

    # Agent velocity: the grid path writes action velocities directly, the
    # continuous path mixes (bag.cpp:707-715); compute both and select.
    cont_state = gd.update_agent_velocity(cfg, state)
    cont_vrot = (
        MIXRATEROT * state.ents.vrot[:, eo.AGENT] + MIXRATEROT * MAXVTHETA * avrot
    )
    gs = state.grid_step
    new_vx = torch.where(gs, avx, cont_state.ents.vx[:, eo.AGENT])
    new_vy = torch.where(gs, avy, cont_state.ents.vy[:, eo.AGENT])
    new_vrot = torch.where(gs, state.ents.vrot[:, eo.AGENT], cont_vrot)
    state = cont_state.replace(
        ents=eo.write_slot(
            cont_state.ents, eo.AGENT, vx=new_vx, vy=new_vy, vrot=new_vrot
        )
    )

    state = ph.step_entities(gd, cfg, state)

    # collision dispatch (bag.cpp:719-741), phased as in the reference
    # package; the default grid handler is a no-op, so its probes are skipped
    state = gd.agent_collision_phase(cfg, state)
    if gd.uses_pair_collisions:
        with telemetry.span(PAIRS_SPAN):
            ents = state.ents
            telemetry.count("host_reads.base.pair_width")
            L = max(int(ents.alive.sum(1).max()), 1)
            state = gd.handle_collision_pairs(cfg, state, pair_collision_mask(ents, L))
    if type(gd).handle_grid_collision is not GameDef.handle_grid_collision:
        state = ph.check_grid_collisions(gd, cfg, state, eo.AGENT)
    if not gd.agent_only_smart and gd.smart_entities_grid_collide:
        state = smart_grid_collisions(gd, cfg, state)

    # erase + OOB (bag.cpp:743-745)
    ents = eo.compact(state.ents, state.main_width, state.main_height)
    a = eo.AGENT
    agent_oob = eo.is_out_of_bounds(
        ents.x[:, a], ents.y[:, a], ents.rx[:, a], ents.ry[:, a],
        state.main_width, state.main_height,
    )
    return state.replace(ents=ents, done=state.done | agent_oob)


def pair_collision_mask(ents, L: int) -> torch.Tensor:
    """bag.cpp:725-736 over the first ``L`` slots: (N, L, L), [i, j] where
    slot i collides with entities, i and j overlap (i's collision margin),
    both are alive and neither is marked for erasure, i != j.  Exact when
    ``L`` bounds every env's live count: live slots are a prefix of the
    table (compact keeps survivors in front, appends go to slot count)."""
    f = {n: getattr(ents, n)[:, :L] for n in (
        "x", "y", "rx", "ry", "collision_margin", "collides_with_entities", "alive",
        "will_erase")}
    tx = f["rx"][:, :, None] + f["rx"][:, None, :] + f["collision_margin"][:, :, None]
    ty = f["ry"][:, :, None] + f["ry"][:, None, :] + f["collision_margin"][:, :, None]
    pair = (torch.abs(f["x"][:, :, None] - f["x"][:, None, :]) < tx) & (
        torch.abs(f["y"][:, :, None] - f["y"][:, None, :]) < ty
    )
    ok = f["alive"] & ~f["will_erase"]
    eye = torch.eye(L, dtype=torch.bool, device=ok.device)
    return pair & (f["collides_with_entities"] & ok)[:, :, None] & ok[:, None, :] & ~eye


def descending_slots(mask: torch.Tensor):
    """The masked slots of each env (mask (N, K)) in descending order first
    (a stable sort: the rest follow ascending), their count per env, and
    the batch's largest count read on the host (one synchronization).
    Loops of per-env slot dispatches, in the reference's reverse slot
    order, run ``range(n_max)`` iterations gated by ``k < count``."""
    K = mask.shape[1]
    slot = torch.arange(K, device=mask.device)
    order = torch.sort(torch.where(mask, K - 1 - slot, 2 * K), dim=1, stable=True).indices
    count = mask.sum(1)
    telemetry.count("host_reads.base.dispatch_count")
    return order, count, int(count.max())


def smart_grid_collisions(gd: GameDef, cfg, state: EnvState) -> EnvState:
    """Grid collisions of the other smart entities (bag.cpp:738-740), for
    games whose handler answers them (ninja's throwing stars).  Handlers
    write the grid and append entities, so the dispatches stay sequential,
    in the reference's reverse slot order: a stable sort puts the smart
    slots first, descending.  The loop stops after the batch's largest
    smart count, read once per step (exact: a dispatch past an env's count
    is gated off and changes nothing)."""
    ents = state.ents
    E = ents.capacity
    M = min(gd.max_smart_entities or E, E)
    slot = torch.arange(E, device=ents.x.device)
    smart_alive = ents.alive & ents.smart_step & (slot != eo.AGENT)[None, :]
    order, n_smart, n_max = descending_slots(smart_alive)
    for k in range(min(M, n_max)):
        state = ph.check_grid_collisions(gd, cfg, state, order[:, k], active=k < n_smart)
    return state
