"""Ninja: a charged-jump platformer with throwing stars and bombs (reference
games/ninja.cpp); counterpart of ``procgen_tpu/games/ninja.py``.

A center-agent view over a 64x64 world.  Holding up on the ground charges
the jump (a bar in the HUD), releasing it jumps.  Throwing stars are smart
entities: they sub-step with the agent, stop dead when a wall probe blocks
them, stick to walls and blow up bombs through the smart-entity grid
collisions of ``engine/base.py``.  Level generation runs the reference's
section loop for its worst case of five sections, every draw masked per env.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import physics as ph
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.games import register_game
from procgen_torch.state import F32, I32, EnvState

GOAL_REWARD = 10.0

GOAL = 1
BOMB = 6
THROWING_STAR = 7
PLAYER_JUMP = 9
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13
FIRE = 14
WALL_MID = 20
NUM_WALL_THEMES = 3

GRAVITY = 0.2
AIR_CONTROL = 0.15
PI = float(np.float32(np.pi))  # the reference's `const float PI` (cpp-utils.h:12)

CHARGE_COLOR = (66.0, 245.0, 135.0)  # ninja.cpp:168
MAX_SECTIONS = 5  # difficulty 3: randn(3) + 3 sections at most


def _star_angles() -> np.ndarray:
    """The 8 float angles a star can leave at (ninja.cpp:385-405): special
    actions 1-4 give 0, PI/4, PI/2 and -PI/4 (others 0), mirrored to
    PI - theta (a float subtraction) when the agent faces left.  Row =
    action - 1 + 4 * reflected."""
    theta = np.array([0.0, PI / 4, PI / 2, -PI / 4], np.float32)
    return np.concatenate([theta, np.float32(PI) - theta])


@functools.lru_cache(maxsize=None)
def _star_velocity_table(device: str) -> torch.Tensor:
    """(8, 2) star (vx, vy): ``bullet_vel * cos(theta)`` resolves to the
    double cos and narrows at the Entity constructor, tabulated on the host
    by glibc once per device (the card's float trig differs from the
    CPU's)."""
    theta = _star_angles()
    table = np.stack([fm.dcos_libm(theta), fm.dsin_libm(theta)], 1)
    return torch.as_tensor(table).to(device)


def _slot_field(ents, name, idx):
    """Field ``name`` of slot ``idx`` (an int, or (N,) per-env slots) as (N,)."""
    arr = getattr(ents, name)
    if isinstance(idx, torch.Tensor):
        return torch.gather(arr, 1, idx[:, None])[:, 0]
    return arr[:, idx]


class Ninja(GameDef):
    name = "ninja"
    out_of_bounds_object = WALL_MID
    background_group = "platform_backgrounds"
    maxspeed = 0.5
    world_w_max = 64
    world_h_max = 64
    max_entities = 16  # agent + goal + <= 6 stars + explosions
    max_substeps = 8
    entity_rotations = "none"
    grid_theme_count = NUM_WALL_THEMES
    block_zeroes_velocity_types = (THROWING_STAR,)
    agent_only_smart = False  # throwing stars are smart_step
    max_smart_entities = 8
    smart_entities_grid_collide = True  # stars stick or explode on walls

    def __init__(self, cfg):
        self.easy = cfg.distribution_mode == DistributionMode.easy
        self.max_jump = 1.25 if self.easy else 1.5
        self.jump_charge_inc = 1.0 if self.easy else 0.25
        self.visibility = 10.0 if self.easy else 16.0

    def use_block_asset(self, type_):
        # ninja.cpp:135-137
        return type_ == WALL_MID

    def asset_map(self, cfg):
        # ninja.cpp:45-76
        return {
            WALL_MID: [
                "misc_assets/tile_bricksGrey.png",
                "misc_assets/tile_bricksGrown.png",
                "misc_assets/tile_bricksRed.png",
            ],
            GOAL: [f"platformer/shroom{i}.png" for i in range(1, 7)],
            O.PLAYER: ["platformer/zombie_idle.png"],
            PLAYER_JUMP: ["platformer/zombie_jump.png"],
            PLAYER_RIGHT1: ["platformer/zombie_walk1.png"],
            PLAYER_RIGHT2: ["platformer/zombie_walk2.png"],
            BOMB: ["misc_assets/bomb.png"],
            THROWING_STAR: ["misc_assets/saw.png"],
            FIRE: ["misc_assets/bomb.png"],
            O.EXPLOSION: ["misc_assets/explosion1.png"],
            O.EXPLOSION + 1: ["misc_assets/explosion2.png"],
            O.EXPLOSION + 2: ["misc_assets/explosion3.png"],
            O.EXPLOSION + 3: ["misc_assets/explosion4.png"],
            O.EXPLOSION + 4: ["misc_assets/explosion5.png"],
        }

    def grid_themed_types(self):
        return (WALL_MID,)

    def grid_theme_state(self, cfg, states):
        return states.extra["wall_theme"]

    def init_extra(self, cfg, num_envs, device):
        def full(v, dtype):
            return torch.full((num_envs,), v, dtype=dtype, device=device)

        return {
            "has_support": full(False, torch.bool),
            "facing_right": full(True, torch.bool),
            "last_fire_time": full(0, I32),
            "wall_theme": full(0, I32),
            "jump_charge": full(0.0, F32),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, 64)
        return state.replace(main_width=d, main_height=d)

    def hud_color_rects(self, cfg, states):
        # the jump-charge bar (ninja.cpp:166-175)
        bar_h = 3 * states.extra["jump_charge"]
        vis = states.visibility
        rects = torch.stack(
            [torch.full_like(vis, 0.25), vis - 0.5 - bar_h, torch.full_like(vis, 0.5), bar_h], -1
        )
        return rects[:, None, :], (CHARGE_COLOR,)

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        blocked_types = (src_type == O.PLAYER) | (src_type == THROWING_STAR)
        return base | (blocked_types & (target_type == WALL_MID))

    def set_action_xy(self, cfg, state, move_action):
        # ninja.cpp:347-377
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        avy = torch.clamp((move_action % 3 - 1).to(F32), min=0.0)
        extra = dict(state.extra)
        extra["facing_right"] = torch.where(
            avx > 0, True, torch.where(avx < 0, False, extra["facing_right"])
        )
        ents = state.ents
        a = eo.AGENT
        # probe coords promote to double via the .01 literals
        # (ninja.cpp:358-359)
        ax, ay = fm.wide(cfg, ents.x[:, a]), fm.wide(cfg, ents.y[:, a])
        arx, ary = fm.wide(cfg, ents.rx[:, a]), fm.wide(cfg, ents.ry[:, a])
        b1 = ph.get_obj_from_floats(state, fm.narrow(ax - (arx - 0.01)), fm.narrow(ay - (ary + 0.01)))
        b2 = ph.get_obj_from_floats(state, fm.narrow(ax + (arx - 0.01)), fm.narrow(ay - (ary + 0.01)))
        has_support = (b1 == WALL_MID) | (b2 == WALL_MID)
        extra["has_support"] = has_support
        charging = has_support & (avy == 1)
        avy = torch.where(charging, 1.0, 0.0)
        charge = extra["jump_charge"]
        charge = torch.where(
            charging, torch.clamp(charge + fm.f32(self.jump_charge_inc), max=1.0), charge
        )
        extra["jump_charge"] = torch.where(has_support, charge, 0.0)
        return avx, avy, torch.zeros_like(avx), state.replace(extra=extra)

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # ninja.cpp:108-124: the jump releases when the key lifts
        ents = state.ents
        a = eo.AGENT
        extra = dict(state.extra)
        has_support = extra["has_support"]
        mixrate_x = torch.where(has_support, state.mixrate, state.mixrate * fm.f32(AIR_CONTROL))
        # "(1 - mixrate_x) * vx + mixrate_x * maxspeed * action_vx"
        # (ninja.cpp:110): two float products and a separate float add
        vx = fm.fadd32(
            cfg, (1 - mixrate_x) * ents.vx[:, a], mixrate_x * state.maxspeed * state.action_vx
        )
        charge = extra["jump_charge"]
        release = (state.action_vy < 1) & (charge > 0)
        vy = torch.where(release, charge * state.max_jump, ents.vy[:, a])
        extra["jump_charge"] = torch.where(release, 0.0, charge)
        vy = torch.where(~has_support & (vy > -2), vy - fm.f32(GRAVITY), vy)
        return state.replace(ents=eo.write_slot(ents, a, vx=vx, vy=vy), extra=extra)

    def entity_image_override(self, cfg, states):
        # image_for_type (ninja.cpp:154-164)
        ents = states.ents
        has_support = states.extra["has_support"]
        standing = (
            (torch.abs(ents.vx[:, eo.AGENT]) < 0.01) & (states.action_vx == 0) & has_support
        )
        walk1 = (torch.div(states.cur_time, 5, rounding_mode="floor") % 2 == 0) | ~has_support
        agent_img = torch.where(
            standing, O.PLAYER, torch.where(walk1, PLAYER_RIGHT1, PLAYER_RIGHT2)
        ).to(I32)
        out = ents.image_type.clone()
        out[:, eo.AGENT] = agent_img
        return out

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # ninja.cpp:78-87
        t = state.ents.type
        dead = (mask & (t == O.EXPLOSION)).any(1)
        goal = (mask & (t == GOAL)).any(1)
        return state.replace(
            done=state.done | dead | goal,
            reward=state.reward + torch.where(goal, GOAL_REWARD, 0.0),
            level_complete=state.level_complete | goal,
        )

    def handle_grid_collision(self, cfg, state, ent_idx, cell_type, cx, cy, valid):
        # ninja.cpp:89-106
        ents = state.ents
        t = _slot_field(ents, "type", ent_idx)
        deadly = valid & (t == O.PLAYER) & ((cell_type == FIRE) | (cell_type == BOMB))
        state = state.replace(done=state.done | deadly)
        if not isinstance(ent_idx, torch.Tensor):
            # the agent's dispatch (slot 0 is always the player, never a star)
            return state
        is_star = t == THROWING_STAR
        star_bomb = valid & is_star & (cell_type == BOMB)
        star_wall = valid & is_star & (cell_type == WALL_MID)

        N, H, W = state.grid.shape
        b = torch.arange(N, device=cx.device)
        xc = torch.clamp(cx, 0, W - 1).to(torch.int64)
        yc = torch.clamp(cy, 0, H - 1).to(torch.int64)
        grid = state.grid.clone()
        grid[b, yc, xc] = torch.where(star_bomb, O.SPACE, grid[b, yc, xc])
        ents = eo.write_slots_masked(
            ents, ent_idx[:, None], (star_bomb | star_wall)[:, None],
            will_erase=torch.ones_like(star_bomb)[:, None],
        )
        expl = eo.make_entity(
            cx.to(F32) + 0.5, cy.to(F32) + 0.5, 0.0, 0.0, 0.5, 0.5, O.EXPLOSION
        )
        ents, _ = eo.append_entity(ents, expl, active=star_bomb)
        return state.replace(grid=grid, ents=ents)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)
        mw = mh = 64
        difficulty_max = 3

        state = state.replace(
            ents=eo.write_slot(
                state.ents, eo.AGENT, rx=0.5, ry=0.5, x=1.5, y=float(mh / 2 + 0.5)
            ),
            visibility=torch.full((N,), self.visibility, dtype=F32, device=dev),
        )

        rs, dr = R.rs_randn(rs, difficulty_max)
        difficulty = dr + 1
        rs, wall_theme = R.rs_randn(rs, NUM_WALL_THEMES)

        grid = state.grid
        # init_floor_and_walls (ninja.cpp:187-192)
        grid = ph.fill_rect(grid, 0, 0, mw, 1, WALL_MID)
        grid = ph.fill_rect(grid, 0, 0, 1, mh, WALL_MID)
        grid = ph.fill_rect(grid, mw - 1, 0, 1, mh, WALL_MID)
        grid = ph.fill_rect(grid, 0, mh - 1, mw, 1, WALL_MID)

        # generate_coin_to_the_right (ninja.cpp:194-305)
        if self.easy:
            min_gap_base = -1  # clamped at 0 after difficulty - 1
            min_plat_w, inc_dy = 3, 2
        else:
            min_gap_base = 0
            min_plat_w, inc_dy = 1, 4
        min_gap = torch.clamp(difficulty - 1 + min_gap_base, min=0)
        bomb_prob = fm.f32(0.25) * (difficulty - 1).to(F32)
        max_gap_inc = torch.where(difficulty == 1, 1, 2)

        rs, ns = R.rs_randn(rs, difficulty)
        num_sections = ns + difficulty
        start_x = 5
        curr_x = torch.full((N,), start_x, dtype=I32, device=dev)
        curr_y = torch.full((N,), mh // 2, dtype=I32, device=dev)
        min_y = curr_y
        max_dy = int(self.max_jump * self.max_jump / (2 * GRAVITY) - 0.5)

        grid = ph.fill_rect(grid, 0, 0, start_x, curr_y, WALL_MID)
        grid = ph.fill_rect(grid, 0, curr_y + 8, start_x, mh - curr_y - 8, WALL_MID)
        div3 = torch.div(difficulty, 3, rounding_mode="floor")

        for i in range(MAX_SECTIONS):
            s_on = i < num_sections
            prev_x = curr_x
            prev_y = curr_y
            rs, ne = R.rs_randn(rs, 2, active=s_on)
            num_edges = ne + 1
            max_y = torch.full((N,), -1, dtype=I32, device=dev)
            last_edge_y = torch.full((N,), -1, dtype=I32, device=dev)

            for j in range(2):
                e_on = s_on & (j < num_edges)
                cx_try = prev_x + j
                e_on = e_on & (cx_try + 15 < mw)  # the edge loop's break
                curr_x = torch.where(e_on, cx_try, curr_x)
                cy = prev_y
                rs, dyr = R.rs_randn(rs, inc_dy, active=e_on)
                dy = torch.clamp(dyr + 1 + div3, max=max_dy)
                high = cy >= mh - 15
                can_flip = e_on & ~high & (cy >= 5)
                rs, u_f = R.rs_rand01(rs, active=can_flip)
                flip = high | (can_flip & (u_f < fm.f32(0.4)))
                dy = torch.where(flip, -dy, dy)
                cy = torch.clamp(cy + dy, min=3)
                cy = torch.where(torch.abs(cy - last_edge_y) <= 1, last_edge_y + 2, cy)
                rs, dxr = R.rs_randn(rs, 3, active=e_on)
                dx = min_plat_w + dxr
                g2 = ph.fill_rect(grid, curr_x, cy - 1, dx, 1, WALL_MID)
                grid = torch.where(e_on[:, None, None], g2, grid)
                curr_x = torch.where(e_on, curr_x + dx, curr_x)
                rs, gapr = R.rs_randn(rs, torch.clamp(max_gap_inc + 1, min=1), active=e_on)
                curr_x = torch.where(e_on, curr_x + min_gap + gapr, curr_x)
                max_y = torch.where(e_on & (cy > max_y), cy, max_y)
                min_y = torch.where(e_on & (cy < min_y), cy, min_y)
                last_edge_y = torch.where(e_on, cy, last_edge_y)
                curr_y = torch.where(e_on, cy, curr_y)

            rs, u_b = R.rs_rand01(rs, active=s_on)
            place_bomb = s_on & (u_b < bomb_prob)
            rs, bx = R.rs_randn(rs, torch.clamp(curr_x - prev_x + 1, min=1), active=place_bomb)
            bxx = torch.clamp(bx + prev_x, 0, 63).to(torch.int64)
            byy = torch.clamp(max_y + 2, 0, 63).to(torch.int64)
            grid = grid.clone()
            grid[b, byy, bxx] = torch.where(place_bomb, BOMB, grid[b, byy, bxx])

            ceiling_start = max_y - 1 + 11
            g2 = ph.fill_rect(
                grid, prev_x, ceiling_start, curr_x - prev_x, mh - ceiling_start, WALL_MID
            )
            grid = torch.where(s_on[:, None, None], g2, grid)

        # the goal and the final columns (ninja.cpp:293-304)
        rs, goal_theme = R.rs_randn(rs, 6)
        gfields = eo.make_entity(
            curr_x.to(F32) + 0.5, curr_y.to(F32) + 0.5, 0.0, 0.0, 0.5, 0.5, GOAL
        )
        gfields["image_theme"] = goal_theme
        ents, _ = eo.append_entity(state.ents, gfields)

        grid = ph.fill_rect(grid, curr_x, curr_y - 1, 1, 1, WALL_MID)
        grid = ph.fill_rect(grid, curr_x, curr_y + 6, 1, mh - curr_y - 6, WALL_MID)
        fire_y = torch.clamp(min_y - 2, min=1)
        grid = ph.fill_rect(grid, start_x, 0, mw - start_x, fire_y, WALL_MID)
        grid = ph.fill_rect(grid, start_x, fire_y, mw - start_x, 1, FIRE)
        grid = ph.fill_rect(grid, curr_x + 1, 0, mw - curr_x - 1, mh, WALL_MID)

        extra = dict(state.extra)
        extra["wall_theme"] = wall_theme
        extra["has_support"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        extra["facing_right"] = torch.ones((N,), dtype=torch.bool, device=dev)
        extra["last_fire_time"] = torch.zeros((N,), dtype=I32, device=dev)
        extra["jump_charge"] = torch.zeros((N,), dtype=F32, device=dev)
        return state.replace(grid=grid.to(I32), ents=ents, extra=extra), rs

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        ents = state.ents
        a = eo.AGENT
        extra = dict(state.extra)

        refl = torch.where(
            state.action_vx > 0, False,
            torch.where(state.action_vx < 0, True, ents.is_reflected[:, a]),
        )
        ents = eo.write_slot(ents, a, is_reflected=refl)

        # throwing stars at 4 angles (ninja.cpp:385-410)
        sa = state.special_action
        fire = (sa > 0) & (state.cur_time - extra["last_fire_time"] >= 3)
        # special actions past 4 throw at angle 0 (the select's default)
        row = torch.where((sa >= 1) & (sa <= 4), sa - 1, 0).to(torch.int64) + 4 * refl.to(torch.int64)
        vel = _star_velocity_table(str(ents.x.device))[row]
        star = eo.make_entity(
            ents.x[:, a], ents.y[:, a], vel[:, 0], vel[:, 1], 0.25, 0.25, THROWING_STAR
        )
        star.update(collides_with_entities=True, expire_time=15, smart_step=True)
        ents, _ = eo.append_entity(ents, star, active=fire)
        extra["last_fire_time"] = torch.where(fire, state.cur_time, extra["last_fire_time"])
        return state.replace(ents=ents, extra=extra)


register_game("ninja")(Ninja)
