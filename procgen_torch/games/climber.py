"""Climber: a vertical platformer; jump between platforms and collect every
coin (reference games/climber.cpp); counterpart of
``procgen_tpu/games/climber.py``.

The view follows the agent up a tall world (choose_center); walls take one
of four themes per level; enemies patrol their platform and reflect off the
walls; the agent's sprite follows its support and motion.  The enemy's
``ry`` is its radius over the sprite's aspect ratio, read from the PNG
header when the game is built.
"""

from __future__ import annotations

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
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState

COIN_REWARD = 1.0
COMPLETION_BONUS = 10.0

COIN = 1
ENEMY = 5
ENEMY1 = 6
ENEMY2 = 7
PLAYER_JUMP = 9
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13
WALL_MID = 15
WALL_TOP = 16
ENEMY_BARRIER = 19

PATROL_RANGE = 4.0
NUM_WALL_THEMES = 4

GRAVITY = 0.2
MAX_JUMP = 1.5
AIR_CONTROL = 0.15

PLAYER_THEMES = ("Blue", "Green", "Grey", "Red")
MAX_PLATFORMS = 10  # difficulty 2: (2 + 1)^2 + 1
MAX_PLAT_LEN = 11


class Climber(GameDef):
    name = "climber"
    out_of_bounds_object = WALL_MID
    background_group = "platform_backgrounds"
    agent_only_smart = False  # patrolling enemies are smart
    uses_entity_reflect = False  # enemies reflect off grid walls only
    maxspeed = 0.5
    max_jump = MAX_JUMP
    world_h_max = 64
    max_entities = 24  # agent + <= 10 enemies + <= 10 coins
    max_substeps = 8  # fall speed capped at 2 -> int(4 * speed) <= 8
    entity_rotations = "none"
    grid_theme_count = NUM_WALL_THEMES

    def __init__(self, cfg):
        self.easy = cfg.distribution_mode == DistributionMode.easy
        self.world_w = 16 if self.easy else 20  # climber.cpp:233-236
        self.world_w_max = self.world_w
        self.enemy_prob = 0.2 if self.easy else 0.5
        self.enemy_aspect = np.float32(assets.aspect_ratio("platformer/enemySwimming_1.png"))

    def use_block_asset(self, type_):
        # climber.cpp:128-130
        return type_ in (WALL_MID, WALL_TOP)

    def asset_map(self, cfg):
        # climber.cpp:48-88
        def p(stem):
            return [f"platformer/player{t}_{stem}.png" for t in PLAYER_THEMES]

        return {
            O.PLAYER: p("stand"),
            PLAYER_JUMP: p("walk4"),
            PLAYER_RIGHT1: p("walk1"),
            PLAYER_RIGHT2: p("walk2"),
            WALL_TOP: [
                "platformer/tileBlue_05.png", "platformer/tileGreen_05.png",
                "platformer/tileYellow_06.png", "platformer/tileBrown_06.png",
            ],
            WALL_MID: [
                "platformer/tileBlue_08.png", "platformer/tileGreen_08.png",
                "platformer/tileYellow_09.png", "platformer/tileBrown_09.png",
            ],
            ENEMY1: ["platformer/enemySwimming_1.png"],
            ENEMY2: ["platformer/enemySwimming_2.png"],
            COIN: ["platformer/yellowCrystal.png"],
        }

    def grid_themed_types(self):
        # theme_for_grid_obj: walls use wall_theme (climber.cpp:101-106)
        return (WALL_MID, WALL_TOP)

    def grid_theme_state(self, cfg, states):
        return states.extra["wall_theme"]

    def init_extra(self, cfg, num_envs, device):
        def full(v, dtype):
            return torch.full((num_envs,), v, dtype=dtype, device=device)

        return {
            "has_support": full(False, torch.bool),
            "facing_right": full(True, torch.bool),
            "coin_quota": full(0, I32),
            "coins_collected": full(0, I32),
            "wall_theme": full(0, I32),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        return state.replace(
            main_width=torch.full_like(state.main_width, self.world_w),
            main_height=torch.full_like(state.main_height, 64),
        )

    def choose_center(self, cfg, state):
        # climber.cpp:261-265: cy promotes to double through the /2.0
        # literal, narrowed once into the float out-parameter; 5 * ry is a
        # float multiply (int * float) before the promotion
        ents = state.ents
        mw = state.main_width.to(F32)
        cy = fm.narrow(
            fm.wide(cfg, ents.y[:, eo.AGENT])
            + fm.wide(cfg, mw) / 2.0
            - fm.wide(cfg, 5 * ents.ry[:, eo.AGENT])
        )
        return mw / 2, cy, mw

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        return base | (
            (src_type == O.PLAYER) & ((target_type == WALL_MID) | (target_type == WALL_TOP))
        )

    def will_reflect(self, cfg, state, src_type, target_type):
        # climber.cpp:108-110
        return (src_type == ENEMY) & (
            (target_type == WALL_MID) | (target_type == WALL_TOP)
            | (target_type == ENEMY_BARRIER)
        )

    def set_action_xy(self, cfg, state, move_action):
        # climber.cpp:267-289: jump only with support; updates facing and
        # support
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        avy = torch.clamp((move_action % 3 - 1).to(F32), min=0.0)
        extra = dict(state.extra)
        extra["facing_right"] = torch.where(
            avx > 0, True, torch.where(avx < 0, False, extra["facing_right"])
        )
        ents = state.ents
        a = eo.AGENT
        ax, ay = ents.x[:, a], ents.y[:, a]
        arx, ary = ents.rx[:, a], ents.ry[:, a]
        b1 = ph.get_obj_from_floats(state, ax - (arx - 0.01), ay - (ary + 0.01))
        b2 = ph.get_obj_from_floats(state, ax + (arx - 0.01), ay - (ary + 0.01))

        def can_support(t):
            return (t == WALL_MID) | (t == WALL_TOP)  # out of bounds is WALL_MID

        has_support = can_support(b1) | can_support(b2)
        extra["has_support"] = has_support
        avy = torch.where(has_support & (avy == 1), 1.0, 0.0)
        return avx, avy, torch.zeros_like(avx), state.replace(extra=extra)

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # climber.cpp:112-124
        ents = state.ents
        a = eo.AGENT
        has_support = state.extra["has_support"]
        mixrate_x = torch.where(has_support, state.mixrate, state.mixrate * fm.f32(AIR_CONTROL))
        # separate f32 roundings of the mul+add chain (climber.cpp:113)
        vx = fm.fadd32(
            cfg, (1 - mixrate_x) * ents.vx[:, a],
            mixrate_x * state.maxspeed * state.action_vx,
        )
        vy = torch.where(state.action_vy > 0, state.max_jump, ents.vy[:, a])
        vy = torch.where(~has_support & (vy > -2), vy - fm.f32(GRAVITY), vy)
        return state.replace(ents=eo.write_slot(ents, a, vx=vx, vy=vy))

    def entity_image_override(self, cfg, states):
        # image_for_type (climber.cpp:146-160): the agent's animation; the
        # enemies animate in game_step
        ents = states.ents
        has_support = states.extra["has_support"]
        standing = (
            (torch.abs(ents.vx[:, eo.AGENT]) < 0.01) & (states.action_vx == 0) & has_support
        )
        walk1 = (torch.div(states.cur_time, 5, rounding_mode="floor") % 2 == 0) | ~has_support
        agent_img = torch.where(
            ~has_support, PLAYER_JUMP,
            torch.where(standing, O.PLAYER, torch.where(walk1, PLAYER_RIGHT1, PLAYER_RIGHT2)),
        ).to(I32)
        out = ents.image_type.clone()
        out[:, eo.AGENT] = agent_img
        return out

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # climber.cpp:90-99
        t = state.ents.type
        dead = (mask & (t == ENEMY)).any(1)
        coins = mask & (t == COIN)
        n_coins = coins.sum(1).to(I32)
        extra = dict(state.extra)
        extra["coins_collected"] = extra["coins_collected"] + n_coins
        return state.replace(
            ents=state.ents.replace(will_erase=state.ents.will_erase | coins),
            reward=state.reward + n_coins.to(F32) * fm.f32(COIN_REWARD),
            done=state.done | dead,
            extra=extra,
        )

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)
        mw, mh = self.world_w, 64

        ents = eo.write_slot(state.ents, eo.AGENT, rx=0.5, ry=0.5, x=1.5, y=1.5)
        rs, agent_theme = R.rs_randn(rs, 4)  # choose_random_theme(agent)
        ents = eo.write_slot(ents, eo.AGENT, image_theme=agent_theme)
        rs, wall_theme = R.rs_randn(rs, NUM_WALL_THEMES)

        # init_floor_and_walls (climber.cpp:162-167); the grid is [y, x]
        grid = state.grid.clone()
        grid[:, 0, :mw] = WALL_TOP
        grid[:, :mh, 0] = WALL_MID
        grid[:, :mh, mw - 1] = WALL_MID
        grid[:, mh - 1, :mw] = WALL_MID

        # generate_platforms (climber.cpp:176-228)
        rs, difficulty = R.rs_randn(rs, 3)
        min_p = difficulty * difficulty + 1
        max_p = (difficulty + 1) * (difficulty + 1) + 1
        rs, np_r = R.rs_randn(rs, max_p - min_p + 1)
        num_platforms = np_r + min_p
        rs, cx0 = R.rs_randn(rs, mw - 4)
        curr_x = (cx0 + 2).to(torch.int64)
        curr_y = torch.zeros((N,), dtype=torch.int64, device=dev)
        margin_x = 3
        coin_quota = torch.zeros((N,), dtype=I32, device=dev)
        max_dy = int(MAX_JUMP * MAX_JUMP / (2 * GRAVITY))  # 5
        enemy_ry = np.float32(np.float32(0.5) / self.enemy_aspect)  # match_aspect_ratio
        js = torch.arange(MAX_PLAT_LEN, device=dev)

        for i in range(MAX_PLATFORMS):
            on = i < num_platforms
            rs, dy_r = R.rs_randn(rs, max_dy - 3 + 1, active=on)
            delta_y = (dy_r + 3).to(torch.int64)

            can_spawn = on & (curr_x >= margin_x) & (curr_x <= mw - margin_x)
            rs, u_e = R.rs_rand01(rs, active=can_spawn)
            spawn_enemy = can_spawn & (u_e < fm.f32(self.enemy_prob))
            # g++ evaluates add_entity's arguments right to left: the vx
            # draw precedes the y draw (climber.cpp:193)
            rs, vs = R.rs_randn(rs, 2, active=spawn_enemy)
            rs, dy_e = R.rs_randn(rs, 2, active=spawn_enemy)
            ex = curr_x.to(F32) + 0.5
            fields = eo.make_entity(
                ex, (curr_y + dy_e + 2).to(F32) + 0.5,
                fm.f32(0.15) * (vs * 2 - 1).to(F32), 0.0, 0.5, float(enemy_ry), ENEMY,
            )
            fields.update(image_type=ENEMY1, smart_step=True, climber_spawn_x=ex)
            ents, _ = eo.append_entity(ents, fields, active=spawn_enemy)

            curr_y = curr_y + torch.where(on, delta_y, 0)
            rs, pl = R.rs_randn(rs, 10, active=on)
            plat_len = (pl + 2).to(torch.int64)
            rs, vxs = R.rs_randn(rs, 2, active=on)
            vx = (vxs * 2 - 1).to(torch.int64)
            vx = torch.where(curr_x < margin_x, 1, vx)
            vx = torch.where(curr_x > mw - margin_x, -1, vx)

            # candidates: consecutive in-bounds cells (break on the first
            # out-of-bounds one)
            nxs = curr_x[:, None] + (js[None, :] + 1) * vx[:, None]
            in_b = (nxs > 0) & (nxs < mw - 1) & (js[None, :] < plat_len[:, None])
            valid = torch.cumprod(in_b.to(torch.int64), 1).bool()
            n_cand = valid.to(I32).sum(1)
            ycl = curr_y.clamp(0, 63)
            for j in range(MAX_PLAT_LEN):
                xj = nxs[:, j].clamp(0, mw - 1)
                grid[b, ycl, xj] = torch.where(on & valid[:, j], WALL_TOP, grid[b, ycl, xj])

            rs, u_c = R.rs_rand01(rs, active=on)
            place_coin = on & ((u_c < 0.5) | (i == num_platforms - 1))
            rs, ci = R.rs_randn(rs, n_cand.clamp(min=1), active=place_coin)
            coin_x = torch.gather(nxs, 1, ci.to(torch.int64).clamp(0, MAX_PLAT_LEN - 1)[:, None])[:, 0]
            cfields = eo.make_entity(
                coin_x.to(F32) + 0.5, curr_y.to(F32) + 1.5, 0.0, 0.0, 0.3, 0.3, COIN,
            )
            ents, _ = eo.append_entity(ents, cfields, active=place_coin)
            coin_quota = coin_quota + place_coin.to(I32)

            rs, ni = R.rs_randn(rs, n_cand.clamp(min=1), active=on)
            nx = torch.gather(nxs, 1, ni.to(torch.int64).clamp(0, MAX_PLAT_LEN - 1)[:, None])[:, 0]
            curr_x = torch.where(on, nx, curr_x)

        extra = dict(state.extra)
        extra["wall_theme"] = wall_theme.to(I32)
        extra["coin_quota"] = coin_quota
        extra["coins_collected"] = torch.zeros_like(coin_quota)
        extra["has_support"] = torch.zeros_like(extra["has_support"])
        extra["facing_right"] = torch.ones_like(extra["facing_right"])
        return state.replace(ents=ents, grid=grid, extra=extra), rs

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        ents = state.ents
        a = eo.AGENT
        refl = torch.where(
            state.action_vx > 0, False,
            torch.where(state.action_vx < 0, True, ents.is_reflected[:, a]),
        )
        ents = eo.write_slot(ents, a, is_reflected=refl)

        # enemy patrol and animation (climber.cpp:295-311)
        is_enemy = ents.alive & (ents.type == ENEMY)
        over = ents.x > ents.climber_spawn_x + PATROL_RANGE
        under = ents.x < ents.climber_spawn_x - PATROL_RANGE
        vx = torch.where(
            is_enemy & over, -torch.abs(ents.vx),
            torch.where(is_enemy & under, torch.abs(ents.vx), ents.vx),
        )
        anim = torch.where(
            torch.div(state.cur_time, 5, rounding_mode="floor") % 2 == 0, ENEMY1, ENEMY2
        ).to(I32)
        image_type = torch.where(is_enemy, anim[:, None], ents.image_type)
        is_refl = torch.where(is_enemy, vx < 0, ents.is_reflected)
        ents = ents.replace(vx=vx, image_type=image_type, is_reflected=is_refl)

        done_all = state.extra["coin_quota"] == state.extra["coins_collected"]
        return state.replace(
            ents=ents,
            done=state.done | done_all,
            reward=state.reward + torch.where(done_all, fm.f32(COMPLETION_BONUS), 0.0),
            level_complete=state.level_complete | done_all,
        )


register_game("climber")(Climber)
