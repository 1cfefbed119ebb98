"""Leaper: Frogger-style road and river crossing (reference
games/leaper.cpp); counterpart of ``procgen_tpu/games/leaper.py``.

A static view: the lanes are grid rows baked into the static layer, cars
and logs are non-smart entities, the frog is the only smart entity.  Cars
turn by axis rotation (the 4-bin variant atlas) and the finish line is a
tiled sprite.  A reset pre-rolls the traffic for ``preroll_steps`` spawn
and physics iterations (leaper.cpp:176-180), a Python loop of batched ops.
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
from procgen_torch.state import F32, I32, EnvState

LOG = 1
ROAD = 2
WATER = 3
CAR = 4
FINISH_LINE = 5

MONSTER_RADIUS = fm.f32(0.25)
LOG_RADIUS = fm.f32(0.45)
GOAL_REWARD = 10.0
NSTEP = 5
FROG_ANIMATION_FRAMES = NSTEP
MAX_SPEED = fm.f32(2 / (NSTEP - 1.0))  # 0.5
VEL_DECAY = fm.f32(np.float32(MAX_SPEED / NSTEP))  # 0.1
PI = fm.f32(np.pi)
HALF_PI = fm.f32(np.pi / 2)

MAX_LANES = 5  # difficulty <= 4 plus one extra lane

# profiler span of the reset's traffic pre-roll (read by chip_smoke.py)
PREROLL_SPAN = "procgen_torch.leaper.preroll"


class LeaperGame(GameDef):
    name = "leaper"
    timeout = 500
    maxspeed = MAX_SPEED
    max_jump = MAX_SPEED
    max_entities = 192  # the pre-roll accumulates off-screen spawns
    entity_rotations = "axis"  # cars at 180, frog at 0/90/180/270
    background_group = "topdown_backgrounds"
    reset_max_draws = 4096

    CAR_THEMES = 5

    def use_block_asset(self, type_):
        # leaper.cpp:87-89
        return type_ in (WATER, ROAD)

    def should_preserve_type_themes(self, type_):
        # leaper.cpp:91-93
        return type_ == O.PLAYER

    def asset_map(self, cfg):
        # leaper.cpp:45-67
        return {
            ROAD: ["misc_assets/roadTile6b.png"],
            WATER: ["misc_assets/terrainTile6.png"],
            CAR: [
                "misc_assets/car_yellow_5.png",
                "misc_assets/car_black_1.png",
                "misc_assets/car_blue_2.png",
                "misc_assets/car_green_3.png",
                "misc_assets/car_red_4.png",
            ],
            LOG: ["misc_assets/elementWood044.png"],
            O.PLAYER: [
                "misc_assets/frog1.png",
                "misc_assets/frog2.png",
                "misc_assets/frog4.png",
                "misc_assets/frog6.png",
                "misc_assets/frog7.png",
            ],
            FINISH_LINE: ["misc_assets/finish2.png"],
        }

    def tile_ratio_for(self, img_type, rx=None, ry=None):
        # leaper.cpp:69-75: FINISH_LINE tiles horizontally with ratio 1
        return torch.where(img_type == FINISH_LINE, 1.0, 0.0)

    def image_rect_adjust(self, img_type):
        # leaper.cpp:242-248: the frog sprite is drawn taller, shifted up
        is_p = img_type == O.PLAYER
        zero = torch.zeros(img_type.shape, dtype=F32, device=img_type.device)
        return (
            zero,
            torch.where(is_p, fm.f32(-0.275), 0.0),
            torch.ones_like(zero),
            torch.where(is_p, fm.f32(1.55), 1.0),
        )

    def center_agent(self, cfg):
        return False  # leaper.cpp:125

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        if mode == DistributionMode.easy:
            dim = 9
            self.min_car, self.max_car = 0.03, 0.12
            self.min_log, self.max_log = 0.025, 0.075
            self.max_diff = 3
        elif mode == DistributionMode.extreme:
            dim = 20
            self.min_car, self.max_car = 0.1, 0.3
            self.min_log, self.max_log = 0.1, 0.2
            self.max_diff = 4
        elif mode == DistributionMode.hard:
            dim = 15
            self.min_car, self.max_car = 0.05, 0.2
            self.min_log, self.max_log = 0.05, 0.1
            self.max_diff = 4
        else:
            raise ValueError(f"leaper does not support mode {mode}")
        self.easy = mode == DistributionMode.easy
        self.world_dim = dim
        self.world_w_max = dim
        self.world_h_max = dim
        # leaper.cpp:177: int(main_width / min(min_car_speed, min_log_speed))
        self.preroll_steps = int(dim / min(self.min_car, self.min_log))

    def init_extra(self, cfg, num_envs, device):
        def zi():
            return torch.zeros((num_envs,), dtype=I32, device=device)

        def z5():
            return torch.zeros((num_envs, MAX_LANES), dtype=F32, device=device)

        return {
            "bottom_road_y": zi(),
            "road_lane_speeds": z5(),
            "n_road": zi(),
            "bottom_water_y": zi(),
            "water_lane_speeds": z5(),
            "n_water": zi(),
            "goal_y": zi(),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        wd = torch.full_like(state.main_width, self.world_dim)
        return state.replace(main_width=wd, main_height=wd)

    @staticmethod
    def _rand_sign(rs, active=None):
        rs, r = R.rs_rand01(rs, active=active)
        return rs, torch.where(r < 0.5, 1.0, -1.0)

    def _choose_extra_space(self, rs, n, dev):
        if self.easy:
            return rs, torch.zeros((n,), dtype=I32, device=dev)
        return R.rs_randn(rs, 2)

    def _spawn_lane(self, rs, ents, lane_on, speed, y, radius, rx, type_, prob_div, W):
        """One lane of spawn_entities (leaper.cpp:185-215): a spawn roll, a
        car theme, and an append where the spawn box is free.  The entity
        enters ``radius`` outside the world; its box is rx by radius."""
        rs, u = R.rs_rand01(rs, active=lane_on)
        spawn = lane_on & (u < fm.div_const(torch.abs(speed), prob_div))
        x = torch.where(speed > 0, -radius, W + radius)
        fields = eo.make_entity(x, y, speed, 0.0, rx, radius, type_)
        if type_ == CAR:
            rs, theme = R.rs_randn(rs, self.CAR_THEMES, active=spawn)
            fields["image_theme"] = theme
            fields["rotation"] = torch.where(speed < 0, PI, 0.0)
        free = ~eo.has_any_collision_mask(
            ents, fields["x"], fields["y"], fields["rx"], fields["ry"]
        ).any(1)
        ents, _ = eo.append_entity(ents, fields, spawn & free)
        return rs, ents

    def _spawn_entities(self, rs, state: EnvState):
        """leaper.cpp:185-215; draws and spawns are masked per lane."""
        ex = state.extra
        W = state.main_width.to(F32)
        ents = state.ents
        road_y = ex["bottom_road_y"].to(F32)
        for lane in range(MAX_LANES):
            rs, ents = self._spawn_lane(
                rs, ents, lane < ex["n_road"], ex["road_lane_speeds"][:, lane],
                road_y + lane + 0.5, MONSTER_RADIUS, 2 * MONSTER_RADIUS, CAR, 6.0, W,
            )
        water_y = ex["bottom_water_y"].to(F32)
        for lane in range(MAX_LANES):
            rs, ents = self._spawn_lane(
                rs, ents, lane < ex["n_water"], ex["water_lane_speeds"][:, lane],
                water_y + lane + 0.5, LOG_RADIUS, LOG_RADIUS, LOG, 2.0, W,
            )
        return rs, state.replace(ents=ents)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        state = state.replace(
            ents=eo.write_slot(state.ents, eo.AGENT, y=state.ents.ry[:, eo.AGENT])
        )

        # lanes (leaper.cpp:146-174)
        rs, extra0 = self._choose_extra_space(rs, N, dev)
        bottom_road_y = extra0 + 1
        rs, difficulty = R.rs_randn(rs, self.max_diff + 1)
        if self.easy:
            extra_lane_option = torch.zeros((N,), dtype=I32, device=dev)
        else:
            rs, extra_lane_option = R.rs_randn(rs, 4)

        n_road = difficulty + (extra_lane_option == 2).to(I32)
        road_speeds = []
        for lane in range(MAX_LANES):
            act = lane < n_road
            rs, sgn = self._rand_sign(rs, active=act)
            rs, spd = R.rs_randrange(rs, self.min_car, self.max_car, active=act)
            road_speeds.append(torch.where(act, sgn * spd, 0.0))

        rs, extra1 = self._choose_extra_space(rs, N, dev)
        bottom_water_y = bottom_road_y + n_road + extra1 + 1
        n_water = difficulty + (extra_lane_option == 3).to(I32)
        water_speeds = []
        rs, curr_sign = self._rand_sign(rs)
        for lane in range(MAX_LANES):
            act = lane < n_water
            rs, spd = R.rs_randrange(rs, self.min_log, self.max_log, active=act)
            water_speeds.append(torch.where(act, curr_sign * spd, 0.0))
            curr_sign = torch.where(act, -curr_sign, curr_sign)

        goal_y = bottom_water_y + n_water + 1

        # grid lane rows
        W = self.world_dim
        ys = torch.arange(W, device=dev)[None, :, None]

        def rows(lo, n):
            return (ys >= lo[:, None, None]) & (ys < (lo + n)[:, None, None])

        grid = torch.where(
            rows(bottom_road_y, n_road), ROAD,
            torch.where(rows(bottom_water_y, n_water), WATER, O.SPACE),
        )
        grid = grid.to(I32).expand(N, W, W).contiguous()

        extra = dict(state.extra)
        extra.update(
            bottom_road_y=bottom_road_y,
            road_lane_speeds=torch.stack(road_speeds, 1),
            n_road=n_road,
            bottom_water_y=bottom_water_y,
            water_lane_speeds=torch.stack(water_speeds, 1),
            n_water=n_water,
            goal_y=goal_y,
        )
        state = state.replace(grid=grid, extra=extra)

        # pre-roll (leaper.cpp:176-180): spawn + step entities repeatedly so
        # traffic reaches steady state; the first erase happens on the first
        # real step, as in the reference.  The frog stands still on row 0,
        # open in every level (the lanes start at row 1), so no probe of its
        # sub-steps is blocked and basic_step_object leaves it bit for bit
        # as it was: step_entities reduces to the Euler update of every live
        # slot (cars and logs are not smart, the frog's update does not move
        # it), one batched op group per iteration instead of the sub-steps'
        # two thousand.
        with torch.profiler.record_function(PREROLL_SPAN):
            for _ in range(self.preroll_steps):
                rs, state = self._spawn_entities(rs, state)
                ents = state.ents
                state = state.replace(ents=ph.entity_euler_step_all(ents, ents.alive))

        # finish line entity (leaper.cpp:182)
        fields = eo.make_entity(
            W / 2.0, goal_y.to(F32) - 0.5, 0.0, 0.0, W / 2.0, 0.5, FINISH_LINE
        )
        ents, _ = eo.append_entity(state.ents, fields)
        return state.replace(ents=ents), rs

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # leaper.cpp:225-240: discrete hops with linear decay
        ents = state.ents
        a = eo.AGENT
        vx, vy = ents.vx[:, a], ents.vy[:, a]
        still = (vx == 0) & (vy == 0)
        avx, avy = state.action_vx, state.action_vy
        hop_x = still & (avx != 0)
        hop_y = still & ~hop_x & (avy != 0)
        vx = torch.where(hop_x, MAX_SPEED * avx, vx)
        vy = torch.where(hop_y, MAX_SPEED * avy, vy)
        theme = torch.where(hop_x | hop_y, 1, ents.image_theme[:, a]).to(I32)
        rot = torch.where(
            hop_x,
            torch.where(vx > 0, HALF_PI, -HALF_PI),
            torch.where(hop_y, torch.where(vy > 0, 0.0, PI), ents.rotation[:, a]),
        )

        def decay(v):
            return torch.clamp(torch.abs(v) - VEL_DECAY, min=0.0) * fm.fsign(v)

        return state.replace(
            ents=eo.write_slot(
                ents, a, vx=decay(vx), vy=decay(vy), image_theme=theme, rotation=rot
            )
        )

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # leaper.cpp:77-85
        ents = state.ents
        a = eo.AGENT
        car_hit = (mask & (ents.type == CAR)).any(1)
        still = (ents.vx[:, a] == 0) & (ents.vy[:, a] == 0)
        goal_hit = (mask & (ents.type == FINISH_LINE)).any(1) & still
        return state.replace(
            done=state.done | car_hit | goal_hit,
            reward=state.reward + torch.where(goal_hit, GOAL_REWARD, 0.0),
            level_complete=state.level_complete | goal_hit,
        )

    def game_step(self, cfg, state: EnvState) -> EnvState:
        a = eo.AGENT
        # the frog animation advances before the base step (leaper.cpp:250-253)
        theme = state.ents.image_theme[:, a]
        theme = torch.where(theme >= 1, (theme + 1) % FROG_ANIMATION_FRAMES, theme)
        state = state.replace(ents=eo.write_slot(state.ents, a, image_theme=theme))

        state = base_game_step(self, cfg, state)
        rs, state = self._spawn_entities(state.rng, state)
        state = state.replace(rng=rs)

        # log riding (leaper.cpp:259-278): forward scan, the last match wins
        ents = state.ents
        ax, ay = ents.x[:, a], ents.y[:, a]
        on_log = (
            ents.alive
            & (ents.type == LOG)
            & eo.entity_vs_all(ents, ax, ay, ents.rx[:, a], ents.ry[:, a], -ents.rx[:, a])
        )
        standing = on_log.any(1)
        slot = torch.arange(ents.capacity, device=ax.device)
        last = torch.where(on_log, slot, -1).amax(1).clamp(min=0)
        log_vx = torch.gather(ents.vx, 1, last[:, None])[:, 0]

        in_water = ph.get_obj(state, ax.to(I32), ay.to(I32)) == WATER
        still = (ents.vx[:, a] == 0) & (ents.vy[:, a] == 0)
        drown = in_water & ~standing & still

        new_ax = torch.where(standing, ax + log_vx, ax)
        state = state.replace(ents=eo.write_slot(ents, a, x=new_ax))
        oob = eo.is_out_of_bounds(
            new_ax, ay, ents.rx[:, a], ents.ry[:, a], state.main_width, state.main_height
        )
        return state.replace(done=state.done | drown | oob)


register_game("leaper")(LeaperGame)
