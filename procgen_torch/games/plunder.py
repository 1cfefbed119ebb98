"""Plunder: sink the ships of the target colours, spare the others
(reference games/plunder.cpp); counterpart of
``procgen_tpu/games/plunder.py``.

Ships sail along five lanes, spawned from the per-step stream; the agent
steers along the bottom and fires cannonballs up.  Which two of the six
ship sprites sail in a level, and which of them is the target shown in the
legend, comes from a random permutation (``rand_util.choose_n_erase``);
each ship's ``ry`` is its radius over its sprite's aspect ratio, read from
the PNG headers when the game is built.  A cannonball sinks the highest
slot it hits, in a sequential sweep (the pair collisions of
``engine/base.py``); the juice and progress bars are HUD colour rects.
"""

from __future__ import annotations

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import rand_util as ru
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step, descending_slots
from procgen_torch.games import register_game
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0

PLAYER_BULLET = 1
TARGET_LEGEND = 2
TARGET_BACKGROUND = 3
PANEL = 6
SHIP = 7

NUM_LANES = 5
NUM_SHIP_TYPES = 6
NUM_CURRENT = 2  # num_current_ship_types
TARGET_QUOTA = 20
SPAWN_PROB = fm.f32(0.06)
LEGEND_R = 2.0
KEY_SCALE = 1.5

JUICE_COLOR = (66.0, 245.0, 135.0)  # plunder.cpp:69
PROGRESS_COLOR = (245.0, 66.0, 144.0)

SHIP_ASSETS = tuple(f"misc_assets/ship_{i}.png" for i in range(1, 7))


def spawn_row(lane: torch.Tensor, r_scale: float, main_height: float) -> torch.Tensor:
    """The spawned ship's row, ``(lane * .11f + .4f) * (main_height / 2 -
    r_scale) + main_height / 2`` (plunder.cpp:195-214).  The reference's
    bits are those of the chain in double, narrowed once at the float
    store, in both modes; rounding each float op in turn is an ulp off on
    lane 4 at ``r_scale`` 1 (17.56)."""
    half = main_height / 2
    return fm.narrow((lane.to(torch.float64) * fm.f32(0.11) + fm.f32(0.4)) * (half - r_scale) + half)


class Plunder(GameDef):
    name = "plunder"
    timeout = 4000  # plunder.cpp:35
    world_w_max = 20
    world_h_max = 20
    mixrate = 0.5
    maxspeed = 0.85
    has_useful_vel_info = False
    background_group = "water_surface_backgrounds"
    uses_pair_collisions = True
    max_substeps = 8
    entity_rotations = "axis"  # agent -pi/2, legend pi/2, ships 0
    max_entities = 96

    def __init__(self, cfg):
        self.easy = cfg.distribution_mode == DistributionMode.easy
        self.r_scale = 1.5 if self.easy else 1.0
        # match_aspect_ratio uses each ship's sprite aspect (bag.cpp:1014-1023)
        self.ship_aspects = [fm.f32(assets.aspect_ratio(n)) for n in SHIP_ASSETS]

    def should_preserve_type_themes(self, type_):
        return type_ == SHIP  # plunder.cpp:83-85

    def asset_map(self, cfg):
        # plunder.cpp:49-64, and the explosion frames (bag.cpp:416-427)
        return {
            SHIP: list(SHIP_ASSETS),
            PLAYER_BULLET: ["misc_assets/cannonBall.png"],
            PANEL: ["misc_assets/panel_wood.png"],
            TARGET_BACKGROUND: ["misc_assets/target_red2.png"],
            O.EXPLOSION: ["misc_assets/explosion1.png"],
            O.EXPLOSION + 1: ["misc_assets/explosion2.png"],
            O.EXPLOSION + 2: ["misc_assets/explosion3.png"],
            O.EXPLOSION + 3: ["misc_assets/explosion4.png"],
            O.EXPLOSION + 4: ["misc_assets/explosion5.png"],
        }

    def center_agent(self, cfg):
        return False  # plunder.cpp:177

    def init_extra(self, cfg, num_envs, device):
        def z(*shape, dtype=I32):
            return torch.zeros((num_envs,) + shape, dtype=dtype, device=device)

        return {
            "last_fire_time": z(),
            "lane_directions": z(NUM_LANES, dtype=torch.bool),
            "lane_vels": z(NUM_LANES, dtype=F32),
            "target_bools": z(NUM_SHIP_TYPES, dtype=torch.bool),
            "image_permutation": z(NUM_SHIP_TYPES),
            "targets_hit": z(),
            "juice_left": z(dtype=F32),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, 20)
        return state.replace(main_width=d, main_height=d)

    def set_action_xy(self, cfg, state, move_action):
        # plunder.cpp:110-114: sideways only
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        zero = torch.zeros_like(avx)
        return avx, zero, zero

    def hud_color_rects(self, cfg, states):
        # plunder.cpp:66-77: the juice and progress bars
        mw = states.main_width.to(F32)
        juice = states.extra["juice_left"]
        prog = fm.div_const(states.extra["targets_hit"].to(F32), TARGET_QUOTA)

        def c(v):
            return torch.full_like(mw, v)

        rects = torch.stack([
            torch.stack([c(0.25), c(0.25), mw * juice, c(0.5)], 1),
            torch.stack([c(0.25), c(0.75), mw * prog, c(0.5)], 1),
        ], 1)
        return rects, (JUICE_COLOR, PROGRESS_COLOR)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        mw = 20.0
        r_scale = self.r_scale

        # the ship-image permutation: choose_n over 0..5 (plunder.cpp:135-143);
        # the first num_current / 2 = 1 entries are the targets
        rs, perm, _ = ru.choose_n_erase(
            rs, torch.ones((N, NUM_SHIP_TYPES), dtype=torch.bool, device=dev),
            NUM_SHIP_TYPES, NUM_SHIP_TYPES)
        target = perm[:, 0].to(torch.int64)
        target_bools = torch.arange(NUM_SHIP_TYPES, device=dev)[None, :] == target[:, None]

        dirs, vels = [], []
        for _ in range(NUM_LANES):
            rs, u_d = R.rs_rand01(rs)
            dirs.append(u_d < 0.5)
            rs, u_v = R.rs_rand01(rs)
            # ".15 + .1 * rand01()": double literals, one narrowing on the
            # vector<float> push_back (plunder.cpp:153)
            vels.append(fm.narrow(0.15 + 0.1 * fm.wide(cfg, u_v)))

        if not self.easy:  # the easy ternary skips the draw (plunder.cpp:156)
            rs, num_panels = R.rs_randn(rs, 4)
            for i in range(3):
                rs, state, _ = eo.spawn_entity_rxy(rs, state, 1.2, 0.5, PANEL, 0.0, 0.25 * mw,
                                                   mw, 0.25 * mw, active=i < num_panels)

        # the target legend (plunder.cpp:161-170)
        state, _ = eo.add_entity_rxy(state, LEGEND_R, LEGEND_R, 0.0, 0.0, LEGEND_R, LEGEND_R,
                                     TARGET_BACKGROUND)
        leg_rx = r_scale * KEY_SCALE  # exact in float
        legend = eo.make_entity(
            LEGEND_R, LEGEND_R, 0.0, 0.0, leg_rx,
            fm.fdiv(cfg, torch.full((N,), leg_rx, dtype=F32, device=dev),
                    fm.pick(perm[:, 0], self.ship_aspects)),  # match_aspect_ratio
            TARGET_LEGEND)
        legend.update(image_type=SHIP, image_theme=perm[:, 0], rotation=fm.f32(np.pi / 2))
        ents, _ = eo.append_entity(state.ents, legend)

        # the agent (plunder.cpp:172-189): randn(1) is still drawn
        rs, th_idx = R.rs_randn(rs, NUM_CURRENT // 2)
        agent_theme = torch.gather(perm, 1, (th_idx + NUM_CURRENT // 2).to(torch.int64)[:, None])[:, 0]
        arx = torch.full((N,), r_scale, dtype=F32, device=dev)
        ary = fm.fdiv(cfg, arx, fm.pick(agent_theme, self.ship_aspects))
        ents = eo.write_slot(ents, eo.AGENT, rx=arx, ry=ary, rotation=fm.f32(-np.pi / 2),
                             image_type=SHIP, image_theme=agent_theme)
        state, rs = eo.reposition_agent(cfg, state.replace(ents=ents), rs)
        ents = state.ents
        ax = torch.maximum(ents.x[:, eo.AGENT], 2 * LEGEND_R + arx)
        state = state.replace(ents=eo.write_slot(ents, eo.AGENT, x=ax, y=1 + ary))

        extra = dict(state.extra)
        extra.update(
            last_fire_time=torch.zeros((N,), dtype=I32, device=dev),
            lane_directions=torch.stack(dirs, 1),
            lane_vels=torch.stack(vels, 1),
            target_bools=target_bools,
            image_permutation=perm,
            targets_hit=torch.zeros((N,), dtype=I32, device=dev),
            juice_left=torch.ones((N,), dtype=F32, device=dev),
        )
        return state.replace(extra=extra), rs

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """The reverse sweep (bag.cpp:719-741, plunder.cpp:88-107): a
        cannonball hits the highest live ship or panel it touches, then is
        spent, so kills chain across balls.  The loop runs over each env's
        balls that touch a ship or panel at the start (will_erase only
        grows), descending."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        actionable0 = pair_mask & ((t == SHIP) | (t == PANEL))[:, None, :]
        cand = (t == PLAYER_BULLET) & ~ents.will_erase[:, :L] & actionable0.any(2)
        order, count, n_max = descending_slots(cand)
        idx = torch.arange(L, device=t.device)
        extra = dict(state.extra)
        reward = state.reward
        for k in range(n_max):
            ents = state.ents
            i = order[:, k]
            on = (k < count) & (eo.at(ents.type, i) == PLAYER_BULLET) & ~eo.at(ents.will_erase, i)
            row = torch.gather(actionable0, 1, i[:, None, None].expand(-1, 1, L))[:, 0]
            valid = row & ~ents.will_erase[:, :L] & on[:, None]
            j = torch.where(valid, idx, -1).amax(1)
            hit = j >= 0
            jc = j.clamp(min=0)
            tj = eo.at(ents.type, jc)
            hit_ship = hit & (tj == SHIP)
            hit_panel = hit & (tj == PANEL)
            is_tgt = eo.at(extra["target_bools"], eo.at(ents.image_theme, jc).to(torch.int64))
            scored = hit_ship & is_tgt
            reward = reward + torch.where(scored, fm.f32(POSITIVE_REWARD), 0.0)
            extra["juice_left"] = extra["juice_left"] + torch.where(
                hit_ship, torch.where(is_tgt, fm.f32(0.1), fm.f32(-0.1)), 0.0)
            extra["targets_hit"] = extra["targets_hit"] + scored.to(I32)
            we = eo.set_at(ents.will_erase, i, True, hit_ship | hit_panel)
            ents = ents.replace(will_erase=eo.set_at(we, jc, True, hit_ship))
            # the explosion on the sunk ship (plunder.cpp:104-106)
            rx_j = eo.at(ents.rx, jc)
            expl = eo.make_entity(eo.at(ents.x, jc), eo.at(ents.y, jc), eo.at(ents.vx, jc) / 2,
                                  eo.at(ents.vy, jc) / 2, 0.5 * rx_j, 0.5 * rx_j, O.EXPLOSION)
            ents, _ = eo.append_entity(ents, expl, active=hit_ship)
            state = state.replace(ents=ents)
        return state.replace(extra=extra, reward=reward)

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        extra = dict(state.extra)
        mw = mh = 20.0
        r_scale = self.r_scale
        juice = extra["juice_left"] - fm.f32(0.0015)

        # the ship spawner (plunder.cpp:195-214)
        mt, u = R.mt_rand01(state.rng)
        spawn = u < SPAWN_PROB
        mt, lane = R.mt_randn(mt, NUM_LANES, active=spawn)
        lane_i = lane.to(torch.int64)[:, None]
        ent_y = spawn_row(lane, r_scale, mh)
        moves_right = torch.gather(extra["lane_directions"], 1, lane_i)[:, 0]
        ent_vx = torch.gather(extra["lane_vels"], 1, lane_i)[:, 0] * torch.where(moves_right, 1.0, -1.0)
        mt, ti = R.mt_randn(mt, NUM_CURRENT, active=spawn)
        theme = torch.gather(extra["image_permutation"], 1, ti.to(torch.int64)[:, None])[:, 0]
        ent_x = torch.where(moves_right, -r_scale, mw + r_scale)
        ent_r = torch.full_like(ent_y, r_scale)
        ship = eo.make_entity(ent_x, ent_y, ent_vx, 0.0, r_scale,
                              fm.fdiv(cfg, ent_r, fm.pick(theme, self.ship_aspects)), SHIP)
        ship.update(image_type=SHIP, image_theme=theme, is_reflected=~moves_right)
        clear = ~eo.has_any_collision_mask(state.ents, ship["x"], ship["y"], ent_r,
                                           ship["ry"]).any(1)
        ents, _ = eo.append_entity(state.ents, ship, active=spawn & clear)

        # the cannonball (plunder.cpp:216-222)
        fire = (state.special_action == 1) & (state.cur_time - extra["last_fire_time"] >= 3)
        a = eo.AGENT
        ball = eo.make_entity(ents.x[:, a], ents.y[:, a], 0.0, 1.0, 0.25, 0.25, PLAYER_BULLET)
        ball.update(collides_with_entities=True, expire_time=50)
        ents, _ = eo.append_entity(ents, ball, active=fire)
        extra["last_fire_time"] = torch.where(fire, state.cur_time, extra["last_fire_time"])
        juice = juice - torch.where(fire, fm.f32(0.02), 0.0)

        done = state.done | (juice <= 0)
        extra["juice_left"] = torch.clamp(juice, max=1.0)
        quota = extra["targets_hit"] >= TARGET_QUOTA
        reward = state.reward + torch.where(quota, fm.f32(COMPLETION_BONUS), 0.0)

        # keep clear of the legend (plunder.cpp:237-239)
        ax = torch.maximum(ents.x[:, a], 2 * LEGEND_R + ents.rx[:, a])
        ents = eo.write_slot(ents, a, x=ax)
        return state.replace(
            rng=mt, ents=ents, extra=extra, reward=reward, done=done | quota,
            level_complete=state.level_complete | quota,
        )

    def serialize_extra(self, w, s, i):
        # plunder.cpp:242-258
        w.write_int(s["extra.last_fire_time"][i])
        w.write_vector_bool(s["extra.lane_directions"][i])
        w.write_vector_bool(s["extra.target_bools"][i])
        w.write_vector_int(s["extra.image_permutation"][i])
        w.write_vector_float(s["extra.lane_vels"][i])
        w.write_int(NUM_LANES)
        w.write_int(NUM_CURRENT)
        w.write_int(s["extra.targets_hit"][i])
        w.write_int(TARGET_QUOTA)
        w.write_float(s["extra.juice_left"][i])
        w.write_float(self.r_scale)
        w.write_float(SPAWN_PROB)
        w.write_float(LEGEND_R)
        w.write_float(2 * LEGEND_R + self.r_scale)  # min_agent_x

    def deserialize_extra(self, r):
        out = {"last_fire_time": r.read_int(), "lane_directions": r.read_vector_bool(),
               "target_bools": r.read_vector_bool(), "image_permutation": r.read_vector_int(),
               "lane_vels": r.read_vector_float()}
        r.read_int()  # num_lanes
        r.read_int()  # num_current_ship_types
        out["targets_hit"] = r.read_int()
        r.read_int()  # target_quota
        out["juice_left"] = r.read_float()
        for _ in range(4):
            r.read_float()  # r_scale, spawn_prob, legend_r, min_agent_x
        return out


register_game("plunder")(Plunder)
