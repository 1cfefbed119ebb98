"""FruitBot: a vertical scroller -- collect fruit, avoid food, shoot the locks
of the doors in the walls (reference games/fruitbot.cpp); counterpart of
``procgen_tpu/games/fruitbot.py``.

The agent drifts up a 60-high world at constant speed and steers
sideways, under a view that follows it vertically.  Level generation lays
walls with a gap across the world, some with a locked door and its lock,
then fruit and food at random free positions; each object's theme is drawn
in ascending slot order and its box fitted to that theme's sprite aspect
ratio (read from the PNG headers when the game is built).  The agent's key
bullets open a door by hitting its lock (the pair collisions of
``engine/base.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch import telemetry
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import rand_util as ru
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.games import register_game
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0
PENALTY = -4.0

BARRIER = 1
OUT_OF_BOUNDS_WALL = 2
PLAYER_BULLET = 3
BAD_OBJ = 4
GOOD_OBJ = 7
LOCKED_DOOR = 10
LOCK = 11
PRESENT = 12

KEY_DURATION = 8
DOOR_ASPECT_RATIO = 3.25  # fruitbot.cpp:23

WALL_RY = fm.f32(0.3)
LOCK_RX = 0.25
LOCK_RY = fm.f32(0.45)

GOOD_ASSETS = tuple(f"misc_assets/fruit{i}.png" for i in range(1, 7))
BAD_ASSETS = tuple(f"misc_assets/food{i}.png" for i in range(1, 7))


class FruitBot(GameDef):
    name = "fruitbot"
    world_h_max = 60
    maxspeed = 0.85  # fruitbot.cpp:34
    mixrate = 0.5
    out_of_bounds_object = OUT_OF_BOUNDS_WALL
    bg_tile_ratio = -1.0  # fruitbot.cpp:38
    background_group = "topdown_backgrounds"  # fruitbot.cpp:43-45
    uses_pair_collisions = True  # key bullets collide with entities
    max_substeps = 8
    entity_rotations = "axis"  # the agent faces up (-pi/2)

    def __init__(self, cfg):
        easy = cfg.distribution_mode == DistributionMode.easy
        self.world_w = 10 if easy else 20  # choose_world_dim, fruitbot.cpp:150-157
        self.world_w_max = self.world_w
        self.num_walls = 5 if easy else 10  # fruitbot.cpp:203-216
        self.object_group_size = 2 if easy else 6
        self.door_prob = 0.0 if easy else 0.125
        self.min_pct = 0.2 if easy else 0.1
        # agent + 2 barriers per wall + a door and lock on every wall whose
        # gap allows one + presents + 19 good + 19 bad + live key bullets
        parts_total = 60 - 4 * self.num_walls - 4
        max_doors = min(self.num_walls, parts_total // 2)
        self.max_entities = 1 + 2 * self.num_walls + 2 * max_doors + self.world_w + 19 + 19 + 3
        self.reset_max_draws = 2048
        # fit_aspect_ratio uses each theme's sprite aspect (bag.cpp:1025-1036)
        self.good_aspects = [fm.f32(assets.aspect_ratio(n)) for n in GOOD_ASSETS]
        self.bad_aspects = [fm.f32(assets.aspect_ratio(n)) for n in BAD_ASSETS]

    def use_block_asset(self, type_):
        # fruitbot.cpp:137-139
        return type_ in (BARRIER, LOCKED_DOOR, PRESENT)

    def asset_map(self, cfg):
        # fruitbot.cpp:47-79
        return {
            O.PLAYER: ["misc_assets/robot_3Dblue.png"],
            BARRIER: ["misc_assets/tileStone_slope.png"],
            OUT_OF_BOUNDS_WALL: ["misc_assets/tileStone_slope.png"],
            PLAYER_BULLET: ["misc_assets/keyRed2.png"],
            BAD_OBJ: list(BAD_ASSETS),
            GOOD_OBJ: list(GOOD_ASSETS),
            LOCKED_DOOR: ["misc_assets/fenceYellow.png"],
            LOCK: ["misc_assets/lockRed2.png"],
            PRESENT: [f"misc_assets/present{i}.png" for i in range(1, 4)],
        }

    def tile_ratio_for(self, img_type, rx=None, ry=None):
        # get_tile_aspect_ratio (fruitbot.cpp:90-96)
        return torch.where(
            img_type == BARRIER, 1.0,
            torch.where(img_type == LOCKED_DOOR, DOOR_ASPECT_RATIO, 0.0),
        )

    def init_extra(self, cfg, num_envs, device):
        return {"last_fire_time": torch.zeros((num_envs,), dtype=I32, device=device)}

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        return state.replace(
            main_width=torch.full_like(state.main_width, self.world_w),
            main_height=torch.full_like(state.main_height, 60),
        )

    def set_action_xy(self, cfg, state, move_action):
        # fruitbot.cpp:159-163: sideways control, constant upward drift
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        return avx, torch.full_like(avx, fm.f32(0.2)), torch.zeros_like(avx)

    def choose_center(self, cfg, state):
        # fruitbot.cpp:142-146: "cy = agent->y + main_width / 2.0 - 2 *
        # agent->ry" promotes to double through the 2.0 literal and narrows
        # once into the float out-parameter; visibility = main_width
        ents = state.ents
        mw = state.main_width.to(F32)
        y, ry = ents.y[:, eo.AGENT], ents.ry[:, eo.AGENT]
        if cfg.parity_mode:
            f64 = torch.float64
            cy = (y.to(f64) + state.main_width.to(f64) / 2.0 - 2.0 * ry.to(f64)).to(F32)
        else:
            cy = y + mw / 2 - 2 * ry
        return mw / 2, cy, mw

    def _add_walls(self, cfg, state, rs, curr_h, use_door):
        """add_walls (fruitbot.cpp:165-196): the door's numbers are computed
        in every env and selected, in the reference's draw order."""
        mw = fm.f32(self.world_w)
        rs, u_pct = R.rs_rand01(rs)
        # "min_pct + .2 * rand01()": the double literal promotes, one
        # narrowing into the float (fruitbot.cpp:170)
        pct = fm.dmuladd(cfg, u_pct, 0.2, self.min_pct)
        pct_door = pct + fm.f32(0.1)
        # the float chains of fruitbot.cpp:173-174, each op rounded
        f = np.float32
        lock_pct_w = float(f(2) * f(LOCK_RX) / f(self.world_w))
        door_pct_w = float(f(WALL_RY) * f(2) * f(DOOR_ASPECT_RATIO) / f(self.world_w))
        # an IEEE float division, then "2 * lock_pct_w + door_pct_w *
        # num_doors" with separate roundings (fruitbot.cpp:176-177)
        num_doors = torch.ceil(fm.div_const(pct_door - 2 * lock_pct_w, door_pct_w))
        pct = torch.where(use_door, fm.fmuladd32(cfg, door_pct_w, num_doors, 2 * lock_pct_w), pct)

        gapw = pct * mw
        rs, u_w1 = R.rs_rand01(rs)
        w1 = u_w1 * (mw - gapw)
        w2 = (mw - w1) - gapw
        ry = curr_h.to(F32)
        state, _ = eo.add_entity_rxy(state, w1 / 2, ry, 0.0, 0.0, w1 / 2, WALL_RY, BARRIER)
        state, _ = eo.add_entity_rxy(state, mw - w2 / 2, ry, 0.0, 0.0, w2 / 2, WALL_RY, BARRIER)

        rs, is_on_right = R.rs_randn(rs, 2, active=use_door)
        iorf = is_on_right.to(F32)
        # fruitbot.cpp:189-190
        lock_x = fm.fmuladd32(cfg, iorf, gapw - 2 * LOCK_RX, w1 + LOCK_RX)
        door_x = fm.fadd32(cfg, w1 + gapw / 2, -((iorf * 2 - 1) * LOCK_RX))
        state, _ = eo.add_entity_rxy(state, door_x, ry, 0.0, 0.0, gapw / 2 - LOCK_RX, WALL_RY,
                                     LOCKED_DOOR, active=use_door)
        # "(ry - lock_ry) + wall_ry", left to right (fruitbot.cpp:193)
        lock_y = fm.seq(cfg, ry - LOCK_RY) + WALL_RY
        state, _ = eo.add_entity_rxy(state, lock_x, lock_y, 0.0, 0.0, LOCK_RX, LOCK_RY, LOCK,
                                     active=use_door)
        return state, rs

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        mw, mh = self.world_w, 60
        min_sep, buf_h = 4, 4

        space = mh - min_sep * self.num_walls - buf_h
        rs, parts = ru.partition(rs, torch.full((N,), space, dtype=I32, device=dev),
                                 self.num_walls, space)
        curr_h = torch.zeros((N,), dtype=I32, device=dev)
        for k in range(self.num_walls):
            dy = min_sep + parts[:, k]
            curr_h = curr_h + dy
            # "(dy > 5) && rand01() < door_prob": && skips the draw
            rs, u_door = R.rs_rand01(rs, active=dy > 5)
            use_door = (dy > 5) & (u_door < fm.f32(self.door_prob))
            state, rs = self._add_walls(cfg, state, rs, curr_h, use_door)

        ents = eo.write_slot(state.ents, eo.AGENT, y=state.ents.ry[:, eo.AGENT],
                             rotation=fm.f32(-np.pi / 2))
        state = state.replace(ents=ents)

        rs, ng = R.rs_randn(rs, 10)
        num_good = ng + 10
        rs, nb = R.rs_randn(rs, 10)
        num_bad = nb + 10

        for i in range(mw):
            # add_entity, then choose_random_theme (no draw in between)
            rs, th = R.rs_randn(rs, 3)
            present = eo.make_entity(i + 0.5, mh - 0.5, 0.0, 0.0, 0.5, 0.5, PRESENT)
            present["image_theme"] = th
            ents, _ = eo.append_entity(state.ents, present)
            state = state.replace(ents=ents)
        for typ, num in ((GOOD_OBJ, num_good), (BAD_OBJ, num_bad)):
            for i in range(19):
                rs, state, _ = eo.spawn_entity_rxy(
                    rs, state, 0.5, 0.5, typ, 0.0, 0.0, fm.f32(mw), fm.f32(mh), active=i < num)
        state, rs = self._fit_objects(cfg, state, rs)

        extra = dict(state.extra)
        extra["last_fire_time"] = torch.zeros((N,), dtype=I32, device=dev)
        return state.replace(extra=extra), rs

    def _fit_objects(self, cfg, state, rs):
        """The theme and fit_aspect_ratio sweep over fruit and food
        (fruitbot.cpp:243-248, bag.cpp:1025-1036): one draw per object in
        ascending slot order, a loop over the batch's largest object count,
        read once; the boxes are then fitted in one vector op."""
        ents = state.ents
        E = ents.capacity
        slot = torch.arange(E, device=ents.x.device)
        is_obj = ents.alive & ((ents.type == GOOD_OBJ) | (ents.type == BAD_OBJ))
        order = torch.sort(torch.where(is_obj, slot, E + slot), dim=1, stable=True).indices
        count = is_obj.sum(1)
        theme = ents.image_theme
        telemetry.count("host_reads.fruitbot.object_count")
        for k in range(int(count.max())):
            on = k < count
            rs, th = R.rs_randn(rs, self.object_group_size, active=on)
            theme = eo.set_at(theme, order[:, k], th, on)
        ar = torch.where(ents.type == GOOD_OBJ, fm.pick(theme, self.good_aspects),
                         fm.pick(theme, self.bad_aspects))
        wide = ar > 1
        rx = torch.where(is_obj & ~wide, ents.ry * ar, ents.rx)
        ry = torch.where(is_obj & wide, fm.fdiv(cfg, ents.rx, ar), ents.ry)
        return state.replace(ents=ents.replace(image_theme=theme, rx=rx, ry=ry)), rs

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # fruitbot.cpp:98-116; no handler changes the agent's box, so the
        # vectorized mask is exact
        ents = state.ents
        t = ents.type
        hit_barrier = (mask & ((t == BARRIER) | (t == LOCKED_DOOR))).any(1)
        bad = mask & (t == BAD_OBJ)
        good = mask & (t == GOOD_OBJ)
        present = mask & (t == PRESENT)
        reward = (
            state.reward
            + bad.sum(1).to(F32) * fm.f32(PENALTY)
            + good.sum(1).to(F32) * fm.f32(POSITIVE_REWARD)
            + present.sum(1).to(F32) * fm.f32(COMPLETION_BONUS)
        )
        got_present = present.any(1)
        return state.replace(
            ents=ents.replace(will_erase=ents.will_erase | bad | good),
            reward=reward,
            done=state.done | hit_barrier | got_present,
            level_complete=state.level_complete | got_present,
        )

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """fruitbot.cpp:118-135: a key bullet dies on a barrier; on a lock
        it dies with the lock and the door beside it.  Walls are at least 4
        apart in y, so at most one door lies within 1 of a lock, and the
        reference's break at the first door is the masked form."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        src = pair_mask & (t == PLAYER_BULLET)[:, :, None]
        hit_barrier = (src & (t == BARRIER)[:, None, :]).any(2)
        lock_pairs = src & (t == LOCK)[:, None, :]
        lock_hit = lock_pairs.any(1)
        y = ents.y[:, :L]
        near = torch.abs(y[:, :, None] - y[:, None, :]) < 1
        door_hit = (t == LOCKED_DOOR) & ents.alive[:, :L] & (near & lock_hit[:, None, :]).any(2)
        erase = torch.zeros_like(ents.will_erase)
        erase[:, :L] = hit_barrier | lock_pairs.any(2) | lock_hit | door_hit
        return state.replace(ents=ents.replace(will_erase=ents.will_erase | erase))

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        # the key bullet (fruitbot.cpp:253-264)
        extra = dict(state.extra)
        fire = (state.special_action == 1) & (
            state.cur_time - extra["last_fire_time"] >= KEY_DURATION)
        ents = state.ents
        a = eo.AGENT
        key = eo.make_entity(ents.x[:, a], ents.y[:, a], 0.0, 0.5, 0.25, 0.25, PLAYER_BULLET)
        key.update(expire_time=KEY_DURATION, collides_with_entities=True)
        ents, _ = eo.append_entity(ents, key, active=fire)
        extra["last_fire_time"] = torch.where(fire, state.cur_time, extra["last_fire_time"])
        return state.replace(ents=ents, extra=extra)

    def serialize_extra(self, w, s, i):
        # fruitbot.cpp:266-276
        w.write_float(5.0)  # min_dim (constant)
        w.write_float(0.5)  # bullet_vscale (constant)
        w.write_int(s["extra.last_fire_time"][i])

    def deserialize_extra(self, r):
        r.read_float()
        r.read_float()
        return {"last_fire_time": r.read_int()}


register_game("fruitbot")(FruitBot)
