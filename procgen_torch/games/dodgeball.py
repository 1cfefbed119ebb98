"""Dodgeball: Berzerk-like rooms with lava walls and ball-throwing enemies
(reference games/dodgeball.cpp); counterpart of
``procgen_tpu/games/dodgeball.py``.

Level generation splits the world into rooms with lava walls, places the
exit door and the agent by rejection sampling (``entity_ops.reposition``)
and spawns the enemies.  In the step the enemies reflect off the lava walls
(the entity-reflect sweep of ``engine/physics.py``), enemies absorb the
agent's balls and lava walls erase balls (the pair collisions of
``engine/base.py``), and the enemies' AI runs in reverse slot order on the
per-step random stream.  The door opens once every enemy is dead.
"""

from __future__ import annotations

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step, descending_slots
from procgen_torch.games import register_game
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0
ENEMY_REWARD = 2.0

LAVA_WALL = 1
PLAYER_BALL = 3
ENEMY = 4
DOOR = 5
ENEMY_BALL = 6
DOOR_OPEN = 7
DUST_CLOUD = 8
OOB_WALL = 10

NUM_ENEMY_THEMES = 7
ENEMY_VEL = fm.f32(0.05)
PI = float(np.float32(np.pi))  # the reference's `const float PI` (cpp-utils.h:12)
# "const float BALL_V_ROT = PI * 0.23f" (dodgeball.cpp:24): a float product,
# not the double-narrowed value (they differ by 1 ulp)
BALL_V_ROT = float(np.float32(np.float32(PI) * np.float32(0.23)))

MAX_ROOMS = 40  # 1 + 2 per split, <= 16 splits

ENEMY_SWEEP_SPAN = "procgen_torch.dodgeball.enemy_sweep"


class Dodgeball(GameDef):
    name = "dodgeball"
    mixrate = 0.5
    out_of_bounds_object = OOB_WALL
    background_group = "topdown_backgrounds"
    uses_pair_collisions = True
    uses_entity_reflect = True  # enemies bounce off lava-wall entities
    max_smart_entities = 24  # agent + <= 19 enemies
    agent_only_smart = False  # enemies are smart_step
    entity_rotations = "free"  # diagonal facing, spinning balls
    max_substeps = 8

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        # dodgeball.cpp:279-313: the constants follow the reference's
        # float-with-double-literal chains, e.g. hard thickness =
        # float(float(0.3f) * 1.5) = 0.45000002, not float32(0.45)
        thickness, enemy_r, exit_r = np.float32(0.3), np.float32(0.5), np.float32(0.75)
        ball_r, ball_vscale = np.float32(0.25), np.float32(0.25)
        max_extra_enemies = 3
        scale = None
        if mode == DistributionMode.easy:
            self.num_iterations, scale = 2, 2.0
            self.maxspeed, self.agent_r = 0.75, 1.0
            exit_r = np.float32(exit_r * np.float64(2))
        elif mode == DistributionMode.hard:
            self.num_iterations, scale = 4, 1.5
            self.maxspeed, self.agent_r = 0.5, 0.75
        elif mode == DistributionMode.extreme:
            self.num_iterations = 8
            self.maxspeed, self.agent_r = 0.25, 0.4  # the base spawn radius
        elif mode == DistributionMode.memory:
            self.num_iterations, scale = 16, 1.5
            self.maxspeed, self.agent_r = 0.5, 0.75
            max_extra_enemies = 16
        else:
            raise ValueError(f"dodgeball does not support mode {mode}")
        if scale is not None:
            thickness, enemy_r, ball_r, ball_vscale = (
                np.float32(v * np.float64(scale)) for v in (thickness, enemy_r, ball_r, ball_vscale)
            )
        self.memory = mode == DistributionMode.memory
        self.world_dim = 40 if self.memory else 20
        self.world_w_max = self.world_dim
        self.world_h_max = self.world_dim
        self.thickness = float(thickness)
        self.enemy_r = float(enemy_r)
        self.exit_r = float(exit_r)
        self.ball_r = float(ball_r)
        self.ball_vscale = float(ball_vscale)
        self.max_extra_enemies = max_extra_enemies
        self.max_enemies = 3 + max_extra_enemies
        # the reference package's expressions, read as float32
        self.hard_min_dim = fm.f32(4 * self.agent_r + 2 * thickness + 0.5)
        self.min_dim = fm.f32(self.agent_r * 8 + 0.5)
        # agent + walls + door + enemies + enemy balls + player balls + dust
        self.max_entities = 1 + self.num_iterations + 1 + 2 * self.max_enemies + 16 + 8
        self.reset_max_draws = 1024

    def use_block_asset(self, type_):
        # dodgeball.cpp:153-155
        return type_ in (LAVA_WALL, DOOR, DOOR_OPEN)

    def asset_map(self, cfg):
        # dodgeball.cpp:50-90; only enemy themes 0-6 are ever drawn
        # (enemy_theme = randn(7), dodgeball.cpp:359)
        return {
            O.PLAYER: ["misc_assets/character12.png"],
            PLAYER_BALL: ["misc_assets/ball_soccer1.png"],
            ENEMY: [f"misc_assets/character{i}.png" for i in range(1, 8)],
            DOOR: ["misc_assets/blockRed.png"],
            ENEMY_BALL: ["misc_assets/ball_soccer2.png"],
            DOOR_OPEN: ["misc_assets/blockGreen.png"],
            LAVA_WALL: ["misc_assets/tileStone_slope2.png"],
            OOB_WALL: ["misc_assets/tileStone_slope2.png"],
            DUST_CLOUD: [f"misc_assets/spaceEffect{i}.png" for i in range(1, 10)],
        }

    def center_agent(self, cfg):
        return self.memory  # dodgeball.cpp:262

    def tile_ratio_for(self, img_type, rx=None, ry=None):
        # lava walls tile along their long axis (dodgeball.cpp:249-255)
        return torch.where(img_type == LAVA_WALL, torch.where(rx > ry, 1.0, -1.0), 0.0)

    def entity_image_override(self, cfg, states):
        # image_for_type: the door opens once every enemy is dead
        # (dodgeball.cpp:92-98)
        ents = states.ents
        door = torch.where(states.extra["num_enemies"] == 0, DOOR_OPEN, DOOR)[:, None]
        return torch.where(ents.type == DOOR, door, ents.image_type).to(I32)

    def will_reflect(self, cfg, state, src_type, target_type):
        # dodgeball.cpp:100-102
        return (src_type == ENEMY) & ((target_type == LAVA_WALL) | (target_type == OOB_WALL))

    def init_extra(self, cfg, num_envs, device):
        return {
            "last_fire_time": torch.zeros((num_envs,), dtype=I32, device=device),
            "num_enemies": torch.zeros((num_envs,), dtype=I32, device=device),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, self.world_dim)
        return state.replace(main_width=d, main_height=d)

    def _split_rooms(self, cfg, state, rs):
        """The recursive room split (dodgeball.cpp:157-224, 315-323): each
        iteration erases a random room (an ordered vector::erase), adds a
        lava wall across it and up to three smaller rooms."""
        N = state.num_envs
        dev = state.done.device
        thickness, min_dim, hard_min = self.thickness, self.min_dim, self.hard_min_dim
        rooms = torch.zeros((N, MAX_ROOMS, 4), dtype=F32, device=dev)
        rooms[:, 0, 2:] = float(self.world_dim)
        count = torch.ones((N,), dtype=I32, device=dev)
        ar = torch.arange(MAX_ROOMS, device=dev)

        def add_room(rooms, count, rect, ok):
            rw, rh = rect[:, 2], rect[:, 3]
            ok = ok & ((rw >= min_dim) | (rh >= min_dim)) & (rw >= hard_min) & (rh >= hard_min)
            dest = (ar[None, :] == count.clamp(max=MAX_ROOMS - 1)[:, None]) & ok[:, None]
            return torch.where(dest[..., None], rect[:, None, :], rooms), count + ok.to(I32)

        for _ in range(self.num_iterations):
            nonempty = count > 0
            rs, idx = R.rs_randn(rs, count.clamp(min=1), active=nonempty)
            idx = idx.to(torch.int64)
            room = torch.gather(rooms, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
            src = torch.where(ar[None, :] >= idx[:, None], (ar + 1).clamp(max=MAX_ROOMS - 1), ar)
            erased = torch.gather(rooms, 1, src[..., None].expand(-1, -1, 4))
            rooms = torch.where(nonempty[:, None, None], erased, rooms)
            count = count - nonempty.to(I32)

            # split_room(room, thickness) (dodgeball.cpp:165-224)
            rs, u1 = R.rs_rand01(rs, active=nonempty)
            rs, u2 = R.rs_rand01(rs, active=nonempty)
            rx, ry, rw, rh = room.unbind(1)
            split_w = torch.where(rh < min_dim, True, torch.where(rw < min_dim, False, u1 < 0.5))
            choice2 = u2 < 0.5
            rs, g = R.rs_randn(rs, 3, active=nonempty)
            pct = 1 - 0.25 * (g + 1).to(F32)

            # the wall along y (split_w) or along x
            wy = torch.where(choice2, ry, ry + (1 - pct) * rh)
            remy = torch.where(choice2, ry + pct * rh, ry)
            wh = pct * rh
            wx = torch.where(choice2, rx, rx + (1 - pct) * rw)
            remx = torch.where(choice2, rx + pct * rw, rx)
            ww = pct * rw
            wall_x = torch.where(split_w, wx + ww / 2, rx + rw / 2)
            wall_y = torch.where(split_w, ry + rh / 2, wy + wh / 2)
            wall_rx = torch.where(split_w, ww / 2, thickness)
            wall_ry = torch.where(split_w, thickness, wh / 2)
            state, _ = eo.add_entity_rxy(state, wall_x, wall_y, 0.0, 0.0, wall_rx, wall_ry,
                                         LAVA_WALL, active=nonempty)

            nextw = rw / 2 - thickness
            nexth = rh / 2 - thickness
            sw = split_w[:, None]
            r1 = torch.where(sw, torch.stack([wx, ry, ww, nexth], 1),
                             torch.stack([rx, wy, nextw, wh], 1))
            r2 = torch.where(sw, torch.stack([wx, ry + rh / 2 + thickness, ww, nexth], 1),
                             torch.stack([rx + rw / 2 + thickness, wy, nextw, wh], 1))
            r3 = torch.where(sw, torch.stack([remx, ry, rw - ww, rh], 1),
                             torch.stack([rx, remy, rw, rh - wh], 1))
            for r in (r1, r2, r3):
                rooms, count = add_room(rooms, count, r, nonempty)
        return state, rs

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        mw = float(self.world_dim)
        ents = eo.write_slot(state.ents, eo.AGENT, rx=self.agent_r, ry=self.agent_r)
        state, rs = self._split_rooms(cfg, state.replace(ents=ents), rs)

        # the exit door on a random border wall (dodgeball.cpp:327-341)
        exit_r = self.exit_r
        doorlen = 2 * exit_r
        rs, wall_choice = R.rs_randn(rs, 4)
        boxes = np.float32([
            [0.0, 0.0, mw, 2 * exit_r],
            [0.0, mw - 2 * exit_r, mw, 2 * exit_r],
            [0.0, 0.0, 2 * exit_r, mw],
            [mw - 2 * exit_r, 0.0, 2 * exit_r, mw],
        ])  # each entry exact in float32
        box = torch.as_tensor(boxes).to(dev)[wall_choice.to(torch.int64)]
        horiz = wall_choice < 2
        d_rx = torch.where(horiz, doorlen / 2, exit_r).to(F32)
        d_ry = torch.where(horiz, exit_r, doorlen / 2).to(F32)
        rs, state, _ = eo.spawn_entity_rxy(rs, state, d_rx, d_ry, DOOR, *box.unbind(1))

        state, rs = eo.reposition_agent(cfg, state, rs)

        # enemies (dodgeball.cpp:345-367)
        rs, ne = R.rs_randn(rs, self.max_extra_enemies + 1)
        num_enemies = ne + 3
        first_enemy = state.ents.alive.sum(1)
        for i in range(self.max_enemies):
            rs, state, _ = eo.spawn_entity_rxy(
                rs, state, self.enemy_r, self.enemy_r, ENEMY, 0.0, 0.0, mw, mw,
                active=i < num_enemies,
            )
        rs, enemy_theme = R.rs_randn(rs, NUM_ENEMY_THEMES)

        # configure each enemy in ascending slot order (its draws in turn);
        # the enemies sit in consecutive slots after the door.  Each faces
        # its velocity, computed once for every configured slot after the
        # loop (no later write changes a configured slot's velocity)
        ents = state.ents
        configured = torch.zeros_like(ents.alive)
        for k in range(self.max_enemies):
            on = k < num_enemies
            i = (first_enemy + k).clamp(max=ents.capacity - 1)
            rs, vx, vy, spawn_t = _choose_vel(rs, on)
            upd = dict(
                image_theme=enemy_theme, health=torch.ones_like(vx),
                fire_time=torch.full_like(ne, 10), spawn_time=spawn_t,
                collides_with_entities=torch.ones_like(on), smart_step=torch.ones_like(on),
                vx=vx, vy=vy,
            )
            ents = ents.replace(**{f: eo.set_at(getattr(ents, f), i, v, on) for f, v in upd.items()})
            configured = eo.set_at(configured, i, True, on)
        ents = ents.replace(rotation=torch.where(
            configured, fm.face_rotation(ents.vx, ents.vy), ents.rotation))
        is_wall = ents.alive & (ents.type == LAVA_WALL)
        ents = ents.replace(collides_with_entities=ents.collides_with_entities | is_wall)
        ents = eo.write_slot(ents, eo.AGENT, rotation=0.0)  # face_direction(1, 0)

        extra = dict(state.extra)
        extra["last_fire_time"] = torch.zeros((N,), dtype=I32, device=dev)
        extra["num_enemies"] = num_enemies.to(I32)
        return state.replace(ents=ents, extra=extra), rs

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # dodgeball.cpp:104-120
        t = state.ents.type
        deadly = (mask & ((t == ENEMY) | (t == ENEMY_BALL) | (t == LAVA_WALL))).any(1)
        door_hit = (mask & (t == DOOR)).any(1) & (state.extra["num_enemies"] == 0)
        return state.replace(
            done=state.done | deadly | door_hit,
            reward=state.reward + torch.where(door_hit, fm.f32(COMPLETION_BONUS), 0.0),
            level_complete=state.level_complete | door_hit,
        )

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """dodgeball.cpp:122-151.  First the enemies, in descending slot
        order, each absorb their highest-index colliding player ball (health
        1: one ball kills, leaving a dust cloud); the loop runs over each
        env's enemies that touch a live ball at the start (will_erase only
        grows).  Then lava walls erase every remaining colliding ball."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        enemy = (t == ENEMY) & ents.alive[:, :L] & ~ents.will_erase[:, :L]
        ball = (t == PLAYER_BALL) & ~ents.will_erase[:, :L]
        order, count, n_max = descending_slots(enemy & (pair_mask & ball[:, None, :]).any(2))
        idx = torch.arange(L, device=t.device)
        for k in range(n_max):
            ents = state.ents
            i = order[:, k]
            on = (k < count) & (eo.at(ents.type, i) == ENEMY) & eo.at(ents.alive, i) & ~eo.at(
                ents.will_erase, i)
            row = torch.gather(pair_mask, 1, i[:, None, None].expand(-1, 1, L))[:, 0]
            valid = row & ~ents.will_erase[:, :L] & on[:, None] & (ents.type[:, :L] == PLAYER_BALL)
            j = torch.where(valid, idx, -1).amax(1)
            hit = j >= 0
            health = eo.at(ents.health, i) - torch.where(hit, 1.0, 0.0)
            kill = hit & (health <= 0)
            we = eo.set_at(ents.will_erase, j.clamp(min=0), True, hit)  # the ball is consumed
            ents = ents.replace(
                health=eo.set_at(ents.health, i, health, on),
                will_erase=eo.set_at(we, i, True, kill),
            )
            # the dust cloud (spawn_child, choose_step_random_theme)
            rx_i = eo.at(ents.rx, i)
            dust = eo.make_entity(eo.at(ents.x, i), eo.at(ents.y, i), 0.0, 0.0, rx_i, rx_i, DUST_CLOUD)
            dust.update(vrot=fm.f32(PI / 0.3), grow_rate=fm.f32(1.0 / 1.2), expire_time=4,
                        alpha_decay=0.9, image_theme=state.step_rand_int % 9)
            ents, _ = eo.append_entity(ents, dust, active=kill)
            state = state.replace(
                ents=ents, reward=state.reward + torch.where(kill, fm.f32(ENEMY_REWARD), 0.0)
            )

        ents = state.ents
        t = ents.type[:, :L]
        wall_src = (t == LAVA_WALL) & ents.alive[:, :L]
        hit_by_wall = (pair_mask & wall_src[:, :, None]).any(1)
        is_ball = (t == PLAYER_BALL) | (t == ENEMY_BALL)
        erase = torch.zeros_like(ents.will_erase)
        erase[:, :L] = hit_by_wall & is_ball & ~ents.will_erase[:, :L]
        return state.replace(ents=ents.replace(will_erase=ents.will_erase | erase))

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        extra = dict(state.extra)
        mw = float(self.world_dim)
        a = eo.AGENT

        # the agent faces its last move and fires (dodgeball.cpp:424-437)
        lma = state.last_move_action
        vx = (torch.div(lma, 3, rounding_mode="floor") - 1).to(F32)
        vy = (lma % 3 - 1).to(F32)
        moving = (vx != 0) | (vy != 0)
        rot = torch.where(moving, fm.face_rotation(vx, vy), state.ents.rotation[:, a])
        ents = eo.write_slot(state.ents, a, rotation=rot)
        fire = (state.special_action == 1) & (state.cur_time - extra["last_fire_time"] >= 7)
        ball = eo.make_entity(ents.x[:, a], ents.y[:, a], vx * self.ball_vscale,
                              vy * self.ball_vscale, self.ball_r, self.ball_r, PLAYER_BALL)
        ball.update(collides_with_entities=True, expire_time=50, vrot=BALL_V_ROT)
        ents, _ = eo.append_entity(ents, ball, active=fire)
        extra["last_fire_time"] = torch.where(fire, state.cur_time, extra["last_fire_time"])
        state = state.replace(ents=ents, extra=extra)

        with torch.profiler.record_function(ENEMY_SWEEP_SPAN):
            state = self._enemy_sweep(cfg, state)

        # the second erase_if_needed (dodgeball.cpp:487)
        ents = eo.compact(state.ents, state.main_width, state.main_height)
        extra = dict(state.extra)
        extra["num_enemies"] = (ents.alive & (ents.type == ENEMY)).sum(1).to(I32)
        return state.replace(ents=ents, extra=extra)

    def _enemy_sweep(self, cfg, state: EnvState) -> EnvState:
        """The enemy AI (dodgeball.cpp:439-485): slots in reverse order, the
        draws in that order on the per-step stream.  Only enemies draw, move
        or fire, so the loop runs over each env's enemies, descending; the
        balls appended by this loop sit past every slot it visits.  Balls
        that were live at the start die on the world border, one vector op
        (each depends on its own slot only)."""
        ents = state.ents
        a = eo.AGENT
        mw = float(self.world_dim)
        vs = self.ball_vscale
        agent_x, agent_y = ents.x[:, a], ents.y[:, a]
        is_ball = ents.alive & ((ents.type == PLAYER_BALL) | (ents.type == ENEMY_BALL))
        oob = (
            (ents.x < ents.rx) | (ents.x > mw - ents.rx)
            | (ents.y < ents.ry) | (ents.y > mw - ents.ry)
        )
        ents = ents.replace(will_erase=ents.will_erase | (is_ball & oob))
        swept = ents.alive & (ents.type == ENEMY)
        order, count, n_max = descending_slots(swept)
        mt = state.rng
        for k in range(n_max):
            i = order[:, k]
            on = k < count
            sp = eo.at(ents.spawn_time, i)
            respawn = on & (sp == 0)
            mt, vx_n, vy_n, st_n = _choose_vel(mt, respawn)
            evx = torch.where(respawn, vx_n, eo.at(ents.vx, i))
            evy = torch.where(respawn, vy_n, eo.at(ents.vy, i))
            spawn_t = torch.where(respawn, st_n, sp - 1)

            ex, ey = eo.at(ents.x, i), eo.at(ents.y, i)
            can_fire = on & (state.cur_time - eo.at(ents.fire_time, i) >= 50)
            bvelx = torch.where(ex < agent_x, 1.0, -1.0)
            bvely = torch.where(ey < agent_y, 1.0, -1.0)
            fire_v = can_fire & (torch.abs(ex - agent_x) < 1)
            fire_h = can_fire & ~fire_v & (torch.abs(ey - agent_y) < 1)
            do_fire = fire_v | fire_h
            eball = eo.make_entity(ex, ey, torch.where(fire_v, 0.0, bvelx) * vs,
                                   torch.where(fire_v, bvely, 0.0) * vs,
                                   self.ball_r, self.ball_r, ENEMY_BALL)
            eball.update(vrot=BALL_V_ROT, expire_time=50)
            mt, ft = R.mt_randn(mt, 4, active=do_fire)
            evx = torch.where(fire_v, 0.0, torch.where(fire_h, bvelx * ENEMY_VEL, evx))
            evy = torch.where(fire_v, bvely * ENEMY_VEL, torch.where(fire_h, 0.0, evy))
            fire_time = torch.where(do_fire, state.cur_time + ft, eo.at(ents.fire_time, i))
            upd = dict(vx=evx, vy=evy, spawn_time=spawn_t, fire_time=fire_time)
            ents = ents.replace(**{f: eo.set_at(getattr(ents, f), i, v, on) for f, v in upd.items()})
            ents, _ = eo.append_entity(ents, eball, active=do_fire)
        # each swept enemy that moves faces its velocity: one call after the
        # sweep, since an iteration writes only its own enemy's velocity
        moving = swept & ((ents.vx != 0) | (ents.vy != 0))
        ents = ents.replace(rotation=torch.where(
            moving, fm.face_rotation(ents.vx, ents.vy), ents.rotation))
        return state.replace(ents=ents, rng=mt)


def _choose_vel(rs, active):
    """choose_vel (dodgeball.cpp:228-240) on a draw source: (rs, vx, vy,
    spawn_time)."""
    rs, s = R.rs_randn(rs, 2, active=active)
    vel = ENEMY_VEL * (s * 2 - 1).to(F32)
    rs, axis = R.rs_randn(rs, 2, active=active)
    vx = torch.where(axis == 0, vel, 0.0)
    vy = torch.where(axis == 0, 0.0, vel)
    rs, st = R.rs_randn(rs, 50, active=active)
    return rs, vx, vy, st + 25


register_game("dodgeball")(Dodgeball)
