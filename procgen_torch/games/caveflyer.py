"""CaveFlyer: an Asteroids-style ship in procedurally carved caves (reference
games/caveflyer.cpp); counterpart of ``procgen_tpu/games/caveflyer.py``.

The ship turns through a continuous angle and thrusts along its nose; its
exhaust and bullets leave at that angle, through the double ``cos``/``sin``
of ``fmath.dsincos`` (fdlibm's algorithm as eager float64 ops, so the card
and the CPU give the same bits).  Enemies drift along one axis and reflect
off the cave walls; bullets explode on walls and on targets, obstacles,
enemies and the goal through the pair collisions of ``engine/base.py``.
Level generation runs the cave room generator of ``engine/levelgen``.
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
from procgen_torch.engine import rand_util as ru
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step, descending_slots
from procgen_torch.engine.levelgen import roomgen
from procgen_torch.games import register_game
from procgen_torch.state import F32, I32, EnvState

GOAL_REWARD = 10.0
TARGET_REWARD = 3.0

GOAL = 1
OBSTACLE = 2
TARGET = 3
PLAYER_BULLET = 4
ENEMY = 5
CAVEWALL = 8
EXHAUST = 9

MARKER = 1003
PI = float(np.float32(np.pi))  # the reference's `const float PI` (cpp-utils.h:12)
HALF_PI = fm.f32(PI / 2)


class CaveFlyer(GameDef):
    name = "caveflyer"
    mixrate = 0.9
    background_group = "space_backgrounds"
    agent_only_smart = False  # drifting enemies are smart
    # enemies reflect off the grid only (no entity has a reflecting type),
    # so the sequential entity-reflect sweep is not needed
    uses_entity_reflect = False
    max_smart_entities = 48  # agent + <= 45 drifting enemies
    uses_pair_collisions = True
    entity_rotations = "free"
    max_substeps = 8
    out_of_bounds_object = CAVEWALL

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        if mode == DistributionMode.easy:
            self.world_dim = 30
        elif mode == DistributionMode.hard:
            self.world_dim = 40
        elif mode == DistributionMode.memory:
            self.world_dim = 60
        else:
            self.world_dim = 20  # extreme
        self.memory = mode == DistributionMode.memory
        self.world_w_max = self.world_dim
        self.world_h_max = self.world_dim
        self.visibility_val = 10.0 if mode == DistributionMode.easy else 16.0
        G = self.world_dim * self.world_dim
        self.max_objs = 3 * (G // 80)
        # agent + goal + objs + bullets(10) + exhaust(5) + explosions
        self.max_entities = 2 + self.max_objs + 24
        self.reset_max_draws = G + 1024

    def use_block_asset(self, type_):
        # caveflyer.cpp:81-83
        return type_ == CAVEWALL

    def asset_map(self, cfg):
        # caveflyer.cpp:36-54
        return {
            GOAL: ["misc_assets/ufoGreen2.png"],
            OBSTACLE: ["misc_assets/meteorBrown_big1.png"],
            TARGET: ["misc_assets/ufoRed2.png"],
            PLAYER_BULLET: ["misc_assets/laserBlue02.png"],
            ENEMY: ["misc_assets/enemyShipBlue4.png"],
            O.PLAYER: ["misc_assets/playerShip1_red.png"],
            CAVEWALL: ["misc_assets/groundA.png"],
            EXHAUST: ["misc_assets/towerDefense_tile295.png"],
            O.EXPLOSION: ["misc_assets/explosion1.png"],
            O.EXPLOSION + 1: ["misc_assets/explosion2.png"],
            O.EXPLOSION + 2: ["misc_assets/explosion3.png"],
            O.EXPLOSION + 3: ["misc_assets/explosion4.png"],
            O.EXPLOSION + 4: ["misc_assets/explosion5.png"],
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, self.world_dim)
        return state.replace(main_width=d, main_height=d)

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        return base | ((src_type == O.PLAYER) & (target_type == CAVEWALL))

    def will_reflect(self, cfg, state, src_type, target_type):
        # caveflyer.cpp:124-126
        oob = state.out_of_bounds_object.reshape((-1,) + (1,) * (target_type.dim() - 1))
        return (src_type == ENEMY) & ((target_type == CAVEWALL) | (target_type == oob))

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # caveflyer.cpp:72-79: "vx += mixrate * maxspeed * action_vx * v_scale
        # * .2": the float product promotes to double at the .2 literal and
        # narrows once at the += store; then the 0.9 double decay
        ents = state.ents
        a = eo.AGENT
        px = state.mixrate * state.maxspeed * state.action_vx
        py = state.mixrate * state.maxspeed * state.action_vy
        vx = fm.narrow(fm.wide(cfg, ents.vx[:, a]) + fm.wide(cfg, px) * 0.2)
        vy = fm.narrow(fm.wide(cfg, ents.vy[:, a]) + fm.wide(cfg, py) * 0.2)
        vx = fm.dmul(cfg, vx, 0.9)
        vy = fm.dmul(cfg, vy, 0.9)
        return state.replace(ents=eo.write_slot(ents, a, vx=vx, vy=vy))

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # caveflyer.cpp:56-70
        t = state.ents.type
        goal = (mask & (t == GOAL)).any(1)
        dead = (mask & ((t == OBSTACLE) | (t == ENEMY) | (t == TARGET))).any(1)
        return state.replace(
            reward=state.reward + torch.where(goal, fm.f32(GOAL_REWARD), 0.0),
            done=state.done | goal | dead,
            level_complete=state.level_complete | goal,
        )

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """caveflyer.cpp:96-121: the environment entity is the source and
        the bullet the target, so each source, in descending slot order,
        absorbs its highest-index live bullet (a target loses 1 health and
        dies at 0, with an explosion), and the bullet explodes.  The loop
        runs over each env's sources that touch a live bullet at the start,
        descending (exact: will_erase only grows, so a source with no bullet
        then has none later; appended explosions are neither)."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        src_type = (t == TARGET) | (t == OBSTACLE) | (t == ENEMY) | (t == GOAL)
        src = ents.alive[:, :L] & ~ents.will_erase[:, :L] & src_type
        bullet = (t == PLAYER_BULLET) & ~ents.will_erase[:, :L]
        cand = src & (pair_mask & bullet[:, None, :]).any(2)
        order, count, n_max = descending_slots(cand)
        idx = torch.arange(L, device=t.device)
        for k in range(n_max):
            ents = state.ents
            i = order[:, k]
            on = k < count
            row = torch.gather(pair_mask, 1, i[:, None, None].expand(-1, 1, L))[:, 0]
            t_i = eo.at(ents.type, i)
            src_ok = on & eo.at(ents.alive, i) & ~eo.at(ents.will_erase, i) & (
                (t_i == TARGET) | (t_i == OBSTACLE) | (t_i == ENEMY) | (t_i == GOAL)
            )
            valid = (
                row & ~ents.will_erase[:, :L] & src_ok[:, None]
                & (ents.type[:, :L] == PLAYER_BULLET)
            )
            j = torch.where(valid, idx, -1).amax(1)
            hit = j >= 0
            jc = j.clamp(min=0)
            is_target = hit & (t_i == TARGET)
            health = eo.at(ents.health, i) - torch.where(is_target, 1.0, 0.0)
            kill = is_target & (health <= 0)
            we = eo.set_at(ents.will_erase, i, True, kill)
            ents = ents.replace(
                health=eo.set_at(ents.health, i, health, on),
                will_erase=eo.set_at(we, jc, True, hit),
            )
            # the target's explosion precedes the bullet's
            rx_i = eo.at(ents.rx, i)
            expl1 = eo.make_entity(eo.at(ents.x, i), eo.at(ents.y, i), 0.0, 0.0,
                                   0.5 * rx_i, 0.5 * rx_i, O.EXPLOSION)
            ents, _ = eo.append_entity(ents, expl1, active=kill)
            rx_j = eo.at(ents.rx, jc)
            expl2 = eo.make_entity(eo.at(ents.x, jc), eo.at(ents.y, jc), eo.at(ents.vx, i),
                                   eo.at(ents.vy, i), 0.5 * rx_j, 0.5 * rx_j, O.EXPLOSION)
            ents, _ = eo.append_entity(ents, expl2, active=hit)
            state = state.replace(
                ents=ents,
                reward=state.reward + torch.where(kill, fm.f32(TARGET_REWARD), 0.0),
            )
        return state

    def set_action_xy(self, cfg, state, move_action):
        # caveflyer.cpp:267-289: ship-relative thrust and an exhaust puff
        acc = (move_action % 3 - 1).to(F32)
        acc = torch.where(acc < 0, acc * fm.f32(0.33), acc)
        ents = state.ents
        a = eo.AGENT
        theta = -ents.rotation[:, a] + HALF_PI
        s, c = fm.dsincos(cfg, theta)
        # "x - rx * cos(theta)": game TUs see only the C double ::cos, so
        # the chain is double, narrowed at the Entity ctor's floats
        ex = eo.make_entity(
            fm.narrow(fm.wide(cfg, ents.x[:, a]) - fm.wide(cfg, ents.rx[:, a]) * c),
            fm.narrow(fm.wide(cfg, ents.y[:, a]) - fm.wide(cfg, ents.ry[:, a]) * s),
            0.0, 0.0, 0.5 * ents.rx[:, a], 0.5 * ents.rx[:, a], EXHAUST,
        )
        ex.update(expire_time=4, rotation=-theta - HALF_PI, grow_rate=1.25, alpha_decay=0.8)
        ents, _ = eo.append_entity(ents, ex, active=acc > 0)
        avy = fm.narrow(fm.wide(cfg, acc) * s)
        avx = fm.narrow(fm.wide(cfg, acc) * c)
        avrot = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        return avx, avy, avrot, state.replace(ents=ents)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        dim = self.world_dim
        G = dim * dim
        dimt = torch.full((N,), dim, dtype=I32, device=dev)

        # random noise (caveflyer.cpp:152-158), one bulk draw of the cells
        rs, noise = R.rs_rand01_vec(rs, G)
        grid = torch.where(noise.reshape(N, dim, dim) < 0.5, O.WALL_OBJ, O.SPACE).to(I32)
        for _ in range(4):
            grid = roomgen.ca_update(grid, dimt)
        best = roomgen.best_room_mask(grid, dimt)
        # all walls, then carve the best room (caveflyer.cpp:168-180)
        grid = torch.where(best, O.SPACE, O.WALL_OBJ).to(I32)

        free_flat = best.flatten(1)  # ascending free cells
        rs, picks = ru.simple_choose_dyn(rs, free_flat.sum(1), 2, G, 2)
        agent_cell = ru.choose_nth_masked(free_flat, picks[:, 0])
        goal_cell = ru.choose_nth_masked(free_flat, picks[:, 1])

        def cell_xy(cell):
            return (
                (cell % dim).to(F32) + 0.5,
                torch.div(cell, dim, rounding_mode="floor").to(F32) + 0.5,
            )

        ax, ay = cell_xy(agent_cell)
        ents = eo.write_slot(state.ents, eo.AGENT, x=ax, y=ay)
        gx, gy = cell_xy(goal_cell)
        gfields = eo.make_entity(gx, gy, 0.0, 0.0, 0.5, 0.5, GOAL)
        gfields["collides_with_entities"] = True
        ents, _ = eo.append_entity(ents, gfields)

        path_flat = roomgen.find_path_mask(grid, dimt, agent_cell, goal_cell)
        path_mask = roomgen.flat_to_grid_mask(path_flat, dimt, dim, dim)
        if not self.memory:
            wide = roomgen.expand_mask(grid, dimt, path_mask, 4)
            grid = torch.where(wide, O.SPACE, O.WALL_OBJ).to(I32)
        for _ in range(4):
            grid = roomgen.ca_update(grid, dimt)
            grid = torch.where(path_mask, O.SPACE, grid).to(I32)

        # the path is marked off; SPACE cells ascending are the free cells,
        # walls become CAVEWALL (caveflyer.cpp:198-206)
        grid = torch.where(path_mask, MARKER, grid).to(I32)
        free2_flat = (grid == O.SPACE).flatten(1)
        grid = torch.where(grid == O.WALL_OBJ, CAVEWALL, grid).to(I32)
        chunk = torch.div(free2_flat.sum(1), 80, rounding_mode="floor")
        num_objs = 3 * chunk
        rs, opicks = ru.simple_choose_dyn(rs, free2_flat.sum(1), num_objs, G, self.max_objs)
        for k in range(self.max_objs):
            on = k < num_objs
            ox, oy = cell_xy(ru.choose_nth_masked(free2_flat, opicks[:, k]))
            is_obst = on & (k < chunk)
            is_target = on & (k >= chunk) & (k < 2 * chunk)
            is_enemy = on & (k >= 2 * chunk)
            type_ = torch.where(is_obst, OBSTACLE, torch.where(is_target, TARGET, ENEMY)).to(I32)
            fields = eo.make_entity(ox, oy, 0.0, 0.0, 0.5, 0.5, type_)
            fields["collides_with_entities"] = True
            fields["health"] = torch.where(is_target, 5.0, 1.0)
            # enemy velocity: rand01, then randn(2), then the axis's rand01
            rs, u_v = R.rs_rand01(rs, active=is_enemy)
            rs, sgn = R.rs_randn(rs, 2, active=is_enemy)
            # "(.1 * rand01() + .1) * (randn(2) * 2 - 1)": a double chain
            # narrowed once (caveflyer.cpp:245); the fast mode rounds each
            # float op in turn
            sign = (sgn * 2 - 1).to(F32)
            if cfg.parity_mode:
                vel = ((0.1 * u_v.double() + 0.1) * sign.double()).to(F32)
            else:
                vel = (fm.f32(0.1) * u_v + fm.f32(0.1)) * sign
            rs, u_a = R.rs_rand01(rs, active=is_enemy)
            fields["vx"] = torch.where(is_enemy & (u_a < 0.5), vel, 0.0)
            fields["vy"] = torch.where(is_enemy & ~(u_a < 0.5), vel, 0.0)
            fields["smart_step"] = is_enemy
            ents, _ = eo.append_entity(ents, fields, active=on)

        grid = torch.where(grid == MARKER, O.SPACE, grid).to(I32)
        return state.replace(
            ents=ents,
            grid=grid,
            out_of_bounds_object=torch.full((N,), CAVEWALL, dtype=I32, device=dev),
            visibility=torch.full((N,), self.visibility_val, dtype=F32, device=dev),
        ), rs

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        ents = state.ents
        a = eo.AGENT

        # fire every step the action is held (caveflyer.cpp:293-300)
        theta = -ents.rotation[:, a] + HALF_PI
        s, c = fm.dsincos(cfg, theta)
        b = eo.make_entity(ents.x[:, a], ents.y[:, a], fm.narrow(c), fm.narrow(s),
                           0.1, 0.25, PLAYER_BULLET)
        b.update(expire_time=10, rotation=ents.rotation[:, a])
        ents, _ = eo.append_entity(ents, b, active=state.special_action == 1)

        # enemies face their motion (caveflyer.cpp:302-307)
        moving = (ents.vx != 0) | (ents.vy != 0)
        face = fm.face_rotation(ents.vx, ents.vy, -PI / 2)
        rot = torch.where(ents.alive & (ents.type == ENEMY) & moving, face, ents.rotation)
        ents = ents.replace(rotation=rot)

        # bullets explode on cave walls, probed at their four corners
        # (caveflyer.cpp:309-321); explosions append in descending order
        found_wall = torch.zeros_like(ents.alive)
        for i in (-1.0, 1.0):
            for j in (-1.0, 1.0):
                t2 = ph.get_obj_from_floats(state, ents.x + ents.rx * i, ents.y + ents.ry * j)
                found_wall = found_wall | (t2 == CAVEWALL)
        boom = ents.alive & (ents.type == PLAYER_BULLET) & found_wall & ~ents.will_erase
        ents = ents.replace(will_erase=ents.will_erase | boom)
        efields = eo.make_entity(ents.x, ents.y, 0.0, 0.0, 0.5 * ents.rx, 0.5 * ents.rx,
                                 O.EXPLOSION)
        ents = eo.append_entities_masked(ents, efields, boom, descending=True)
        # the reference's game_step ends with a second erase_if_needed, so
        # exploded bullets vanish the same step (caveflyer.cpp:323)
        return state.replace(ents=eo.compact(ents, state.main_width, state.main_height))


register_game("caveflyer")(CaveFlyer)
