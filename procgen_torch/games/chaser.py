"""Chaser: MsPacman-style orb collection with chasing enemies (reference
games/chaser.cpp); counterpart of ``procgen_tpu/games/chaser.py``.

Orbs are grid cells eaten during play (the grid-dynamic render class, with
orbs drawn as colour rects).  Enemies are smart entities that sub-step like
the agent.  Two loops stay sequential over slots, each iteration one batched
op over envs: the reverse agent-collision sweep (eating a large orb turns on
eat mode for the enemies swept after it) and the reverse-order hatch
appends.
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
from procgen_torch.engine import rand_util as ru
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.games import register_game
from procgen_torch.render import pack as packmod
from procgen_torch.state import F32, I32, EnvState

ORB_REWARD = 0.04  # chaser.cpp:10
COMPLETION_BONUS = 10.0
ORB_DIM = 0.3

LARGE_ORB = 2
ENEMY_WEAK = 3
ENEMY_EGG = 4
MAZE_WALL = 5
ENEMY = 6
ENEMY3 = 8

MARKER = 1001
ORB = 1002

EAT_TIMEOUT = 75  # chaser.cpp:43
EGG_TIMEOUT = 50


@functools.lru_cache(maxsize=None)
def _neighbor_steps(device: str):
    """(dx, dy) int32 (4,) of the neighbors in get_adjacent push order: left,
    up, down, right (one host-to-device copy per device)."""
    steps = np.array([[-1, 0, 0, 1], [0, -1, 1, 0]], np.int32)
    return tuple(torch.as_tensor(steps).to(device))


class ChaserGame(GameDef):
    name = "chaser"
    mixrate = 1.0  # chaser.cpp:40
    maxspeed = 0.5
    has_useful_vel_info = False
    agent_only_smart = False  # enemies are smart_step
    grid_dynamic = True  # orbs are grid cells eaten during play
    max_substeps = 4  # speeds <= sqrt(.5): num_sub_steps is always 4
    background_group = "topdown_simple_backgrounds"  # chaser.cpp:50-52

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        if mode == DistributionMode.easy:
            self.maze_dim, self.total_enemies, self.extra_orb_sign = 11, 3, 0
        elif mode == DistributionMode.hard:
            self.maze_dim, self.total_enemies, self.extra_orb_sign = 13, 3, -1
        elif mode == DistributionMode.extreme:
            self.maze_dim, self.total_enemies, self.extra_orb_sign = 19, 5, 1
        else:
            raise ValueError(f"chaser does not support mode {mode}")
        self.world_w_max = self.maze_dim
        self.world_h_max = self.maze_dim
        self.orbs_per_quad_max = 1 + max(self.extra_orb_sign, 0)
        # worst case: every egg hatches in one step (egg and child coexist
        # until the next compact) + orbs + agent + the respawned egg
        self.max_entities = 1 + self.orbs_per_quad_max * 4 + 2 * self.total_enemies + 1

    def use_block_asset(self, type_):
        # chaser.cpp:74-76
        return type_ == MAZE_WALL

    def asset_map(self, cfg):
        # chaser.cpp:54-72
        return {
            O.PLAYER: ["misc_assets/enemyFloating_1b.png"],
            ENEMY: ["misc_assets/enemyFlying_1.png"],
            ENEMY + 1: ["misc_assets/enemyFlying_2.png"],
            ENEMY3: ["misc_assets/enemyFlying_3.png"],
            LARGE_ORB: ["misc_assets/yellowCrystal.png"],
            ENEMY_WEAK: ["misc_assets/enemyWalking_1b.png"],
            ENEMY_EGG: ["misc_assets/enemySpikey_1b.png"],
            MAZE_WALL: ["misc_assets/tileStone_slope.png"],
        }

    def center_agent(self, cfg):
        return False  # chaser.cpp:172

    def grid_color_rect_lut(self, cfg):
        # draw_grid_obj: ORB = centered green square (chaser.cpp:111-117)
        dim = np.zeros((packmod.GRID_TYPE_LUT_SIZE,), np.float32)
        rgb = np.zeros((packmod.GRID_TYPE_LUT_SIZE, 3), np.float32)
        dim[ORB] = ORB_DIM
        rgb[ORB] = (0.0, 255.0, 0.0)
        return dim, rgb

    def init_extra(self, cfg, num_envs, device):
        def zero():
            return torch.zeros((num_envs,), dtype=I32, device=device)

        return {"eat_time": zero(), "total_orbs": zero(), "orbs_collected": zero()}

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, self.maze_dim)
        return state.replace(main_width=d, main_height=d)

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        return base | (target_type == MAZE_WALL)

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # chaser.cpp:78-88: latched full-speed velocity
        ents = state.ents
        a = eo.AGENT
        vx = torch.where(
            state.action_vx != 0, state.maxspeed * state.action_vx, ents.vx[:, a]
        )
        vy = torch.where(
            state.action_vy != 0, state.maxspeed * state.action_vy, ents.vy[:, a]
        )
        # sign() maps both IEEE zeros to +0.0 (vx may hold -0.0 after a
        # fully blocked step, bag.cpp:654-655)
        vx = fm.fsign(vx) * state.maxspeed
        vy = fm.fsign(vy) * state.maxspeed
        return state.replace(ents=eo.write_slot(ents, a, vx=vx, vy=vy))

    def _can_eat(self, state):
        return state.cur_time - state.extra["eat_time"] < EAT_TIMEOUT

    def entity_image_override(self, cfg, states):
        # image_for_type (chaser.cpp:97-109)
        rem = torch.div(states.cur_time, 2, rounding_mode="floor") % 4
        rem = torch.where(rem == 3, 1, rem)
        img = torch.where(self._can_eat(states), ENEMY_WEAK, ENEMY + rem)
        return torch.where(states.ents.type == ENEMY, img[:, None], states.ents.image_type)

    def _spawn_egg(self, ents, cell, active):
        # spawn_egg (chaser.cpp:259-262)
        md = self.maze_dim
        fields = eo.make_entity(
            (cell % md).to(F32) + 0.5,
            torch.div(cell, md, rounding_mode="floor").to(F32) + 0.5,
            0.0, 0.0, 0.5, 0.5, ENEMY_EGG,
        )
        fields["health"] = float(EGG_TIMEOUT)
        ents, _ = eo.append_entity(ents, fields, active=active)
        return ents

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        md = self.maze_dim
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)
        ents = eo.write_slot(state.ents, eo.AGENT, rx=0.5, ry=0.5)

        md_t = torch.full((N,), md, dtype=I32, device=dev)
        rs, mgrid = mazegen.generate_maze_no_dead_ends(rs, md_t, md)
        mval = mgrid[:, 1:md + 1, 1:md + 1]  # [y, x]
        grid = torch.where(mval == O.WALL_OBJ, MAZE_WALL, mval).to(I32)

        rs, extra_quad = R.rs_randn(rs, 4)

        # quadrant orb placement in x-major cell order (chaser.cpp:179-232)
        k_lin = torch.arange(md * md, device=dev)
        ex = torch.div(k_lin, md, rounding_mode="floor")
        ey = k_lin % md
        space_xmaj = grid[:, ey, ex] == O.SPACE  # (N, md*md)
        quad = (ex >= md / 2.0).to(I32) * 2 + (ey >= md / 2.0).to(I32)
        k_max = self.orbs_per_quad_max
        for q in range(4):
            n_orbs = 1 + torch.where(extra_quad == q, self.extra_orb_sign, 0)
            qmask = space_xmaj & (quad == q)
            rs, picks = ru.simple_choose_dyn(
                rs, qmask.to(I32).sum(1), n_orbs, md * md, k_max
            )
            for s in range(k_max):
                active = s < n_orbs
                pos = ru.choose_nth_masked(qmask, picks[:, s])
                cx, cy = ex[pos], ey[pos]
                fields = eo.make_entity(
                    cx.to(F32) + 0.5, cy.to(F32) + 0.5, 0.0, 0.0, 0.4, 0.4, LARGE_ORB
                )
                ents, _ = eo.append_entity(ents, fields, active=active)
                grid[b, cy, cx] = torch.where(active, MARKER, grid[b, cy, cx])

        # agent + enemy eggs from the remaining SPACE cells, ascending
        # y-major order (get_cells_with_type, chaser.cpp:234-252)
        space_flat = (grid == O.SPACE).reshape(N, md * md)
        n_free = space_flat.to(I32).sum(1).to(I32)
        n_pick = 1 + self.total_enemies
        rs, picks = ru.simple_choose_dyn(rs, n_free, n_pick, md * md, n_pick)
        start = ru.choose_nth_masked(space_flat, picks[:, 0])
        ents = eo.write_slot(
            ents, eo.AGENT,
            x=(start % md).to(F32) + 0.5,
            y=torch.div(start, md, rounding_mode="floor").to(F32) + 0.5,
        )
        for i in range(self.total_enemies):
            ents = self._spawn_egg(ents, ru.choose_nth_masked(space_flat, picks[:, i + 1]), True)

        # SPACE -> ORB (egg cells included), orb markers -> SPACE
        grid = torch.where(grid == O.SPACE, ORB, grid)
        grid = torch.where(grid == MARKER, O.SPACE, grid)

        extra = dict(state.extra)
        extra["eat_time"] = torch.full((N,), -EAT_TIMEOUT, dtype=I32, device=dev)
        extra["total_orbs"] = n_free
        extra["orbs_collected"] = torch.zeros((N,), dtype=I32, device=dev)
        return state.replace(ents=ents, grid=grid, extra=extra), rs

    def agent_collision_phase(self, cfg, state: EnvState) -> EnvState:
        """Sequential reverse sweep (chaser.cpp:119-133): eating a large orb
        turns on eat mode for the enemies swept after it.  Positions do not
        change during the sweep, so the overlaps are computed at once."""
        ents = state.ents
        E = ents.capacity
        a = eo.AGENT
        cur_time = state.cur_time
        coll = (
            (torch.abs(ents.x - ents.x[:, a:a + 1])
             < ents.rx + ents.rx[:, a:a + 1] + ents.collision_margin)
            & (torch.abs(ents.y - ents.y[:, a:a + 1])
               < ents.ry + ents.ry[:, a:a + 1] + ents.collision_margin)
        )
        hit = ents.alive & coll
        hit[:, a] = False
        is_orb = hit & (ents.type == LARGE_ORB)
        is_enemy = hit & (ents.type == ENEMY)
        eat_time, reward, done = state.extra["eat_time"], state.reward, state.done
        erase = [None] * E
        for i in range(E - 1, -1, -1):
            eat_time = torch.where(is_orb[:, i], cur_time, eat_time)
            reward = reward + torch.where(is_orb[:, i], ORB_REWARD, 0.0)
            can_eat = cur_time - eat_time < EAT_TIMEOUT
            done = done | (is_enemy[:, i] & ~can_eat)
            erase[i] = is_orb[:, i] | (is_enemy[:, i] & can_eat)
        ents = ents.replace(will_erase=ents.will_erase | torch.stack(erase, 1))
        extra = dict(state.extra)
        extra["eat_time"] = eat_time
        return state.replace(ents=ents, extra=extra, reward=reward, done=done)

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        md = self.maze_dim
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)
        ents = state.ents
        E = ents.capacity
        can_eat = self._can_eat(state)
        vscale = torch.where(can_eat, 0.25, 0.5)[:, None]  # chaser.cpp:293-294
        sri = state.step_rand_int

        is_egg = ents.alive & (ents.type == ENEMY_EGG)
        is_enemy = ents.alive & (ents.type == ENEMY)
        num_enemies = (is_egg | is_enemy).to(I32).sum(1)

        # egg countdown (chaser.cpp:303-315)
        health = torch.where(is_egg, ents.health - 1, ents.health)
        hatch = is_egg & (health == 0)
        ents = ents.replace(health=health, will_erase=ents.will_erase | hatch)

        # enemy chase AI, vectorized over slots (chaser.cpp:316-363)
        x = ents.x - 0.5
        y = ents.y - 0.5
        ecx = x.to(I32)  # int() truncation
        ecy = y.to(I32)
        at_junction = torch.abs(x - torch.round(x)) + torch.abs(y - torch.round(y)) < fm.f32(0.01)
        decide = is_enemy & (((ents.vx == 0) & (ents.vy == 0)) | at_junction)
        aggressive = (sri % 2 == 0)[:, None, None]
        dist_scale = torch.where(can_eat, -1, 1)[:, None, None]
        is_space = state.grid != MAZE_WALL  # is_space_vec semantics

        a = eo.AGENT
        acx = ents.x[:, a].to(I32)
        acy = ents.y[:, a].to(I32)

        pvx = (x - fm.fsign(ents.vx)).to(I32)
        pvy = (y - fm.fsign(ents.vy)).to(I32)
        prev_ok = (pvx >= 0) & (pvx < md) & (pvy >= 0) & (pvy < md)

        n_dx, n_dy = _neighbor_steps(str(dev))
        nx = ecx[..., None] + n_dx  # (N, E, 4)
        ny = ecy[..., None] + n_dy
        in_grid = (nx >= 0) & (nx < md) & (ny >= 0) & (ny < md)
        sp = is_space[
            b[:, None, None],
            ny.clamp(0, md - 1).to(torch.int64),
            nx.clamp(0, md - 1).to(torch.int64),
        ]
        not_prev = ~(prev_ok[..., None] & (nx == pvx[..., None]) & (ny == pvy[..., None]))
        cand = in_grid & sp & not_prev
        mdist = (torch.abs(nx - acx[:, None, None]) + torch.abs(ny - acy[:, None, None])) * dist_scale
        min_d = torch.where(cand, mdist, 2 * md).amin(-1, keepdim=True)
        cand = torch.where(aggressive, cand & (mdist == min_d), cand)
        cnt = cand.to(I32).sum(-1)
        j = sri[:, None] % cnt.clamp(min=1)
        pos = torch.cumsum(cand.to(I32), -1) - 1
        sel = ru.first_true(cand & (pos == j[..., None]))[..., None]
        tx = torch.gather(nx, 2, sel)[..., 0].to(F32)
        ty = torch.gather(ny, 2, sel)[..., 0].to(F32)
        apply = decide & (cnt > 0)
        ents = ents.replace(
            vx=torch.where(apply, (tx - x) * vscale, ents.vx),
            vy=torch.where(apply, (ty - y) * vscale, ents.vy),
        )

        # hatched children append in reverse slot order (chaser.cpp:307-313)
        for i in range(E - 1, -1, -1):
            fields = eo.make_entity(ents.x[:, i], ents.y[:, i], 0.0, 0.0, 0.5, 0.5, ENEMY)
            fields["smart_step"] = True
            ents, _ = eo.append_entity(ents, fields, active=hatch[:, i])

        # egg respawn (chaser.cpp:366-369)
        space_flat = is_space.reshape(N, md * md)
        n_free = space_flat.to(I32).sum(1)
        cell = ru.choose_nth_masked(space_flat, sri % n_free.clamp(min=1))
        ents = self._spawn_egg(ents, cell, num_enemies < self.total_enemies)

        # orb collection at the agent cell (chaser.cpp:371-385)
        gy = acy.clamp(0, md - 1).to(torch.int64)
        gx = acx.clamp(0, md - 1).to(torch.int64)
        at_orb = state.grid[b, gy, gx] == ORB
        grid = state.grid.clone()
        grid[b, gy, gx] = torch.where(at_orb, O.SPACE, state.grid[b, gy, gx])
        extra = dict(state.extra)
        extra["orbs_collected"] = extra["orbs_collected"] + at_orb.to(I32)
        reward = state.reward + torch.where(at_orb, ORB_REWARD, 0.0)
        full = extra["orbs_collected"] == extra["total_orbs"]
        reward = reward + torch.where(full, COMPLETION_BONUS, 0.0)
        return state.replace(
            ents=ents, grid=grid, extra=extra, reward=reward,
            done=state.done | full,
            level_complete=state.level_complete | full,
        )

    def serialize_extra(self, w, s, i):
        # chaser.cpp:388-412; free_cells/is_space_vec are derived views of
        # the grid (cells != MAZE_WALL never change during play)
        md = self.maze_dim
        is_space = s["grid"][i][:md, :md].reshape(-1) != MAZE_WALL
        w.write_vector_int(np.nonzero(is_space)[0])
        w.write_vector_bool(is_space)
        w.write_int(EAT_TIMEOUT)
        w.write_int(EGG_TIMEOUT)
        w.write_int(s["extra.eat_time"][i])
        w.write_int(self.total_enemies)
        w.write_int(s["extra.total_orbs"][i])
        w.write_int(s["extra.orbs_collected"][i])
        w.write_int(md)

    def deserialize_extra(self, r):
        r.read_vector_int()  # free_cells (derived)
        r.read_vector_bool()  # is_space_vec (derived)
        r.read_int()  # eat_timeout
        r.read_int()  # egg_timeout
        eat_time = r.read_int()
        r.read_int()  # total_enemies
        total_orbs = r.read_int()
        orbs_collected = r.read_int()
        r.read_int()  # maze_dim
        return {"eat_time": eat_time, "total_orbs": total_orbs, "orbs_collected": orbs_collected}


register_game("chaser")(ChaserGame)
