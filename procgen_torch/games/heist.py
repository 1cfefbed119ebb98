"""Heist: a maze with coloured keys and locked doors, and a gem to reach
(reference games/heist.cpp); counterpart of ``procgen_tpu/games/heist.py``.

Level generation runs ``mazegen.generate_maze_with_doors``; keys and the
exit are placed in their cells through ``entity_ops.reposition`` and take
their sprite's aspect ratio (read from the PNG headers when the game is
built).  Locked doors block the agent through the entity-push branch of the
sub-step until their key is held; the agent turns to face its move
(``fmath.face_rotation``).
Memory mode centres the view on the agent.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.base import (
    AGENT_SWEEP_SPAN,
    GameDef,
    base_game_reset,
    base_game_step,
)
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.engine.rand_util import choose_nth_masked
from procgen_torch.games import register_game
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0  # heist.cpp:10
LOCKED_DOOR = 1
KEY = 2
EXIT = 9
KEY_ON_RING = 11

KEY_ASSETS = (
    "misc_assets/keyBlue.png",
    "misc_assets/keyGreen.png",
    "misc_assets/keyRed.png",
)
EXIT_ASSET = "misc_assets/gemYellow.png"
MAX_EVENTS = 8  # <= 3 keys + 3 doors + the exit + the agent


class HeistGame(GameDef):
    name = "heist"
    has_useful_vel_info = False  # heist.cpp:27
    out_of_bounds_object = O.WALL_OBJ
    visibility = 8.0
    max_entities = 12  # <= 3 keys + 3 doors + exit + 3 ring keys + agent
    uses_entity_push = True  # locked doors block through push_obj
    entity_rotations = "free"  # face_direction uses 45-degree angles
    background_group = "topdown_backgrounds"  # heist.cpp:36-38
    reset_max_draws = 1024

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        if mode == DistributionMode.easy:
            self.world_dim = 9
        elif mode == DistributionMode.hard:
            self.world_dim = 13
        elif mode == DistributionMode.memory:
            self.world_dim = 23
        else:
            raise ValueError(f"heist does not support mode {mode}")
        self.world_w_max = self.world_dim
        self.world_h_max = self.world_dim
        # heist.cpp:122: center_agent is forced on in memory mode only
        self.force_center_agent = mode == DistributionMode.memory
        self.key_aspects = [np.float32(assets.aspect_ratio(n)) for n in KEY_ASSETS]
        self.exit_aspect = np.float32(assets.aspect_ratio(EXIT_ASSET))

    def use_block_asset(self, type_):
        # heist.cpp:62-64
        return type_ in (O.WALL_OBJ, LOCKED_DOOR)

    def asset_map(self, cfg):
        # heist.cpp:44-60
        return {
            O.WALL_OBJ: ["kenney/Ground/Dirt/dirtCenter.png"],
            EXIT: [EXIT_ASSET],
            O.PLAYER: ["misc_assets/spaceAstronauts_008.png"],
            KEY: list(KEY_ASSETS),
            LOCKED_DOOR: [
                "misc_assets/lock_blue.png",
                "misc_assets/lock_green.png",
                "misc_assets/lock_red.png",
            ],
        }

    def should_preserve_type_themes(self, type_):
        # heist.cpp:40-42
        return type_ in (KEY, LOCKED_DOOR)

    def center_agent(self, cfg):
        return self.force_center_agent

    def init_extra(self, cfg, num_envs, device):
        return {
            "num_keys": torch.zeros((num_envs,), dtype=I32, device=device),
            "world_dim": torch.full((num_envs,), self.world_dim, dtype=I32, device=device),
            "has_keys": torch.zeros((num_envs, 3), dtype=torch.bool, device=device),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        # heist.cpp:99-113: world dims and maxspeed
        wd = torch.full_like(state.main_width, self.world_dim)
        return state.replace(
            main_width=wd, main_height=wd, maxspeed=torch.full_like(state.maxspeed, 0.75)
        )

    def _held(self, state, theme):
        """has_keys[theme] per env, for a theme tensor with a leading env
        axis."""
        hk = state.extra["has_keys"]
        shape = (-1,) + (1,) * (theme.dim() - 1)
        theme = theme.clamp(0, 2)
        return fm.pick(theme, [hk[:, c].reshape(shape) for c in range(3)])

    def is_blocked_ents_vals(self, cfg, state, src_type, tgt, is_horizontal):
        # heist.cpp:66-71: locked doors block until their key is held
        t = tgt["type"]
        door_blocks = (t == LOCKED_DOOR) & ~self._held(state, tgt["image_theme"])
        base = GameDef.is_blocked(self, cfg, state, src_type, t, is_horizontal)
        return torch.where(t == LOCKED_DOOR, door_blocks, base)

    def entity_draw_mask(self, cfg, states):
        # heist.cpp:73-78: ring keys appear once collected
        ents = states.ents
        ring = ents.type == KEY_ON_RING
        return torch.where(ring, self._held(states, ents.image_theme), True)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)
        wd = self.world_dim
        min_maze_dim = 5
        max_diff = (wd - min_maze_dim) // 2
        rs, difficulty = R.rs_randn(rs, max_diff + 1)
        if cfg.distribution_mode == DistributionMode.memory:
            rs, num_keys = R.rs_randn(rs, 4)
        else:
            rs, extra_k = R.rs_randn(rs, 2)
            num_keys = difficulty + extra_k
        num_keys = num_keys.clamp(max=3).to(I32)
        maze_dim = (difficulty * 2 + min_maze_dim).to(torch.int64)
        maze_scale = 1.0  # main_height / world_dim

        a_r = fm.f32(0.375 * maze_scale)
        state = state.replace(
            ents=eo.write_slot(state.ents, eo.AGENT, rx=a_r, ry=a_r, x=-1.0, y=-1.0)
        )
        rs, mgrid = mazegen.generate_maze_with_doors(rs, num_keys, maze_dim, wd)
        rs, off_x = R.rs_randn(rs, (wd - maze_dim + 1).to(I32))
        rs, off_y = R.rs_randn(rs, (wd - maze_dim + 1).to(I32))
        off_x, off_y = off_x.to(torch.int64), off_y.to(torch.int64)
        md = maze_dim[:, None, None]

        # the world grid: walls, and SPACE at the maze's open cells
        # (heist.cpp:156-170)
        ys = torch.arange(wd, device=dev)[None, :, None]
        xs = torch.arange(wd, device=dev)[None, None, :]
        mi = xs - off_x[:, None, None]
        mj = ys - off_y[:, None, None]
        inside = (mi >= 0) & (mi < md) & (mj >= 0) & (mj < md)
        AD = wd + 2
        mflat = mgrid.reshape(N, AD * AD)
        mval = torch.gather(
            mflat, 1,
            ((mj + mazegen.MAZE_OFFSET).clamp(0, AD - 1) * AD
             + (mi + mazegen.MAZE_OFFSET).clamp(0, AD - 1)).reshape(N, -1),
        ).reshape(N, wd, wd)
        grid = torch.where(inside & (mval != O.WALL_OBJ), O.SPACE, O.WALL_OBJ).to(I32)
        state = state.replace(grid=grid)

        # entity spawns in the reference's x-major cell visitation order
        # (heist.cpp:160-190)
        k_lin = torch.arange(wd * wd, device=dev)
        ex = torch.div(k_lin, wd, rounding_mode="floor")  # maze x (outer loop)
        ey = k_lin % wd  # maze y (inner loop)
        valid = (ex[None, :] < maze_dim[:, None]) & (ey[None, :] < maze_dim[:, None])
        mv = mflat[:, (ey + mazegen.MAZE_OFFSET) * AD + ex + mazegen.MAZE_OFFSET]
        is_key = valid & (mv >= O.KEY_OBJ)
        is_door = valid & (mv >= O.DOOR_OBJ) & (mv < O.KEY_OBJ)
        is_exit = valid & (mv == O.EXIT_OBJ)
        is_agent = valid & (mv == O.AGENT_OBJ)
        event = is_key | is_door | is_exit | is_agent
        n_events = event.to(I32).sum(1)

        r_ent = fm.f32(maze_scale / 2)
        spawn_r = a_r
        for k in range(MAX_EVENTS):
            exists = k < n_events
            ei = choose_nth_masked(event, torch.full_like(n_events, k))
            wx = (off_x + ex[ei]).to(F32)
            wy = (off_y + ey[ei]).to(F32)
            v = mv[b, ei]
            k_key = exists & is_key[b, ei]
            k_door = exists & is_door[b, ei]
            k_exit = exists & is_exit[b, ei]
            k_agent = exists & is_agent[b, ei]

            # agent placement (heist.cpp:187-189)
            state = state.replace(ents=eo.write_slot_masked(
                state.ents, eo.AGENT, k_agent, x=wx + 0.5, y=wy + 0.5,
            ))

            # keys and the exit: spawn_entity in the cell's box, then
            # match_aspect_ratio; doors: add_entity at the cell's centre
            spawning = k_key | k_exit
            type_ = torch.where(k_key, KEY, EXIT).to(I32)
            fields = eo.make_entity(0.0, 0.0, 0.0, 0.0, spawn_r, spawn_r, type_)
            rs, px, py = eo.reposition(
                rs, state, spawn_r, spawn_r, KEY, fields["collision_margin"],
                wx, wy, 1.0, 1.0, True, active=spawning,
            )
            theme = torch.where(k_key, (v - O.KEY_OBJ - 1).clamp(0, 2), 0)
            aspect = torch.where(
                k_key, fm.pick(theme, [float(a) for a in self.key_aspects]),
                float(self.exit_aspect),
            )
            fields["x"] = torch.where(k_door, wx + 0.5, px)
            fields["y"] = torch.where(k_door, wy + 0.5, py)
            fields["rx"] = torch.where(k_door, r_ent, spawn_r)
            fields["ry"] = torch.where(
                k_door, r_ent, fm.fdiv(cfg, torch.full_like(aspect, spawn_r), aspect)
            )
            fields["type"] = torch.where(k_door, LOCKED_DOOR, type_).to(I32)
            fields["image_type"] = fields["type"]
            fields["image_theme"] = torch.where(
                k_door, (v - O.DOOR_OBJ - 1).clamp(0, 2), theme
            ).to(I32)
            ents, _ = eo.append_entity(state.ents, fields, active=spawning | k_door)
            state = state.replace(ents=ents)

        # the HUD key ring (heist.cpp:192-202): "1 - ring_key_r * (2 * i +
        # 1.25)" is double math narrowed on the ctor's float parameter
        ring_key_r = np.float32(0.03)
        rx = float(ring_key_r)
        ents = state.ents
        for i in range(3):
            fields = eo.make_entity(
                float(np.float32(1.0 - rx * (2 * i + 1.25))), float(np.float32(rx * 0.75)),
                0.0, 0.0, float(ring_key_r), float(ring_key_r / self.key_aspects[i]),
                KEY_ON_RING,
            )
            fields.update(image_theme=i, image_type=KEY, rotation=fm.f32(math.pi / 2),
                          render_z=1, use_abs_coords=True)
            ents, _ = eo.append_entity(ents, fields, active=i < num_keys)

        extra = dict(state.extra)
        extra["num_keys"] = num_keys
        extra["has_keys"] = torch.zeros_like(extra["has_keys"])
        return state.replace(ents=ents, extra=extra), rs

    def agent_collision_phase(self, cfg, state: EnvState) -> EnvState:
        with torch.profiler.record_function(AGENT_SWEEP_SPAN):
            return self._agent_sweep(cfg, state)

    def _agent_sweep(self, cfg, state: EnvState) -> EnvState:
        """Reverse-order sweep (heist.cpp:80-96): a key collected at a
        higher slot unlocks a door handled later in the same sweep, so the
        slots stay sequential, one batched step each, over the slots below
        the batch's largest live count, read once (live slots are a prefix
        of the table)."""
        ents = state.ents
        a = eo.AGENT
        L = int(ents.alive.sum(1).max())
        has_keys = state.extra["has_keys"].clone()
        will_erase = ents.will_erase.clone()
        reward, done, complete = state.reward, state.done, state.level_complete
        for i in range(L - 1, a, -1):
            coll = (
                torch.abs(ents.x[:, i] - ents.x[:, a])
                < ents.rx[:, i] + ents.rx[:, a] + ents.collision_margin[:, i]
            ) & (
                torch.abs(ents.y[:, i] - ents.y[:, a])
                < ents.ry[:, i] + ents.ry[:, a] + ents.collision_margin[:, i]
            )
            hit = ents.alive[:, i] & coll
            t = ents.type[:, i]
            theme = ents.image_theme[:, i].clamp(0, 2).to(torch.int64)

            is_exit = hit & (t == EXIT)
            done = done | is_exit
            complete = complete | is_exit
            reward = torch.where(is_exit, fm.f32(COMPLETION_BONUS), reward)

            got_key = hit & (t == KEY)
            has_keys = has_keys.scatter(
                1, theme[:, None], (has_keys.gather(1, theme[:, None])[:, 0] | got_key)[:, None]
            )
            held = has_keys.gather(1, theme[:, None])[:, 0]
            open_door = hit & (t == LOCKED_DOOR) & held
            will_erase[:, i] |= got_key | open_door
        extra = dict(state.extra)
        extra["has_keys"] = has_keys
        return state.replace(
            ents=ents.replace(will_erase=will_erase), extra=extra, reward=reward,
            done=done, level_complete=complete,
        )

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        # face_direction (heist.cpp:206-209, entity.cpp:84-88) of the action
        # velocities
        avx, avy = state.action_vx, state.action_vy
        moving = (avx != 0) | (avy != 0)
        rot = torch.where(
            moving, fm.face_rotation(avx, avy), state.ents.rotation[:, eo.AGENT]
        )
        return state.replace(ents=eo.write_slot(state.ents, eo.AGENT, rotation=rot))

    def serialize_extra(self, w, s, i):
        # heist.cpp:211-216
        nk = int(s["extra.num_keys"][i])
        w.write_int(nk)
        w.write_int(s["extra.world_dim"][i])
        w.write_vector_bool(s["extra.has_keys"][i][:nk])

    def deserialize_extra(self, r):
        nk = r.read_int()
        wd = r.read_int()
        hk = (r.read_vector_bool() + [False] * 3)[:3]
        return {"num_keys": nk, "world_dim": wd, "has_keys": hk}


register_game("heist")(HeistGame)
