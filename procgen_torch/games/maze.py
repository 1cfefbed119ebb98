"""Maze: grid-step navigation to the cheese (reference games/maze.cpp);
counterpart of ``procgen_tpu/games/maze.py``."""

from __future__ import annotations

import torch

from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import physics as ph
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.engine.levelgen import mazegen
from procgen_torch.games import register_game
from procgen_torch.state import F32, I32, EnvState

REWARD = 10.0  # maze.cpp:6
GOAL = 2  # maze.cpp:8


class MazeGame(GameDef):
    name = "maze"
    timeout = 500  # maze.cpp:18
    random_agent_start = False
    has_useful_vel_info = False
    out_of_bounds_object = O.WALL_OBJ
    visibility = 8.0
    max_entities = 2  # agent only (goal is a grid cell)
    max_substeps = 1  # grid_step game: exactly one sub-step

    background_group = "topdown_backgrounds"  # maze.cpp:26-28

    def asset_map(self, cfg):
        # maze.cpp:30-38
        return {
            O.WALL_OBJ: ["kenney/Ground/Sand/sandCenter.png"],
            GOAL: ["misc_assets/cheese.png"],
            O.PLAYER: ["kenney/Enemies/mouse_move.png"],
        }

    def center_agent(self, cfg):
        return self.force_center_agent

    def __init__(self, cfg):
        # maze.cpp:40-53
        mode = cfg.distribution_mode
        if mode == DistributionMode.easy:
            self.world_dim = 15
        elif mode == DistributionMode.hard:
            self.world_dim = 25
        elif mode == DistributionMode.memory:
            self.world_dim = 31
        else:
            raise ValueError(f"maze does not support mode {mode}")
        self.world_w_max = self.world_dim
        self.world_h_max = self.world_dim
        # maze.cpp:66: center_agent is forced on only in memory mode
        self.force_center_agent = mode == DistributionMode.memory

    def init_extra(self, cfg, num_envs, device):
        return {
            "maze_dim": torch.zeros((num_envs,), dtype=I32, device=device),
            "world_dim": torch.full((num_envs,), self.world_dim, dtype=I32, device=device),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        wd = torch.full_like(state.main_width, self.world_dim)
        return state.replace(main_width=wd, main_height=wd)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        state = state.replace(grid_step=torch.ones_like(state.grid_step))

        wd = self.world_dim
        rs, r = R.rs_randn(rs, (wd - 1) // 2)
        maze_dim = r * 2 + 3
        margin = torch.div(wd - maze_dim, 2, rounding_mode="floor")

        # agent at maze corner (maze.cpp:68-71)
        ax = margin.to(F32) + 0.5
        ents = eo.write_slot(state.ents, eo.AGENT, rx=0.5, ry=0.5, x=ax, y=ax)
        state = state.replace(ents=ents)

        res = mazegen.generate_maze(rs, maze_dim, wd)
        rs, res = mazegen.place_objects(res.rng, res, GOAL, 1, maze_dim, wd)

        # world grid: WALL everywhere, maze interior copied at margin offset
        # (maze.cpp:76-96; the extra border ring at margin-1 is already WALL).
        dev = maze_dim.device
        ys = torch.arange(wd, device=dev)[None, :, None]
        xs = torch.arange(wd, device=dev)[None, None, :]
        m = margin[:, None, None]
        md = maze_dim[:, None, None]
        mi = xs - m  # maze x
        mj = ys - m  # maze y
        inside = (mi >= 0) & (mi < md) & (mj >= 0) & (mj < md)
        AD = wd + 2
        gy = (mj + mazegen.MAZE_OFFSET).clamp(0, wd + 1)
        gx = (mi + mazegen.MAZE_OFFSET).clamp(0, wd + 1)
        B = maze_dim.shape[0]
        mval = torch.gather(res.grid.reshape(B, AD * AD), 1, (gy * AD + gx).reshape(B, -1))
        grid = torch.where(inside, mval.reshape(B, wd, wd), O.WALL_OBJ).to(I32)

        extra = dict(state.extra)
        extra["maze_dim"] = maze_dim
        return state.replace(grid=grid, extra=extra), rs

    def set_action_xy(self, cfg, state, move_action):
        # maze.cpp:99-103: horizontal wins over vertical
        avx, avy, avrot = GameDef.set_action_xy(self, cfg, state, move_action)
        avy = torch.where(avx != 0, 0.0, avy)
        return avx, avy, avrot

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)

        ents = state.ents
        a = eo.AGENT
        avx = state.action_vx
        refl = torch.where(
            avx > 0, True, torch.where(avx < 0, False, ents.is_reflected[:, a])
        )
        ents = eo.write_slot(ents, a, is_reflected=refl)
        state = state.replace(ents=ents)

        ix = ents.x[:, a].to(I32)
        iy = ents.y[:, a].to(I32)
        hit = ph.get_obj(state, ix, iy) == GOAL
        state = ph.set_obj(state, ix, iy, torch.where(hit, O.SPACE, state.grid[
            torch.arange(ix.shape[0], device=ix.device), iy.long(), ix.long()
        ]))
        reward = state.reward + torch.where(hit, REWARD, 0.0)
        return state.replace(
            reward=reward,
            level_complete=state.level_complete | hit,
            done=reward > 0,  # maze.cpp:122 (overwrites base's OOB done)
        )


register_game("maze")(MazeGame)
