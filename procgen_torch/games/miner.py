"""Miner: Boulderdash-style digging under gravity (reference games/miner.cpp);
counterpart of ``procgen_tpu/games/miner.py``.

The grid changes every step (digging, falling and rolling boulders and
diamonds), so miner renders in the grid-dynamic class.  The gravity sweep is
sequential in ascending cell order with in-place writes (falls write the
already swept row below, rolls write the neighbor not yet swept).  Its
plain version (``MinerGame.gravity_sweep_ref``, which CPU tensors run)
loops over the cells, each iteration a few batched ops over envs; for CUDA
tensors ``gravity_sweep`` launches the kernel of
``procgen_torch/csrc/miner_sweep.cu`` (one thread per env; same bits) or
raises, and ``launches`` counts it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from procgen_torch import cuda_build, telemetry
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine import rand_util as ru
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.games import register_game
from procgen_torch.render import pack as render_pack
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0
DIAMOND_REWARD = 1.0

BOULDER = 1
DIAMOND = 2
MOVING_BOULDER = 3
MOVING_DIAMOND = 4
ENEMY = 5
EXIT = 6
DIRT = 9
OOB_WALL = 10

# profiler span of the gravity sweep (read by the benchmark and bench/op_counts.py)
SWEEP_SPAN = "procgen_torch.miner.gravity_sweep"
KERNEL_MAX_DIM = 38  # miner_sweep.cu: MAX_DIM

launches = 0  # sweep kernel launches since import (reset by callers that count)

# per-cell-value lookup tables of the gravity sweep (cell values <= SPACE)
_LUT_SIZE = O.SPACE + 1
_ROUND = np.zeros(_LUT_SIZE, bool)  # boulders and diamonds, moving or not
_ROUND[[BOULDER, DIAMOND, MOVING_BOULDER, MOVING_DIAMOND]] = True
_MOVING = np.zeros(_LUT_SIZE, bool)
_MOVING[[MOVING_BOULDER, MOVING_DIAMOND]] = True
_STAT = np.arange(_LUT_SIZE)  # the settled form of a cell value
_STAT[MOVING_BOULDER], _STAT[MOVING_DIAMOND] = BOULDER, DIAMOND
_FALLING = np.arange(_LUT_SIZE)  # the moving form of a cell value
_FALLING[BOULDER], _FALLING[DIAMOND] = MOVING_BOULDER, MOVING_DIAMOND


def _lib():
    lib = cuda_build.load("miner_sweep")
    if lib.miner_sweep_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.miner_sweep_launch.argtypes = [ptr] * 3 + [i] * 2 + [ptr] * 4
        lib.miner_sweep_launch.restype = i
    return lib


def fall_cell(ay, ax, W: int):
    """The agent's cell that the sweep's falling check reads, from its float
    position (miner.cpp:95-97): int32 (N,)."""
    return ((ay - 0.5) * W + (ax - 0.5)).to(I32)


def _set_cells(flat, idx, mask, val):
    """flat[n, idx[n]] = val where mask[n], in place (idx (N,) int64)."""
    cur = torch.gather(flat, 1, idx[:, None])
    flat.scatter_(1, idx[:, None], torch.where(mask[:, None], val, cur))


class MinerGame(GameDef):
    name = "miner"
    has_useful_vel_info = False
    out_of_bounds_object = OOB_WALL
    visibility = 8.0
    max_entities = 2  # agent + exit (no enemies are ever spawned)
    max_substeps = 1  # grid_step
    grid_dynamic = True  # the grid mutates every step (digging / gravity)
    background_group = "platform_backgrounds"
    # miner.cpp:23: the member is recomputed only by a step's sweep, so a
    # level's first step tests the exit against the count of the level before
    kept_across_reset = ("diamonds_remaining",)

    def asset_map(self, cfg):
        # miner.cpp:42-56
        return {
            O.PLAYER: ["misc_assets/robot_greenDrive1.png"],
            BOULDER: ["misc_assets/elementStone007.png"],
            DIAMOND: ["misc_assets/gemBlue.png"],
            EXIT: ["misc_assets/window.png"],
            DIRT: ["misc_assets/dirt.png"],
            OOB_WALL: ["misc_assets/tile_bricksGrey.png"],
        }

    def grid_image_lut(self, cfg):
        # miner.cpp:85-93: moving variants render with the base sprite
        lut = render_pack.default_grid_image_lut()
        lut[MOVING_BOULDER] = BOULDER
        lut[MOVING_DIAMOND] = DIAMOND
        return lut

    def center_agent(self, cfg):
        return self.force_center_agent

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        if mode == DistributionMode.easy:
            dim = 10
        elif mode == DistributionMode.hard:
            dim = 20
        elif mode == DistributionMode.memory:
            dim = 35
        else:
            raise ValueError(f"miner does not support mode {mode}")
        self.world_dim = dim
        self.world_w_max = dim
        self.world_h_max = dim
        self.force_center_agent = mode == DistributionMode.memory
        area = dim * dim
        # miner.cpp:143-148
        self.num_diamonds = int(12 / 400.0 * area)
        self.num_boulders = int(80 / 400.0 * area)
        self.n_picks = self.num_diamonds + self.num_boulders + 1
        self.reset_max_draws = max(256, 2 * self.n_picks + 64)
        self._luts = {}

    def _lut(self, dev):
        key = str(dev)
        if key not in self._luts:
            self._luts[key] = tuple(
                torch.as_tensor(a).to(dev) for a in (_ROUND, _MOVING, _STAT, _FALLING)
            )
        return self._luts[key]

    def init_extra(self, cfg, num_envs, device):
        return {"diamonds_remaining": torch.zeros((num_envs,), dtype=I32, device=device)}

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        wd = torch.full_like(state.main_width, self.world_dim)
        return state.replace(main_width=wd, main_height=wd)

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        # miner.cpp:58-65
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        player_block = (src_type == O.PLAYER) & (
            (target_type == BOULDER) | (target_type == MOVING_BOULDER)
            | (target_type == OOB_WALL)
        )
        return base | player_block

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # miner.cpp:71-83 (no ENEMY is ever spawned; EXIT only)
        exit_hit = (mask & (state.ents.type == EXIT)).any(1)
        win = exit_hit & (state.extra["diamonds_remaining"] == 0)
        return state.replace(
            reward=state.reward + torch.where(win, COMPLETION_BONUS, 0.0),
            level_complete=state.level_complete | win,
            done=state.done | win,
        )

    def set_action_xy(self, cfg, state, move_action):
        # miner.cpp:99-103: horizontal wins over vertical
        avx, avy, avrot = GameDef.set_action_xy(self, cfg, state, move_action)
        return avx, torch.where(avx != 0, 0.0, avy), avrot

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        state = state.replace(grid_step=torch.ones_like(state.grid_step))
        W = self.world_dim
        area = W * W
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)

        # miner.cpp:149-155
        rs, picks = ru.simple_choose(rs, area, self.n_picks)
        picks = picks.to(torch.int64)
        agent_cell = picks[:, 0]
        agent_x = agent_cell % W
        agent_y = torch.div(agent_cell, W, rounding_mode="floor")
        ents = eo.write_slot(
            state.ents, eo.AGENT, rx=0.5, ry=0.5,
            x=agent_x.to(F32) + 0.5, y=agent_y.to(F32) + 0.5,
        )

        # grid: DIRT everywhere, then diamonds and boulders (miner.cpp:157-169)
        flat = torch.full((N, area), DIRT, dtype=I32, device=dev)
        flat.scatter_(1, picks[:, 1:1 + self.num_diamonds], DIAMOND)
        flat.scatter_(1, picks[:, 1 + self.num_diamonds:], BOULDER)
        # dirt snapshot before the agent clearing (miner.cpp:171)
        dirt_mask = flat == DIRT
        flat[b, agent_cell] = O.SPACE
        # clear boulders in the 3x3 around the agent (miner.cpp:175-183)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                ox, oy = agent_x + di, agent_y + dj
                inb = (ox >= 0) & (ox < W) & (oy >= 0) & (oy < W)
                cell = (oy * W + ox).clamp(0, area - 1)
                _set_cells(flat, cell, inb & (flat[b, cell] == BOULDER), DIRT)

        # exit placement (miner.cpp:185-199): dirt cells (snapshot) whose
        # current above-neighbor is DIRT or OOB, in ascending order
        above = torch.cat(
            [flat[:, W:], torch.full((N, W), OOB_WALL, dtype=I32, device=dev)], 1
        )
        cand = dirt_mask & ((above == DIRT) | (above == OOB_WALL))
        rs, pick = R.rs_randn(rs, cand.to(I32).sum(1).clamp(min=1))
        exit_cell = ru.choose_nth_masked(cand, pick)
        flat[b, exit_cell] = O.SPACE
        fields = eo.make_entity(
            (exit_cell % W).to(F32) + 0.5,
            torch.div(exit_cell, W, rounding_mode="floor").to(F32) + 0.5,
            0.0, 0.0, 0.5, 0.5, EXIT,
        )
        fields["render_z"] = -1
        ents, _ = eo.append_entity(ents, fields)

        # diamonds_remaining is deliberately not set here: the reference
        # member (miner.cpp:23) is only recomputed by the game_step sweep
        # (miner.cpp:305) and carries its previous value across resets
        # until the first step.
        return state.replace(ents=ents, grid=flat.reshape(N, W, W)), rs

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        W = self.world_dim
        area = W * W
        N = state.num_envs
        dev = state.done.device
        a = eo.AGENT

        # facing (miner.cpp:250-253)
        ents = state.ents
        refl = torch.where(
            state.action_vx > 0, False,
            torch.where(state.action_vx < 0, True, ents.is_reflected[:, a]),
        )
        ents = eo.write_slot(ents, a, is_reflected=refl)

        # handle_push (miner.cpp:232-245)
        flat = state.grid.reshape(N, area).clone()
        ax, ay = ents.x[:, a], ents.y[:, a]
        agent_idx = ay.to(I32).to(torch.int64) * W + ax.to(I32).to(torch.int64)
        agentx = agent_idx % W
        vx0 = ents.vx[:, a]

        def cell(off):
            return (agent_idx + off).clamp(0, area - 1)

        def at(off):
            return torch.gather(flat, 1, cell(off)[:, None])[:, 0]

        still = vx0 == 0
        pr = (
            (state.action_vx == 1) & still & (agentx < W - 2)
            & (at(1) == BOULDER) & (at(2) == O.SPACE)
        )
        pl = (
            ~pr & (state.action_vx == -1) & still & (agentx > 1)
            & (at(-1) == BOULDER) & (at(-2) == O.SPACE)
        )
        _set_cells(flat, cell(1), pr, O.SPACE)
        _set_cells(flat, cell(2), pr, BOULDER)
        _set_cells(flat, cell(-1), pl, O.SPACE)
        _set_cells(flat, cell(-2), pl, BOULDER)
        new_ax = ax + torch.where(pr, 1.0, torch.where(pl, -1.0, 0.0))
        ents = eo.write_slot(ents, a, x=new_ax)

        # dig (miner.cpp:257-265)
        aix = new_ax.to(I32).to(torch.int64)
        aiy = ay.to(I32).to(torch.int64)
        here = (aiy * W + aix).clamp(0, area - 1)
        obj_here = torch.gather(flat, 1, here[:, None])[:, 0]
        reward = state.reward + torch.where(obj_here == DIAMOND, DIAMOND_REWARD, 0.0)
        _set_cells(flat, here, (obj_here == DIRT) | (obj_here == DIAMOND), O.SPACE)

        with telemetry.span(SWEEP_SPAN):
            flat, diamonds, crushed = self.gravity_sweep(flat, ay, new_ax, aiy * W + aix)

        extra = dict(state.extra)
        extra["diamonds_remaining"] = diamonds
        # no ENEMY entities exist (never spawned), so the per-enemy randn(6)
        # loop (miner.cpp:307-313) consumes no draws
        return state.replace(
            ents=ents,
            grid=flat.reshape(N, W, W).to(I32),
            reward=reward,
            done=state.done | crushed,
            extra=extra,
        )

    def gravity_sweep(self, flat, ay, ax, agent_idx_free):
        """miner.cpp:267-303 over the flat (N, area) grid, ascending cell
        order.  Returns (grid, diamonds (N,) int32, crushed (N,)).  CPU
        tensors run ``gravity_sweep_ref``; CUDA tensors launch the kernel,
        which takes the grid as a contiguous int32 tensor and
        ``agent_idx_free`` as a contiguous int64 one, and returns a new
        int32 grid."""
        if flat.device.type == "cpu":
            return self.gravity_sweep_ref(flat, ay, ax, agent_idx_free)
        global launches
        W = self.world_dim
        N = flat.shape[0]
        dev = flat.device
        if dev.type != "cuda":
            raise ValueError(f"gravity_sweep: unsupported device {dev}")
        if W > KERNEL_MAX_DIM:
            raise ValueError(f"gravity_sweep: world_dim {W} is above {KERNEL_MAX_DIM}")
        if flat.dtype != I32 or flat.shape != (N, W * W) or not flat.is_contiguous():
            raise ValueError(f"gravity_sweep: grid {flat.dtype} {tuple(flat.shape)} is not a "
                             f"contiguous int32 ({N}, {W * W}) tensor")
        fall, free = fall_cell(ay, ax, W), agent_idx_free
        if fall.shape != (N,) or free.shape != (N,) or free.dtype != torch.int64 or (
                fall.device != dev or free.device != dev or not free.is_contiguous()):
            raise ValueError(f"gravity_sweep: the agent's position {tuple(ay.shape)} and cell "
                             f"{free.dtype} {tuple(free.shape)} on {free.device} are not ({N},), "
                             f"the cell a contiguous int64 tensor on {dev}")
        out = torch.empty_like(flat)
        diamonds = torch.empty((N,), dtype=I32, device=dev)
        crushed = torch.empty((N,), dtype=torch.bool, device=dev)
        rc = _lib().miner_sweep_launch(
            flat.data_ptr(), fall.data_ptr(), free.data_ptr(), N, W,
            out.data_ptr(), diamonds.data_ptr(), crushed.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"gravity_sweep: CUDA launch failed (error {rc})")
        launches += 1
        telemetry.count("miner.sweep.kernel_rows", N)
        return out, diamonds, crushed

    def gravity_sweep_ref(self, flat, ay, ax, agent_idx_free):
        """The plain version of ``gravity_sweep``: a loop over the cells,
        each iteration a few batched ops over envs.  Returns flat as int64."""
        W = self.world_dim
        area = W * W
        N = flat.shape[0]
        dev = flat.device
        is_round, is_moving, stat_of, falling_of = self._lut(dev)
        flat = flat.to(torch.int64)
        cells = torch.arange(area, device=dev)[None, :]
        # the falling check reads the agent cell from its float position;
        # is_free uses get_agent_index() (miner.cpp:95-97, 224-226) on the
        # post-push position
        agent_idx2 = fall_cell(ay, ax, W).to(torch.int64)
        agent_at = cells == agent_idx2[:, None]  # (N, area)
        not_agent = cells != agent_idx_free[:, None]
        seen = torch.empty_like(flat)  # each cell's value when swept
        crushed = torch.zeros((N,), dtype=torch.bool, device=dev)

        def free(i):
            # in-grid: the callers' static bounds keep 0 <= i < area
            return (flat[:, i] == O.SPACE) & not_agent[:, i]

        for idx in range(area):
            seen[:, idx] = flat[:, idx]
            obj = seen[:, idx]  # stays put while flat[:, idx] is rewritten
            obj_x = idx % W
            below = idx - W
            is_obj = is_round[obj]
            stat = stat_of[obj]
            if below < 0:  # the OOB wall below: no fall, crush or roll
                flat[:, idx] = torch.where(is_obj, stat, obj)
                continue
            obj2 = flat[:, below]
            agent_below = agent_at[:, below]
            fall = is_obj & (obj2 == O.SPACE) & ~agent_below
            crush = is_obj & ~fall & agent_below & is_moving[obj]
            may_roll = is_obj & ~fall & ~crush & is_round[obj2]
            moved = fall
            rest = ~fall & ~crush
            if obj_x > 0:
                roll_l = may_roll & free(idx - 1) & free(below - 1)
                moved = moved | roll_l
                rest = rest & ~roll_l
            if obj_x < W - 1:
                roll_r = may_roll & free(idx + 1) & free(below + 1)
                if obj_x > 0:
                    roll_r = roll_r & ~roll_l
                moved = moved | roll_r
                rest = rest & ~roll_r
            # the crush branch leaves the cell untouched (miner.cpp:291-292)
            crushed = crushed | crush
            flat[:, idx] = torch.where(moved, O.SPACE, torch.where(is_obj & rest, stat, obj))
            flat[:, below] = torch.where(fall, falling_of[obj], obj2)
            if obj_x > 0:
                flat[:, idx - 1] = torch.where(roll_l, stat, flat[:, idx - 1])
            if obj_x < W - 1:
                flat[:, idx + 1] = torch.where(roll_r, stat, flat[:, idx + 1])
        diamonds = (stat_of[seen] == DIAMOND).sum(1).to(I32)
        return flat, diamonds, crushed

    def serialize_extra(self, w, s, i):
        # miner.cpp:316-319
        w.write_int(s["extra.diamonds_remaining"][i])

    def deserialize_extra(self, r):
        return {"diamonds_remaining": r.read_int()}


register_game("miner")(MinerGame)
