"""Jumper: an open-world double-jump platformer with a compass toward the
carrot (reference games/jumper.cpp); counterpart of
``procgen_tpu/games/jumper.py``.

A center-agent view over a square cave world (20, 40 or 45 cells).  Level
generation: a coarse maze bias with per-cell noise, two cellular-automaton
rounds, the largest room, a path from the agent to the goal widened by four
cells (except in memory mode), then three scans in ascending cell order:
spike placement, the long-wall fix and spikes into entities.  The HUD draws
a compass, a distance bar and, after a double jump, a landing shadow.

The first two scans draw in cell order and each placement changes later
cells, so they are sequential; they loop over the cells that can act rather
than over all of them (see ``_place_spikes`` and ``_fix_long_walls``).
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
from procgen_torch.engine import physics as ph
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.engine.levelgen import mazegen, roomgen
from procgen_torch.engine.rand_util import choose_nth_masked, first_true
from procgen_torch.games import register_game
from procgen_torch.render.renderer import rgb_constant
from procgen_torch.state import F32, I32, EnvState

GOAL_REWARD = 10.0

GOAL = 1
SPIKE = 2
CAVEWALL = 6
CAVEWALL_TOP = 7
PLAYER_JUMP = 9
PLAYER_LEFT1 = 10
PLAYER_LEFT2 = 11
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13

MAZE_SCALE = 3
JUMP_COOLDOWN = 3
NUM_WALL_THEMES = 4

CLOCK_COLOR = (168.0, 166.0, 158.0)  # jumper.cpp:139
HIGHLIGHT_COLOR = (252.0, 186.0, 3.0)
WHITE = (255.0, 255.0, 255.0)

GOAL_SLOT = 1  # the goal spawns right after the agent and is never erased

# profiler spans of the reset's three cell scans (read by bench/op_counts.py)
SCANS_SPAN = "procgen_torch.jumper.levelgen_scans"


def _is_wall(t):
    return (t == CAVEWALL) | (t == CAVEWALL_TOP)


def _at(grid, dx, dy):
    """``grid[y + dy, x + dx]`` at every cell, WALL_OBJ (the out-of-bounds
    object during level generation, jumper.cpp:251) outside."""
    return roomgen.shift(grid, dx, dy, O.WALL_OBJ)


def _space_on_ground(grid):
    """is_space_on_ground (jumper.cpp:180-187) at every cell: SPACE with
    SPACE above and CAVEWALL or the out-of-bounds object below."""
    below = _at(grid, 0, -1)
    return (
        (grid == O.SPACE) & (_at(grid, 0, 1) == O.SPACE)
        & ((below == CAVEWALL) | (below == O.WALL_OBJ))
    )


def _long_walls(grid):
    """Cells where the long-vertical-wall fix fires (jumper.cpp:340-351): a
    CAVEWALL column of three cells with SPACE beside all three, on the
    right (is_left_wall) or on the left (is_right_wall).  (N, H * W)."""
    wall = grid == CAVEWALL
    lw = wall & (_at(grid, 1, 0) == O.SPACE)
    rw = wall & (_at(grid, -1, 0) == O.SPACE)

    def run3(m):
        return m & roomgen.shift(m, 0, 1, False) & roomgen.shift(m, 0, 2, False)

    return (run3(lw) | run3(rw)).flatten(1)


class Jumper(GameDef):
    name = "jumper"
    background_group = "platform_backgrounds"
    out_of_bounds_object = CAVEWALL
    max_substeps = 8
    entity_rotations = "none"
    grid_theme_count = NUM_WALL_THEMES

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        if mode == DistributionMode.hard:
            self.world_dim = 40
        elif mode == DistributionMode.memory:
            self.world_dim = 45
        else:
            self.world_dim = 20
        self.memory = mode == DistributionMode.memory
        self.easy = mode == DistributionMode.easy
        if self.memory:
            self.timeout = 2000
        self.world_w_max = self.world_dim
        self.world_h_max = self.world_dim
        self.visibility_val = 12.0 if self.easy else 16.0
        self.compass_dim = 3.0 if self.easy else 2.0
        self.spike_prob = 0.0 if self.memory else 0.2
        G = self.world_dim * self.world_dim
        # agent + goal + spikes (a generous bound) + ~9 live trails
        self.max_entities = 2 + (16 if self.easy else 96) + 12
        self.reset_max_draws = G + 1024

    def use_block_asset(self, type_):
        # jumper.cpp:107-109
        return type_ in (CAVEWALL, CAVEWALL_TOP)

    def asset_map(self, cfg):
        # jumper.cpp:50-79
        return {
            O.PLAYER: ["misc_assets/bunny2_ready.png"],
            SPIKE: ["misc_assets/spikeMan_stand.png"],
            GOAL: ["misc_assets/carrot.png"],
            PLAYER_JUMP: ["misc_assets/bunny2_jump.png"],
            PLAYER_RIGHT1: ["misc_assets/bunny2_walk1.png"],
            PLAYER_RIGHT2: ["misc_assets/bunny2_walk2.png"],
            PLAYER_LEFT1: ["misc_assets/bunny2_walk1.png"],
            PLAYER_LEFT2: ["misc_assets/bunny2_walk2.png"],
            CAVEWALL_TOP: [
                "platformer/tileBlue_05.png", "platformer/tileGreen_05.png",
                "platformer/tileYellow_06.png", "platformer/tileBrown_06.png",
            ],
            CAVEWALL: [
                "platformer/tileBlue_08.png", "platformer/tileGreen_08.png",
                "platformer/tileYellow_09.png", "platformer/tileBrown_09.png",
            ],
            O.TRAIL: ["misc_assets/iconCircle_white.png"],
        }

    def grid_themed_types(self):
        return (CAVEWALL, CAVEWALL_TOP)

    def grid_theme_state(self, cfg, states):
        return states.extra["wall_theme"]

    def init_extra(self, cfg, num_envs, device):
        def full(v, dtype):
            return torch.full((num_envs,), v, dtype=dtype, device=device)

        return {
            "jump_count": full(0, I32),
            "jump_delta": full(0, I32),
            "jump_time": full(0, I32),
            "has_support": full(False, torch.bool),
            "facing_right": full(True, torch.bool),
            "wall_theme": full(0, I32),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, self.world_dim)
        return state.replace(main_width=d, main_height=d)

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        return base | ((src_type == O.PLAYER) & _is_wall(target_type))

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # jumper.cpp:94-100; gravity applies in game_step
        ents = state.ents
        a = eo.AGENT
        vx = (1 - state.mixrate) * ents.vx[:, a]
        vx = vx + state.mixrate * state.maxspeed * state.action_vx
        vy = torch.where(
            state.action_vy != 0, state.maxspeed * state.action_vy * 2, ents.vy[:, a]
        )
        return state.replace(ents=eo.write_slot(ents, a, vx=vx, vy=vy))

    def entity_image_override(self, cfg, states):
        # image_for_type (jumper.cpp:122-137)
        ents = states.ents
        has_support = states.extra["has_support"]
        standing = (
            (torch.abs(ents.vx[:, eo.AGENT]) < 0.01) & (states.action_vx == 0) & has_support
        )
        walk1 = (torch.div(states.cur_time, 5, rounding_mode="floor") % 2 == 0) | ~has_support
        right = states.extra["facing_right"]
        img = torch.where(
            standing,
            O.PLAYER,
            torch.where(
                right,
                torch.where(walk1, PLAYER_RIGHT1, PLAYER_RIGHT2),
                torch.where(walk1, PLAYER_LEFT1, PLAYER_LEFT2),
            ),
        ).to(I32)
        out = ents.image_type.clone()
        out[:, eo.AGENT] = img
        return out

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # jumper.cpp:81-91
        t = state.ents.type
        goal = (mask & (t == GOAL)).any(1)
        dead = (mask & (t == SPIKE)).any(1)
        return state.replace(
            reward=state.reward + torch.where(goal, GOAL_REWARD, 0.0),
            done=state.done | goal | dead,
            level_complete=state.level_complete | goal,
        )

    def hud_overlay(self, cfg, states, out, SX, SY):
        """The compass, the distance bar and the landing shadow
        (jumper.cpp:137-177).  Qt's antialiased ellipse and line coverage is
        approximated by signed distance, as in the reference package; the
        trig runs in float64 and narrows (fmath.atan2_wide), so the card and
        the CPU agree."""
        if self.memory:
            return out
        dev = out.device
        ents = states.ents
        a, g = eo.AGENT, GOAL_SLOT

        def env(v):
            return v[:, None, None]

        def sq(v):
            return v * v

        unit = env(states.unit)
        cdim = fm.f32(self.compass_dim)
        x0 = (env(states.view_dim) - cdim - 0.25) * unit
        y0 = 0.25 * unit
        w = cdim * unit
        cx = x0 + fm.div_const(w, 2)
        cy = y0 + fm.div_const(w, 2)
        r = fm.div_const(w, 2)
        inside_disc = sq(SX - cx) + sq(SY - cy) <= r * r
        out = torch.where(inside_disc[..., None], rgb_constant(CLOCK_COLOR, dev), out)

        theta = fm.atan2_wide(ents.y[:, g] - ents.y[:, a], ents.x[:, g] - ents.x[:, a])
        cr = r * 0.95
        ex_ = cx + cr * env(fm.cos_wide(theta))
        ey_ = cy - cr * env(fm.sin_wide(theta))
        # distance from the pixel centre to the needle segment
        dx, dy = ex_ - cx, ey_ - cy
        L2 = torch.clamp(dx * dx + dy * dy, min=fm.f32(1e-6))
        t_ = torch.clamp(((SX - cx) * dx + (SY - cy) * dy) / L2, 0.0, 1.0)
        px = cx + t_ * dx
        py = cy + t_ * dy
        # rect.width() / (256 / cdim) / 2, float
        pen = np.float32(64.0) / (np.float32(256.0) / np.float32(cdim)) / np.float32(2)
        on_line = sq(SX - px) + sq(SY - py) <= float(pen * pen)
        highlight = rgb_constant(HIGHLIGHT_COLOR, dev)
        out = torch.where(on_line[..., None], highlight, out)

        dist = fm.sqrt32(
            sq(ents.x[:, a] - ents.x[:, g]) + sq(ents.y[:, a] - ents.y[:, g])
        )
        dist_pct = dist / (states.main_width.to(F32) * fm.f32(np.sqrt(2)))
        bar_h = float(np.float32(cdim) / np.float32(8)) * unit
        by0 = fm.f32(0.25 + cdim) * unit + y0 - 0.25 * unit
        bw = env(cdim * dist_pct) * unit
        in_bar = (SX >= x0) & (SX < x0 + bw) & (SY >= by0) & (SY < by0 + bar_h)
        out = torch.where(in_bar[..., None], highlight, out)

        # the landing shadow while mid-air after a double jump
        # (jumper.cpp:166-171)
        show = (states.extra["jump_delta"] < 0) & ~states.extra["has_support"]
        ax, ay = env(ents.x[:, a]), env(ents.y[:, a])
        arx, ary = env(ents.rx[:, a]), env(ents.ry[:, a])
        rx0 = (ax - arx) * unit - env(states.x_off)
        ry0 = (env(states.view_dim) - (ay + ary)) * unit + env(states.y_off)
        rw = 2 * arx * unit
        rh = 2 * ary * unit
        ecx = rx0 + fm.div_const(rw, 2)
        ecy = ry0 + rh * fm.f32(5.0 / 6) + fm.div_const(rh, 6)
        era = fm.div_const(rw, 2)
        erb = fm.div_const(rh, 6)
        ell = (
            sq((SX - ecx) / torch.clamp(era, min=fm.f32(1e-6)))
            + sq((SY - ecy) / torch.clamp(erb, min=fm.f32(1e-6)))
        ) <= 1
        alpha = np.float32(120.0 / 255.0)
        white = rgb_constant(tuple(float(np.float32(c) * alpha) for c in WHITE), dev)
        blended = white + out * float(np.float32(1) - alpha)
        return torch.where((ell & env(show))[..., None], blended, out)

    def set_action_xy(self, cfg, state, move_action):
        # jumper.cpp:389-423: a double jump with a cooldown
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
        has_support = _is_wall(b1) | _is_wall(b2)  # the OOB object is CAVEWALL
        extra["has_support"] = has_support
        jc = torch.where(has_support, 2, extra["jump_count"])
        can_jump = (avy == 1) & (jc > 0) & (state.cur_time - extra["jump_time"] > JUMP_COOLDOWN)
        extra["jump_count"] = (jc - can_jump.to(I32)).to(I32)
        extra["jump_delta"] = torch.where(can_jump, -1, 0).to(I32)
        avy = torch.where(can_jump, avy, 0.0)
        extra["jump_time"] = torch.where(avy > 0, state.cur_time, extra["jump_time"])
        return avx, avy, torch.zeros_like(avx), state.replace(extra=extra)

    # ---- level generation (jumper.cpp:240-380) ----

    def _place_spikes(self, rs, grid):
        """Spike placement (jumper.cpp:326-337): an ascending scan that draws
        at every cell on the ground with ground on both sides, and places a
        spike with probability spike_prob.  A spike turns its cell from
        SPACE to SPIKE, which changes is_space_on_ground only at that cell
        and at the one below it (an earlier row): the only later cell it
        disqualifies is its right neighbour.  So the cells that draw are the
        qualifying cells of the grid before the scan, less the right
        neighbours of placed spikes; the loop runs over those cells in
        ascending order, the batch's largest count of them (read once)."""
        N = grid.shape[0]
        dev = grid.device
        G = grid[0].numel()
        sog = _space_on_ground(grid)
        ok0 = (
            sog & roomgen.shift(sog, -1, 0, False) & roomgen.shift(sog, 1, 0, False)
        ).flatten(1)
        n_ok = ok0.sum(1)
        cell = torch.arange(G, device=dev)
        cells = torch.sort(torch.where(ok0, cell, G + cell), 1).values
        prev = torch.full((N,), -2, dtype=torch.int64, device=dev)
        prev_placed = torch.zeros((N,), dtype=torch.bool, device=dev)
        placed = []
        telemetry.count("host_reads.jumper.spike_cells")
        K = int(n_ok.max())
        for k in range(K):
            c = cells[:, k]
            ok = (k < n_ok) & ~(prev_placed & (prev == c - 1))
            rs, u = R.rs_rand01(rs, active=ok)
            prev_placed = ok & (u < fm.f32(self.spike_prob))
            prev = c
            placed.append(prev_placed)
        if K:
            spike = torch.zeros((N, G + 1), dtype=torch.bool, device=dev)
            spike.scatter_(1, cells[:, :K].clamp(max=G), torch.stack(placed, 1))
            grid = torch.where(spike[:, :G].reshape(grid.shape), SPIKE, grid)
        return rs, grid

    def _fix_long_walls(self, rs, grid):
        """The long-vertical-wall fix (jumper.cpp:340-351): an ascending
        scan; at a cell that tops a CAVEWALL column of three with SPACE
        beside it, one randn(3) picks a cell of the column to open.  Cells
        that do not fire neither draw nor write, so each env's next firing
        cell is the first at or past its scan position that fires on its
        current grid; each iteration fires one cell in every env that has
        one.  (After a fire on the left-wall test the right-wall test of the
        same cell fails: the opened cell is no wall.)  The loop stops when
        no env has a cell left, checked every few iterations."""
        N, H, W = grid.shape
        dev = grid.device
        G = H * W
        b = torch.arange(N, device=dev)
        cell = torch.arange(G, device=dev)[None, :]
        pos = torch.zeros((N, 1), dtype=torch.int64, device=dev)
        while True:
            for _ in range(8):
                cand = _long_walls(grid) & (cell >= pos)
                fire = cand.any(1)
                c = first_true(cand)
                rs, o = R.rs_randn(rs, 3, active=fire)
                x = c % W
                yy = torch.div(c, W, rounding_mode="floor") + o
                grid = grid.clone()
                grid[b, yy.clamp(max=H - 1), x] = torch.where(
                    fire, O.SPACE, grid[b, yy.clamp(max=H - 1), x]
                )
                pos = torch.where(fire, c + 1, G)[:, None]
            telemetry.count("host_reads.jumper.wall_test")
            if not bool((pos < G).any()):
                return rs, grid

    def game_reset(self, cfg, state: EnvState, rs):
        N = state.num_envs
        dev = state.done.device
        state = state.replace(
            visibility=torch.full((N,), self.visibility_val, dtype=F32, device=dev)
        )
        state, rs = base_game_reset(self, cfg, state, rs)
        dim = self.world_dim
        G = dim * dim
        dimt = torch.full((N,), dim, dtype=I32, device=dev)

        rs, wall_theme = R.rs_randn(rs, NUM_WALL_THEMES)

        # a coarse maze bias and per-cell noise (jumper.cpp:245-259)
        maze_dim = dim // MAZE_SCALE
        rs, mgrid = mazegen.generate_maze_no_dead_ends(
            rs, torch.full((N,), maze_dim, dtype=I32, device=dev), maze_dim
        )
        coarse = torch.arange(dim, device=dev) // MAZE_SCALE + 1
        coarse_wall = mgrid[:, coarse[:, None], coarse[None, :]] == O.WALL_OBJ
        rs, noise = R.rs_rand01_vec(rs, G)
        prob = torch.where(coarse_wall, fm.f32(0.8), fm.f32(0.2))
        grid = torch.where(noise.reshape(N, dim, dim) < prob, O.WALL_OBJ, O.SPACE).to(I32)

        for _ in range(2):
            grid = roomgen.ca_update(grid, dimt)

        # borders as CAVEWALL, which is neither WALL nor SPACE to the room
        # search (jumper.cpp:264-274)
        grid = grid.clone()
        grid[:, 0, :] = CAVEWALL
        grid[:, dim - 1, :] = CAVEWALL
        grid[:, :, 0] = CAVEWALL
        grid[:, :, dim - 1] = CAVEWALL

        best = roomgen.best_room_mask(grid, dimt)
        grid = torch.where(best, O.SPACE, CAVEWALL).to(I32)

        free_flat = best.flatten(1)
        rs, gpick = R.rs_randn(rs, torch.clamp(free_flat.sum(1), min=1))
        goal_cell = choose_nth_masked(free_flat, gpick)

        # agent candidates: SPACE with SPACE above and CAVEWALL or OOB below
        gflat = _space_on_ground(grid).flatten(1)
        rs, apick = R.rs_randn(rs, torch.clamp(gflat.sum(1), min=1))
        agent_cell = choose_nth_masked(gflat, apick)

        path_flat = roomgen.find_path_mask(grid, dimt, agent_cell, goal_cell)
        path_mask = roomgen.flat_to_grid_mask(path_flat, dimt, dim, dim)

        if not self.memory:
            # prune: widen the path and wall everything else (CAVEWALL)
            wide = roomgen.expand_mask(grid, dimt, path_mask, 4)
            grid = torch.where(wide, O.SPACE, CAVEWALL).to(I32)

        gfields = eo.make_entity(
            (goal_cell % dim).to(F32) + 0.5,
            torch.div(goal_cell, dim, rounding_mode="floor").to(F32) + 0.5,
            0.0, 0.0, 0.5, 0.5, GOAL,
        )
        ents, _ = eo.append_entity(state.ents, gfields)

        with telemetry.span(SCANS_SPAN):
            rs, grid = self._place_spikes(rs, grid)
            rs, grid = self._fix_long_walls(rs, grid)

            ents = eo.write_slot(
                ents, eo.AGENT,
                x=(agent_cell % dim).to(F32) + 0.5,
                y=torch.div(agent_cell, dim, rounding_mode="floor").to(F32) + ents.ry[:, eo.AGENT],
            )

            # spike cells -> entities, in ascending cell order
            # (get_cells_with_type), capped by the table as each append is
            is_spike = (grid == SPIKE).flatten(1)
            grid = torch.where(grid == SPIKE, O.SPACE, grid)
            cell = torch.arange(G, device=dev)
            sfields = eo.make_entity(
                (cell % dim).to(F32).add(0.5).expand(N, G),
                torch.div(cell, dim, rounding_mode="floor").to(F32).add(0.4).expand(N, G),
                0.0, 0.0, 0.23, 0.4, SPIKE,
            )
            ents = eo.append_entities_masked(ents, sfields, is_spike, descending=False)

        # top-wall caps (jumper.cpp:367-374); out of bounds above is no SPACE
        top = (grid == CAVEWALL) & (_at(grid, 0, 1) == O.SPACE)
        grid = torch.where(top, CAVEWALL_TOP, grid).to(I32)

        state = state.replace(
            ents=eo.write_slot(ents, eo.AGENT, rx=fm.f32(0.254), ry=fm.f32(0.4)),
            grid=grid,
            out_of_bounds_object=torch.full((N,), CAVEWALL, dtype=I32, device=dev),
        )
        extra = dict(state.extra)
        extra["wall_theme"] = wall_theme
        for k in ("jump_count", "jump_delta", "jump_time"):
            extra[k] = torch.zeros((N,), dtype=I32, device=dev)
        extra["has_support"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        extra["facing_right"] = torch.ones((N,), dtype=torch.bool, device=dev)
        return state.replace(extra=extra), rs

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        ents = state.ents
        a = eo.AGENT

        refl = torch.where(
            state.action_vx > 0, False,
            torch.where(state.action_vx < 0, True, ents.is_reflected[:, a]),
        )
        ents = eo.write_slot(ents, a, is_reflected=refl)

        # the motion trail (jumper.cpp:436-441)
        moving = torch.abs(ents.vx[:, a]) + torch.abs(ents.vy[:, a]) > 0.05
        trail = eo.make_entity(
            ents.x[:, a], ents.y[:, a] - ents.ry[:, a] * 0.5, 0.0, fm.f32(0.01), 0.3, 0.2, O.TRAIL
        )
        trail.update(expire_time=8, alpha=0.5)
        ents, _ = eo.append_entity(ents, trail, active=moving)

        # gravity (jumper.cpp:443-445)
        vy = ents.vy[:, a]
        vy = torch.where(vy > -2, vy - fm.f32(0.15), vy)
        return state.replace(ents=eo.write_slot(ents, a, vy=vy))

    def serialize_extra(self, w, s, i):
        # jumper.cpp:448-463
        w.write_int(s["extra.jump_count"][i])
        w.write_int(s["extra.jump_delta"][i])
        w.write_int(s["extra.jump_time"][i])
        w.write_bool(s["extra.has_support"][i])
        w.write_bool(s["extra.facing_right"][i])
        w.write_int(s["extra.wall_theme"][i])
        w.write_float(self.compass_dim)

    def deserialize_extra(self, r):
        out = {"jump_count": r.read_int(), "jump_delta": r.read_int(),
               "jump_time": r.read_int(), "has_support": r.read_bool(),
               "facing_right": r.read_bool(), "wall_theme": r.read_int()}
        r.read_float()  # compass_dim
        return out


register_game("jumper")(Jumper)
