"""Maze and miner, one env at a time, as procgen's C++ states them
(procgen/src/games/maze.cpp, miner.cpp, mazegen.cpp, randgen.cpp and
basic-abstract-game.cpp): level generation from a level seed, and the step.

An env is a ``Level``: its grid (``grid[y, x]``, y up), its entities
(the agent first), the background it drew, the time and the episode's
bookkeeping.  Positions are float32, as in the C++.  Both games move the
agent a whole cell per step (``grid_step``), horizontal moves winning over
vertical, and a move is blocked when one of the four corner probes at
0.98 of the agent's half-size lands on a blocking cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.mt import RandGen

F = np.float32
INT32_MAX = 2**31 - 1

PLAYER, SPACE, WALL_OBJ = 0, 100, 51
MARGIN = F(0.98)  # the corner probes, basic-abstract-game.cpp:276

TOPDOWN_BACKGROUNDS = ["topdown_backgrounds/floortiles.png"] + [
    f"topdown_backgrounds/backgrounddetailed{i}.png" for i in range(1, 9)]
PLATFORM_BACKGROUNDS = [f"platform_backgrounds/{n}.png" for n in (
    "alien_bg", "another_world_bg", "back_cave", "caverns", "cyberpunk_bg", "parallax_forest",
    "scifi_bg", "scifi2_bg", "living_tissue_bg", "airadventurelevel1", "airadventurelevel2",
    "airadventurelevel3", "airadventurelevel4", "cave_background", "blue_desert", "blue_grass",
    "blue_land", "blue_shroom", "colored_desert", "colored_grass", "colored_land",
    "colored_shroom", "landscape1", "landscape2", "landscape3", "landscape4")] + [
    f"platform_backgrounds/battleback{i}.png" for i in range(1, 11)] + [
    "platform_backgrounds/sunrise.png"] + [
    f"platform_backgrounds_2/{k}{i}.png" for k in ("beach", "fantasy", "candy")
    for i in range(1, 5)] + [f"space_backgrounds/{n}.png" for n in (
        "deep_space_01", "spacegen_01", "milky_way_01", "ez_space_lite_01", "meyespace_v1_01",
        "eye_nebula_01", "deep_sky_01", "space_nebula_01", "Background-1", "Background-2",
        "Background-3", "Background-4", "parallax-space-backgound")]  # the space set follows


@dataclasses.dataclass
class Entity:
    x: np.float32
    y: np.float32
    rx: np.float32
    ry: np.float32
    type: int
    z: int = 0  # render_z
    reflected: bool = False
    alpha: np.float32 = F(1.0)


@dataclasses.dataclass
class Level:
    seed: int
    grid: np.ndarray  # int32 (H, W), [y, x]
    ents: list  # the agent first
    bg_pct_x: np.float32
    background: int
    cur_time: int = 0
    diamonds_remaining: int = 0  # miner; kept across resets, as the C++ member

    @property
    def agent(self) -> Entity:
        return self.ents[0]


def _base_reset(game, r: RandGen, seed: int, random_agent_start: bool) -> Level:
    """BasicAbstractGame::game_reset's draws: the background's offset and
    index, and (where the game places the agent itself afterwards) the two
    draws of a random agent start."""
    bg_pct_x = r.rand01()
    background = r.randn(len(game.backgrounds))
    if random_agent_start:
        r.rand01()
        r.rand01()
    agent = Entity(F(0.4), F(0.4), F(0.4), F(0.4), PLAYER, z=1)
    w = game.world_dim
    return Level(seed, np.full((w, w), SPACE, np.int32), [agent], bg_pct_x, background)


def _cell(level: Level, fx, fy, oob: int) -> int:
    if fx < 0 or fy < 0:
        return oob
    x, y = int(np.floor(fx)), int(np.floor(fy))
    h, w = level.grid.shape
    return int(level.grid[y, x]) if 0 <= x < w and 0 <= y < h else oob


def _move_agent(game, level: Level, avx: int, avy: int) -> bool:
    """The agent's grid step: one pass along each axis, the moving axis
    first; a pass whose corner probes touch a blocking cell leaves the agent
    where it was.  Returns whether the horizontal pass was blocked."""
    a = level.agent
    passes = [(avx, 0), (0, avy)] if avx != 0 or avy == 0 else [(0, avy), (avx, 0)]
    blocked_x = False
    for dx, dy in passes:
        nx, ny = F(a.x + F(dx)), F(a.y + F(dy))
        rxm, rym = F(a.rx * MARGIN), F(a.ry * MARGIN)
        probes = [(F(nx - rxm), F(ny - rym)), (F(nx - rxm), F(ny + rym)),
                  (F(nx + rxm), F(ny - rym)), (F(nx + rxm), F(ny + rym))]
        if any(game.blocks(_cell(level, px, py, game.oob)) for px, py in probes):
            blocked_x |= dx != 0
        else:
            a.x, a.y = nx, ny
    return blocked_x


def _move_action(action: int):
    move = action % 9 if action < 9 else 4
    avx, avy = move // 3 - 1, move % 3 - 1
    return avx, (0 if avx != 0 else avy)  # horizontal wins (maze.cpp, miner.cpp)


# ---------------------------------------------------------------------------
# maze
# ---------------------------------------------------------------------------


def generate_maze(r: RandGen, md: int):
    """mazegen.cpp's Kruskal maze on an md x md grid (md odd) inside a wall
    border: returns (grid (md + 2, md + 2) [y, x] with the border, the free
    cells y * md + x in the order they were freed)."""
    grid = np.full((md + 2, md + 2), WALL_OBJ, np.int32)
    grid[1, 1] = SPACE
    free, is_free = [], set()
    label = list(range(md * md))
    walls = [(i - 1, j, i + 1, j) for i in range(1, md, 2) for j in range(0, md, 2)
             if 0 < i < md - 1]
    walls += [(i, j - 1, i, j + 1) for i in range(0, md, 2) for j in range(1, md, 2)
              if 0 < j < md - 1]

    def set_free(x, y):
        grid[y + 1, x + 1] = SPACE
        c = md * y + x
        if c not in is_free:
            is_free.add(c)
            free.append(c)

    while walls:
        x1, y1, x2, y2 = walls.pop(r.randn(len(walls)))
        s0, s1 = label[md * y1 + x1], label[md * y2 + x2]
        x0, y0 = (x1 + x2) // 2, (y1 + y2) // 2
        if grid[y0 + 1, x0 + 1] == WALL_OBJ and s0 != s1:
            set_free(x1, y1)
            set_free(x0, y0)
            set_free(x2, y2)
            label = [s1 if s == s0 else s for s in label]
            label[md * y0 + x0] = s1
    return grid, free


class Maze:
    name = "maze"
    timeout = 500
    world_dim = 25  # hard
    oob = WALL_OBJ
    GOAL = 2
    backgrounds = TOPDOWN_BACKGROUNDS
    sprites = {WALL_OBJ: "kenney/Ground/Sand/sandCenter.png", 2: "misc_assets/cheese.png",
               PLAYER: "kenney/Enemies/mouse_move.png"}
    grid_images = {WALL_OBJ: WALL_OBJ, 2: 2}  # cell type -> sprite drawn
    grid_dynamic = False

    def blocks(self, cell: int) -> bool:
        return cell == WALL_OBJ

    def reset(self, r: RandGen, seed: int, prev: Level | None) -> Level:
        level = _base_reset(self, r, seed, random_agent_start=False)
        wd = self.world_dim
        md = r.randn((wd - 1) // 2) * 2 + 3
        m = (wd - md) // 2
        a = level.agent
        a.rx = a.ry = F(0.5)
        a.x = a.y = F(m + 0.5)
        grid, free = generate_maze(r, md)
        for j in range(1):  # place_objects(GOAL, 1)
            k = r.randn(len(free))
            while free[k] in (-1, 0):
                k = r.randn(len(free))
            cell, free[k] = free[k], -1
            grid[cell // md + 1, cell % md + 1] = self.GOAL + j
        level.grid[:] = WALL_OBJ
        level.grid[m:m + md, m:m + md] = grid[1:md + 1, 1:md + 1]
        return level

    def step(self, level: Level, action: int) -> tuple:
        """(reward, done) of the game step."""
        avx, avy = _move_action(action)
        _move_agent(self, level, avx, avy)
        a = level.agent
        if avx != 0:
            a.reflected = avx > 0
        x, y = int(a.x), int(a.y)
        if level.grid[y, x] == self.GOAL:
            level.grid[y, x] = SPACE
            return F(10.0), True
        return F(0.0), False


# ---------------------------------------------------------------------------
# miner
# ---------------------------------------------------------------------------

BOULDER, DIAMOND, MOVING_BOULDER, MOVING_DIAMOND, EXIT, DIRT, OOB_WALL = 1, 2, 3, 4, 6, 9, 10
_ROUND = (BOULDER, DIAMOND, MOVING_BOULDER, MOVING_DIAMOND)
_SETTLED = {MOVING_BOULDER: BOULDER, MOVING_DIAMOND: DIAMOND}
_FALLING = {BOULDER: MOVING_BOULDER, DIAMOND: MOVING_DIAMOND}


class Miner:
    name = "miner"
    timeout = 1000
    world_dim = 20  # hard
    oob = OOB_WALL
    num_diamonds = 12  # int(12 / 400 * 400)
    num_boulders = 80
    backgrounds = PLATFORM_BACKGROUNDS
    sprites = {PLAYER: "misc_assets/robot_greenDrive1.png",
               BOULDER: "misc_assets/elementStone007.png", DIAMOND: "misc_assets/gemBlue.png",
               EXIT: "misc_assets/window.png", DIRT: "misc_assets/dirt.png",
               OOB_WALL: "misc_assets/tile_bricksGrey.png"}
    # moving boulders and diamonds draw with the settled sprite
    grid_images = {BOULDER: BOULDER, DIAMOND: DIAMOND, MOVING_BOULDER: BOULDER,
                   MOVING_DIAMOND: DIAMOND, EXIT: EXIT, DIRT: DIRT, OOB_WALL: OOB_WALL}
    grid_dynamic = True

    def blocks(self, cell: int) -> bool:  # the agent's blocking cells
        return cell in (WALL_OBJ, OOB_WALL, BOULDER, MOVING_BOULDER)

    def reset(self, r: RandGen, seed: int, prev: Level | None) -> Level:
        level = _base_reset(self, r, seed, random_agent_start=True)
        if prev is not None:
            level.diamonds_remaining = prev.diamonds_remaining
        W = self.world_dim
        area = W * W
        picks, seen = [], set()
        for _ in range(1 + self.num_diamonds + self.num_boulders):  # simple_choose
            k = r.randn(area)
            while k in seen:
                k = r.randn(area)
            seen.add(k)
            picks.append(k)
        flat = np.full(area, DIRT, np.int32)
        flat[picks[1:1 + self.num_diamonds]] = DIAMOND
        flat[picks[1 + self.num_diamonds:]] = BOULDER
        dirt = flat == DIRT
        agent = picks[0]
        ax, ay = agent % W, agent // W
        a = level.agent
        a.rx = a.ry = F(0.5)
        a.x, a.y = F(ax + 0.5), F(ay + 0.5)
        flat[agent] = SPACE
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                x, y = ax + i, ay + j
                if 0 <= x < W and 0 <= y < W and flat[y * W + x] == BOULDER:
                    flat[y * W + x] = DIRT
        cand = [c for c in range(area)
                if dirt[c] and (c + W >= area or flat[c + W] == DIRT)]
        ex = cand[r.randn(len(cand))]
        flat[ex] = SPACE
        level.ents.append(Entity(F(ex % W + 0.5), F(ex // W + 0.5), F(0.5), F(0.5), EXIT, z=-1))
        level.grid = flat.reshape(W, W)
        return level

    def step(self, level: Level, action: int) -> tuple:
        W = self.world_dim
        avx, avy = _move_action(action)
        blocked_x = _move_agent(self, level, avx, avy)
        a = level.agent
        reward, done = F(0.0), False
        for e in level.ents[1:]:  # the exit, won once no diamond is left
            if (e.type == EXIT and abs(F(a.x - e.x)) < F(a.rx + e.rx)
                    and abs(F(a.y - e.y)) < F(a.ry + e.ry) and level.diamonds_remaining == 0):
                reward, done = F(reward + F(10.0)), True
        if avx != 0:
            a.reflected = avx < 0
        flat = level.grid.reshape(-1)
        idx = int(a.y) * W + int(a.x)
        still = avx == 0 or blocked_x
        x = idx % W
        if avx == 1 and still and x < W - 2 and flat[idx + 1] == BOULDER and flat[idx + 2] == SPACE:
            flat[idx + 1], flat[idx + 2] = SPACE, BOULDER
            a.x = F(a.x + F(1.0))
        elif (avx == -1 and still and x > 1 and flat[idx - 1] == BOULDER
              and flat[idx - 2] == SPACE):
            flat[idx - 1], flat[idx - 2] = SPACE, BOULDER
            a.x = F(a.x - F(1.0))
        here = int(a.y) * W + int(a.x)
        if flat[here] == DIAMOND:
            reward = F(reward + F(1.0))
        if flat[here] in (DIRT, DIAMOND):
            flat[here] = SPACE
        crushed = self._gravity(flat, level, here)
        return reward, done or crushed

    def _gravity(self, flat: np.ndarray, level: Level, agent_cell: int) -> bool:
        """miner.cpp's sweep in ascending cell order, in place: boulders and
        diamonds fall into space below, crush the agent if they were
        already falling onto it, and roll off round objects into free
        space; counts the diamonds.  Returns whether the agent was
        crushed."""
        W = self.world_dim
        a = level.agent
        below_agent = int(F(F(F(a.y - F(0.5)) * F(W)) + F(a.x - F(0.5))))
        crushed, diamonds = False, 0

        def free(i):
            return flat[i] == SPACE and i != agent_cell

        for idx in range(W * W):
            obj = int(flat[idx])
            if obj in (DIAMOND, MOVING_DIAMOND):
                diamonds += 1
            if obj not in _ROUND:
                continue
            settled = _SETTLED.get(obj, obj)
            below = idx - W
            if below < 0:
                flat[idx] = settled
                continue
            obj2 = int(flat[below])
            if obj2 == SPACE and below != below_agent:
                flat[idx], flat[below] = SPACE, _FALLING.get(obj, obj)
            elif below == below_agent and obj in (MOVING_BOULDER, MOVING_DIAMOND):
                crushed = True  # the cell is left as it is
            elif obj2 in _ROUND and idx % W > 0 and free(idx - 1) and free(below - 1):
                flat[idx], flat[idx - 1] = SPACE, settled
            elif obj2 in _ROUND and idx % W < W - 1 and free(idx + 1) and free(below + 1):
                flat[idx], flat[idx + 1] = SPACE, settled
            else:
                flat[idx] = settled
        level.diamonds_remaining = diamonds
        return crushed


GAMES = {"maze": Maze, "miner": Miner}
