"""CoinRun: the flagship platformer -- run right, dodge hazards, grab the
coin (reference games/coinrun.cpp); counterpart of
``procgen_tpu/games/coinrun.py``.

A center-agent view over a 64x64 world with walls themed per env.  Walking
enemies are smart entities that sub-step with the agent; crates block the
agent and the enemies through the vectorized push branch of
``engine/physics.py``.  Level generation runs the reference's section loop
for its worst case of five sections, every draw masked per env.
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
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step
from procgen_torch.games import register_game
from procgen_torch.state import F32, I32, EnvState

GOAL_REWARD = 10.0

GOAL = 1
SAW = 2
SAW2 = 3
ENEMY = 5
ENEMY1 = 6
ENEMY2 = 7
PLAYER_JUMP = 9
PLAYER_RIGHT1 = 12
PLAYER_RIGHT2 = 13
WALL_MID = 15
WALL_TOP = 16
LAVA_MID = 17
LAVA_TOP = 18
ENEMY_BARRIER = 19
CRATE = 20

GRAVITY = 0.2
MAX_JUMP = 1.5
AIR_CONTROL = 0.15

WALKING_ENEMIES = (
    "slimeBlock", "slimePurple", "slimeBlue", "slimeGreen", "mouse",
    "snail", "ladybug", "wormGreen", "wormPink",
)
PLAYER_THEME_COLORS = ("Beige", "Blue", "Green", "Pink", "Yellow")
GROUND_THEMES = ("Dirt", "Grass", "Planet", "Sand", "Snow", "Stone")

AGENT_RY = fm.f32(0.5787)
AGENT_Y0 = fm.f32(np.float32(1) + np.float32(0.5787))
MAX_SECTIONS = 5  # dif 3: randn(3) + 3 sections at most


def _is_wall(t):
    return (t == WALL_MID) | (t == WALL_TOP)


def _col3(v):
    """A per-env (N,) tensor against (N, 64, 64) grids; numbers pass."""
    return v[:, None, None] if isinstance(v, torch.Tensor) else v


class CoinRun(GameDef):
    name = "coinrun"
    visibility = 13.0
    mixrate = 0.2
    maxspeed = 0.5
    max_jump = MAX_JUMP
    out_of_bounds_object = WALL_MID
    background_group = "platform_backgrounds"
    world_w_max = 64
    world_h_max = 64
    agent_only_smart = False  # walking enemies are smart
    uses_entity_block = True
    uses_entity_push = True  # crate standing clamps via push_obj
    max_substeps = 8
    grid_theme_count = len(GROUND_THEMES)
    # worst case: ~40 enemies x 9-step trails + 30 crates + saws
    max_entities = 512
    max_smart_entities = 48  # agent + <= 40 walking enemies

    def __init__(self, cfg):
        self.easy = cfg.distribution_mode == DistributionMode.easy

    def use_block_asset(self, type_):
        # coinrun.cpp:183-185
        return type_ in (WALL_MID, WALL_TOP)

    def asset_map(self, cfg):
        # coinrun.cpp:74-124
        def players(stem):
            return [
                f"kenney/Players/128x256/{c}/alien{c}_{stem}.png"
                for c in PLAYER_THEME_COLORS
            ]

        return {
            O.PLAYER: players("stand"),
            PLAYER_JUMP: players("jump"),
            PLAYER_RIGHT1: players("walk1"),
            PLAYER_RIGHT2: players("walk2"),
            ENEMY1: [f"kenney/Enemies/{e}.png" for e in WALKING_ENEMIES],
            ENEMY2: [f"kenney/Enemies/{e}_move.png" for e in WALKING_ENEMIES],
            GOAL: ["kenney/Items/coinGold.png"],
            WALL_TOP: [f"kenney/Ground/{g}/{g.lower()}Mid.png" for g in GROUND_THEMES],
            WALL_MID: [f"kenney/Ground/{g}/{g.lower()}Center.png" for g in GROUND_THEMES],
            LAVA_TOP: ["kenney/Tiles/lavaTop_low.png"],
            LAVA_MID: ["kenney/Tiles/lava.png"],
            SAW: ["kenney/Enemies/sawHalf.png"],
            SAW2: ["kenney/Enemies/sawHalf_move.png"],
            CRATE: [
                "kenney/Tiles/boxCrate.png",
                "kenney/Tiles/boxCrate_double.png",
                "kenney/Tiles/boxCrate_single.png",
                "kenney/Tiles/boxCrate_warning.png",
            ],
            O.TRAIL: ["misc_assets/iconCircle_white.png"],
        }

    def image_rect_adjust(self, img_type):
        # players draw 128x256 sprites extending upward (coinrun.cpp:64-70)
        is_player = (
            (img_type == O.PLAYER) | (img_type == PLAYER_JUMP)
            | (img_type == PLAYER_RIGHT1) | (img_type == PLAYER_RIGHT2)
        )
        zero = torch.zeros(img_type.shape, dtype=F32, device=img_type.device)
        one = torch.ones_like(zero)
        oy = torch.where(is_player, fm.f32(-0.7415), 0.0)
        sh = torch.where(is_player, fm.f32(1.7415), 1.0)
        return zero, oy, one, sh

    def grid_themed_types(self):
        return (WALL_MID, WALL_TOP)

    def grid_theme_state(self, cfg, states):
        return states.extra["wall_theme"]

    def init_extra(self, cfg, num_envs, device):
        def full(v, dtype):
            return torch.full((num_envs,), v, dtype=dtype, device=device)

        return {
            "last_agent_y": full(0.0, F32),
            "wall_theme": full(0, I32),
            "has_support": full(False, torch.bool),
            "facing_right": full(True, torch.bool),
            "is_on_crate": full(False, torch.bool),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, 64)
        return state.replace(main_width=d, main_height=d)

    def is_blocked(self, cfg, state, src_type, target_type, is_horizontal):
        base = GameDef.is_blocked(self, cfg, state, src_type, target_type, is_horizontal)
        return base | ((src_type == O.PLAYER) & _is_wall(target_type))

    def will_reflect(self, cfg, state, src_type, target_type):
        # coinrun.cpp:143-145
        return (src_type == ENEMY) & (_is_wall(target_type) | (target_type == ENEMY_BARRIER))

    def is_blocked_ents_vals(self, cfg, state, src_type, tgt, is_horizontal):
        # crates standable from above only (coinrun.cpp:187-202); the
        # reference consults the *agent's* state whatever the mover
        ents = state.ents
        a = eo.AGENT

        def env(v):
            return v[:, None, None]

        crate_block = (
            env(ents.vy[:, a] < 0)
            & env(state.action_vy >= 0)
            & (env(state.extra["last_agent_y"]) >= tgt["y"] + tgt["ry"] + env(ents.ry[:, a]))
        )
        base = GameDef.is_blocked_ents_vals(self, cfg, state, src_type, tgt, is_horizontal)
        return torch.where(tgt["type"] == CRATE, ~is_horizontal & crate_block, base)

    def note_entity_blocks(self, cfg, state, idxs, blocked_mat, is_horizontal):
        # coinrun.cpp:187-202 sets is_on_crate inside is_blocked_ents, for
        # any mover whose vertical probe is blocked by a crate (the check
        # never tests the mover's type; the vertical gate is in
        # is_blocked_ents_vals)
        crate = state.ents.type[:, : blocked_mat.shape[-1]] == CRATE
        on_crate = (blocked_mat & crate[:, None, :]).flatten(1).any(1)
        extra = dict(state.extra)
        extra["is_on_crate"] = extra["is_on_crate"] | on_crate
        return state.replace(extra=extra)

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # coinrun.cpp:126-134
        t = state.ents.type
        dead = (mask & ((t == ENEMY) | (t == SAW))).any(1)
        return state.replace(done=state.done | dead)

    def handle_grid_collision(self, cfg, state, ent_idx, cell_type, cx, cy, valid):
        # coinrun.cpp:147-158
        is_player = state.ents.type[:, ent_idx] == O.PLAYER
        goal = valid & is_player & (cell_type == GOAL)
        lava = valid & is_player & ((cell_type == LAVA_MID) | (cell_type == LAVA_TOP))
        return state.replace(
            reward=state.reward + torch.where(goal, GOAL_REWARD, 0.0),
            done=state.done | goal | lava,
            level_complete=state.level_complete | goal,
        )

    def update_agent_velocity(self, cfg, state: EnvState) -> EnvState:
        # coinrun.cpp:160-177
        ents = state.ents
        a = eo.AGENT
        has_support = state.extra["has_support"]
        mixrate_x = torch.where(has_support, state.mixrate, state.mixrate * fm.f32(AIR_CONTROL))
        # "(1 - mixrate_x) * vx + mixrate_x * maxspeed * action_vx" with
        # separate f32 roundings (coinrun.cpp:158)
        vx = fm.fadd32(
            cfg, (1 - mixrate_x) * ents.vx[:, a],
            mixrate_x * state.maxspeed * state.action_vx,
        )
        vx = torch.where(torch.abs(vx) < mixrate_x * state.maxspeed, 0.0, vx)
        jumping = state.action_vy > 0
        vy = ents.vy[:, a]
        # "vy += .2 * action_vy": the double literal promotes the chain,
        # narrowed at the float store (coinrun.cpp:165)
        vy = torch.where(
            jumping, state.max_jump,
            torch.where(has_support, fm.dmuladd(cfg, state.action_vy, 0.2, vy), vy),
        )
        apply_g = ~(has_support & jumping)
        vy = torch.where(apply_g, vy - fm.f32(GRAVITY), vy)
        clipped = torch.minimum(torch.maximum(vy, -state.max_jump), state.max_jump)
        vy = torch.where(apply_g, clipped, vy)
        return state.replace(ents=eo.write_slot(ents, a, vx=vx, vy=vy))

    def entity_image_override(self, cfg, states):
        # agent animation (coinrun.cpp:215-227); enemies and saws animate in
        # game_step
        ents = states.ents
        has_support = states.extra["has_support"]
        standing = (
            (torch.abs(ents.vx[:, eo.AGENT]) < 0.01) & (states.action_vx == 0) & has_support
        )
        walk1 = (torch.div(states.cur_time, 5, rounding_mode="floor") % 2 == 0) | ~has_support
        agent_img = torch.where(
            standing, O.PLAYER, torch.where(walk1, PLAYER_RIGHT1, PLAYER_RIGHT2)
        ).to(I32)
        out = ents.image_type.clone()
        out[:, eo.AGENT] = agent_img
        return out

    def set_action_xy(self, cfg, state, move_action):
        # coinrun.cpp:448-473
        avx = (torch.div(move_action, 3, rounding_mode="floor") - 1).to(F32)
        avy = (move_action % 3 - 1).to(F32)
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
        has_support = (
            extra["is_on_crate"] | _is_wall(b1) | _is_wall(b2)
        ) & (ents.vy[:, a] == 0)
        extra["has_support"] = has_support
        extra["is_on_crate"] = torch.zeros_like(has_support)
        avy = torch.where((avy == 1) & ~has_support, 0.0, avy)
        return avx, avy, torch.zeros_like(avx), state.replace(extra=extra)

    # ---- level generation (coinrun.cpp:265-414) ----

    def _create_enemy(self, ents, rs, x, y, active):
        # coinrun.cpp:252-258; the enemy theme via choose_random_theme
        rs, vs = R.rs_randn(rs, 2, active=active)
        rs, th = R.rs_randn(rs, len(WALKING_ENEMIES), active=active)
        fields = eo.make_entity(
            x.to(F32) + 0.5, y.to(F32) + 0.5,
            fm.f32(0.15) * (vs * 2 - 1).to(F32), 0.0, 0.5, 0.5, ENEMY,
        )
        fields.update(smart_step=True, image_type=ENEMY1, render_z=1, image_theme=th)
        ents, _ = eo.append_entity(ents, fields, active=active)
        return ents, rs

    @staticmethod
    def _fill_block_top(grid, x, y, dx, dy, fill, top):
        grid = ph.fill_rect(grid, x, y, dx, dy - 1, fill)
        return ph.fill_rect(grid, x, y + dy - 1, dx, 1, top)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        b = torch.arange(N, device=dev)
        mw = mh = 64

        def zeros():
            return torch.zeros((N,), dtype=I32, device=dev)

        if self.easy:
            # fixed themes (coinrun.cpp:424-427); background_index forced 0
            agent_theme, wall_theme = zeros(), zeros()
            state = state.replace(background_index=zeros())
        else:
            rs, agent_theme = R.rs_randn(rs, len(PLAYER_THEME_COLORS))
            rs, wall_theme = R.rs_randn(rs, len(GROUND_THEMES))

        ents = eo.write_slot(
            state.ents, eo.AGENT, rx=0.5, ry=AGENT_RY, x=1.5, y=AGENT_Y0,
            image_theme=agent_theme,
        )
        extra = dict(state.extra)
        extra["last_agent_y"] = torch.full((N,), AGENT_Y0, dtype=F32, device=dev)
        extra["is_on_crate"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        extra["has_support"] = torch.zeros((N,), dtype=torch.bool, device=dev)
        extra["facing_right"] = torch.ones((N,), dtype=torch.bool, device=dev)
        extra["wall_theme"] = wall_theme

        grid = state.grid
        grid = ph.fill_rect(grid, 0, 0, mw, 1, WALL_TOP)
        grid = ph.fill_rect(grid, 0, 0, 1, mh, WALL_MID)
        grid = ph.fill_rect(grid, mw - 1, 0, 1, mh, WALL_MID)
        grid = ph.fill_rect(grid, 0, mh - 1, mw, 1, WALL_MID)

        # generate_coin_to_the_right (coinrun.cpp:265-414)
        rs, dr = R.rs_randn(rs, 3)
        dif = dr + 1
        dif3 = torch.div(dif, 3, rounding_mode="floor")
        rs, ns = R.rs_randn(rs, dif)
        num_sections = ns + dif
        curr_x = torch.full((N,), 5, dtype=I32, device=dev)
        curr_y = torch.full((N,), 1, dtype=I32, device=dev)
        pit_threshold = dif
        rs, danger_type = R.rs_randn(rs, 3)
        max_dy = int(MAX_JUMP * MAX_JUMP / (2 * GRAVITY) - 0.5)
        max_dx = int(0.5 * 2 * MAX_JUMP / GRAVITY - 0.5)

        for si in range(MAX_SECTIONS):
            on = (si < num_sections) & (curr_x + 15 < mw)

            rs, dyr = R.rs_randn(rs, 4, active=on)
            dy = torch.clamp(dyr + 1 + dif3, max=max_dy)
            high = curr_y >= 20
            mid = on & ~high & (curr_y >= 5)
            rs, flip_r = R.rs_randn(rs, 2, active=mid)
            dy = torch.where(high | (mid & (flip_r == 1)), -dy, dy)
            rs, dxr = R.rs_randn(rs, 2 * dif, active=on)
            dx = dxr + 3 + dif3
            curr_y = torch.where(on, torch.clamp(curr_y + dy, min=1), curr_y)

            # && short-circuits: the randn(20) is drawn only when the
            # geometric preconditions hold (coinrun.cpp:323)
            pit_geo = on & (dx > 7) & (curr_y > 3)
            rs, pit_r = R.rs_randn(rs, 20, active=pit_geo)
            use_pit = pit_geo & (pit_r >= pit_threshold)

            # --- pit branch (coinrun.cpp:324-369) ---
            rs, x1r = R.rs_randn(rs, 3, active=use_pit)
            x1 = x1r + 1
            rs, x2r = R.rs_randn(rs, 3, active=use_pit)
            x2 = x2r + 1
            pit_width = dx - x1 - x2
            x2 = torch.where(pit_width > max_dx, dx - x1 - max_dx, x2)
            pit_width = torch.clamp(pit_width, max=max_dx)

            g2 = self._fill_block_top(grid, curr_x, 0, x1, curr_y, WALL_MID, WALL_TOP)
            g2 = self._fill_block_top(g2, curr_x + dx - x2, 0, x2, curr_y, WALL_MID, WALL_TOP)
            rs, lh_r = R.rs_randn(rs, torch.clamp(curr_y - 3, min=1), active=use_pit)
            lava = self._fill_block_top(
                g2, curr_x + x1, 1, torch.where(use_pit, pit_width, 0), lh_r + 1,
                LAVA_MID, LAVA_TOP,
            )
            g2 = torch.where(_col3(danger_type == 0), lava, g2)
            for ei in range(max_dx):  # pit_width <= max_dx
                e_on = use_pit & (ei < pit_width)
                saw_on = e_on & (danger_type == 1)
                sfields = eo.make_entity(
                    (curr_x + x1 + ei).to(F32) + 0.5, 1.5, 0.0, 0.0, 0.5, 0.5, SAW
                )
                ents, _ = eo.append_entity(ents, sfields, active=saw_on)
                ents, rs = self._create_enemy(
                    ents, rs, curr_x + x1 + ei, torch.ones_like(curr_x),
                    e_on & (danger_type == 2),
                )

            wide = use_pit & (pit_width > 4)
            is5 = pit_width == 5
            is6 = pit_width == 6
            rs, a_r = R.rs_randn(rs, 2, active=wide)
            rs, b_r = R.rs_randn(rs, 2, active=wide)
            x3 = torch.where(is5, 1 + a_r, 2 + a_r)
            w1 = torch.where(is5 | is6, 1 + b_r, pit_width - x3 - (2 + b_r))
            g3 = self._fill_block_top(
                g2, curr_x + x1 + x3, curr_y - 1, w1, 1, WALL_MID, WALL_TOP
            )
            g2 = torch.where(_col3(wide), g3, g2)

            # --- platform branch (coinrun.cpp:370-400) ---
            g4 = self._fill_block_top(grid, curr_x, 0, dx, curr_y, WALL_MID, WALL_TOP)
            plat = on & ~use_pit
            span = torch.clamp(dx - 2, min=1)
            rs, saw_roll = R.rs_randn(rs, 10, active=plat)
            place_saw = plat & (saw_roll < 2 * dif) & (dx > 3)
            rs, ox1 = R.rs_randn(rs, span, active=place_saw)
            ob1_x = torch.where(place_saw, curr_x + ox1 + 1, -1)
            sfields = eo.make_entity(
                ob1_x.to(F32) + 0.5, curr_y.to(F32) + 0.5, 0.0, 0.0, 0.5, 0.5, SAW
            )
            ents, _ = eo.append_entity(ents, sfields, active=place_saw)

            rs, mon_roll = R.rs_randn(rs, 10, active=plat)
            place_mon = plat & (mon_roll < dif) & (dx > 3) & (max_dx >= 4) & (not self.easy)
            rs, ox2 = R.rs_randn(rs, span, active=place_mon)
            ob2_x = torch.where(place_mon, curr_x + ox2 + 1, -1)
            ents, rs = self._create_enemy(ents, rs, ob2_x, curr_y, place_mon)

            for _ci in range(2):
                rs, cxr = R.rs_randn(rs, span, active=plat)
                crate_x = curr_x + cxr + 1
                rs, c_roll = R.rs_randn(rs, 2, active=plat)
                place = plat & (c_roll == 1) & (ob1_x != crate_x) & (ob2_x != crate_x)
                rs, ph_r = R.rs_randn(rs, 3, active=place)
                for j in range(3):
                    c_on = place & (j < ph_r + 1)
                    rs, cth = R.rs_randn(rs, 4, active=c_on)
                    cfields = eo.make_entity(
                        crate_x.to(F32) + 0.5, (curr_y + j).to(F32) + 0.5,
                        0.0, 0.0, 0.5, 0.5, CRATE,
                    )
                    cfields["image_theme"] = cth
                    ents, _ = eo.append_entity(ents, cfields, active=c_on)

            grid = torch.where(_col3(use_pit), g2, torch.where(_col3(plat), g4, grid))

            # enemy barriers (coinrun.cpp:402-408)
            bx = torch.clamp(curr_x - 1, 0, 63).to(torch.int64)
            by = torch.clamp(curr_y, 0, 63).to(torch.int64)
            cell = grid[b, by, bx]
            grid[b, by, bx] = torch.where(on & ~_is_wall(cell), ENEMY_BARRIER, cell)
            curr_x = torch.where(on, curr_x + dx, curr_x)
            bx2 = torch.clamp(curr_x, 0, 63).to(torch.int64)
            grid[b, by, bx2] = torch.where(on, ENEMY_BARRIER, grid[b, by, bx2])

        # goal cell + final columns (coinrun.cpp:410-414)
        gx = torch.clamp(curr_x, 0, 63).to(torch.int64)
        gy = torch.clamp(curr_y, 0, 63).to(torch.int64)
        grid[b, gy, gx] = GOAL
        grid = self._fill_block_top(grid, curr_x, 0, 1, curr_y, WALL_MID, WALL_TOP)
        grid = ph.fill_rect(grid, curr_x + 1, 0, mw - curr_x - 1, mh, WALL_MID)

        return state.replace(ents=ents, grid=grid.to(I32), extra=extra), rs

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        ents = state.ents
        a = eo.AGENT

        refl = torch.where(
            state.action_vx > 0, False,
            torch.where(state.action_vx < 0, True, ents.is_reflected[:, a]),
        )
        ents = eo.write_slot(ents, a, is_reflected=refl)

        # enemy trails + animation, saw animation (coinrun.cpp:482-495); the
        # trails append in descending source-slot order
        is_enemy = ents.alive & (ents.type == ENEMY)
        tfields = eo.make_entity(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, O.TRAIL)
        tfields.update(
            x=ents.x, y=ents.y - ents.ry * 0.5, vx=0.0, vy=0.01, rx=0.3, ry=0.2,
            expire_time=8, alpha=0.5,
        )
        ents = eo.append_entities_masked(ents, tfields, is_enemy, descending=True)

        t = state.cur_time
        anim = torch.where(torch.div(t, 5, rounding_mode="floor") % 2 == 0, ENEMY1, ENEMY2)
        image_type = torch.where(is_enemy, anim.to(I32)[:, None], ents.image_type)
        is_saw = ents.alive & (ents.type == SAW)
        saw_anim = torch.where(t % 2 == 0, SAW, SAW2).to(I32)
        image_type = torch.where(is_saw, saw_anim[:, None], image_type)
        is_refl = torch.where(is_enemy, ents.vx > 0, ents.is_reflected)
        ents = ents.replace(image_type=image_type, is_reflected=is_refl)

        extra = dict(state.extra)
        extra["last_agent_y"] = ents.y[:, a]
        return state.replace(ents=ents, extra=extra)


register_game("coinrun")(CoinRun)
