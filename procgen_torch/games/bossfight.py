"""Bossfight: dodge the boss's attack patterns and shoot it while its
shields are down (reference games/bossfight.cpp); counterpart of
``procgen_tpu/games/bossfight.py``.

The boss roams between random waypoints; its shields rise and fall on a
clock, and each round of its health brings a new attack pattern (fans and
spirals of laser bullets, each leaving a trail).  The agent's bullets
reflect off the shields and damage the boss when they are down, in a
sequential sweep over the bullets; then each meteor barrier, descending,
destroys the bullets and trails it touches (the pair collisions of
``engine/base.py``).  Sprite sizes follow the PNG aspect ratios, read when
the game is built.
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
from procgen_torch.engine.base import GameDef, base_game_reset, base_game_step, descending_slots
from procgen_torch.games import register_game
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0

PLAYER_BULLET = 1
BOSS = 2
SHIELDS = 3
ENEMY_BULLET = 4
LASER_TRAIL = 5
REFLECTED_BULLET = 6
BARRIER = 7

BOSS_R = 3.0
NUM_ATTACK_MODES = 4
NUM_LASER_THEMES = 3
PLAYER_BULLET_VEL = 1.0
BOTTOM_MARGIN = 6.0
BOSS_VEL_TIMEOUT = 20
BOSS_DAMAGED_TIMEOUT = 40
MAX_ROUNDS = 5  # num_rounds = 1 + randn(5)
MAX_BULLETS = 8  # the most bullets one attack fires

BOSS_SLOT = 1  # the boss and its shields follow the agent and are never erased
SHIELDS_SLOT = 2

PI = float(np.float32(np.pi))  # the reference's `const float PI` (cpp-utils.h:12)

PLAYER_ASSETS = (
    "misc_assets/playerShip1_blue.png",
    "misc_assets/playerShip1_green.png",
    "misc_assets/playerShip2_orange.png",
    "misc_assets/playerShip3_red.png",
)
BOSS_ASSETS = (
    "misc_assets/enemyShipBlack1.png",
    "misc_assets/enemyShipBlue2.png",
    "misc_assets/enemyShipGreen3.png",
    "misc_assets/enemyShipRed4.png",
)
LASER_ASSETS = (
    "misc_assets/laserGreen14.png",
    "misc_assets/laserRed11.png",
    "misc_assets/laserBlue09.png",
)
BARRIER_ASSETS = tuple(f"misc_assets/spaceMeteors_00{i}.png" for i in range(1, 5)) + tuple(
    f"misc_assets/meteorGrey_big{i}.png" for i in range(1, 5))

BARRIER_SWEEP_SPAN = "procgen_torch.bossfight.barrier_sweep"


class Bossfight(GameDef):
    name = "bossfight"
    timeout = 4000  # bossfight.cpp:63
    world_w_max = 20
    world_h_max = 20
    mixrate = 0.5
    maxspeed = 0.85
    background_group = "space_backgrounds"
    uses_pair_collisions = True
    max_substeps = 8
    entity_rotations = "free"  # enemy bullets spin at pi/8 per step
    # ~25 live enemy bullets with 9-step trails, barriers and bullets
    max_entities = 256

    def __init__(self, cfg):
        easy = cfg.distribution_mode == DistributionMode.easy
        self.boss_bullet_vel = fm.f32(0.5 if easy else 0.75)
        self.max_extra_invulnerable = 1 if easy else 3
        # match_aspect_ratio uses each theme's sprite aspect (bag.cpp:1014-1023)
        self.player_aspects = [fm.f32(assets.aspect_ratio(n)) for n in PLAYER_ASSETS]
        self.boss_aspects = [fm.f32(assets.aspect_ratio(n)) for n in BOSS_ASSETS]
        self.barrier_aspects = [fm.f32(assets.aspect_ratio(n)) for n in BARRIER_ASSETS]

    def asset_map(self, cfg):
        # bossfight.cpp:76-108, and the explosion frames (bag.cpp:416-427)
        return {
            O.PLAYER: list(PLAYER_ASSETS),
            BOSS: list(BOSS_ASSETS),
            ENEMY_BULLET: list(LASER_ASSETS),
            PLAYER_BULLET: list(LASER_ASSETS),
            SHIELDS: ["misc_assets/shield2.png"],
            BARRIER: list(BARRIER_ASSETS),
            O.EXPLOSION: ["misc_assets/explosion1.png"],
            O.EXPLOSION + 1: ["misc_assets/explosion2.png"],
            O.EXPLOSION + 2: ["misc_assets/explosion3.png"],
            O.EXPLOSION + 3: ["misc_assets/explosion4.png"],
            O.EXPLOSION + 4: ["misc_assets/explosion5.png"],
        }

    def center_agent(self, cfg):
        return False  # bossfight.cpp:210

    def init_extra(self, cfg, num_envs, device):
        def z(*shape, dtype=I32):
            return torch.zeros((num_envs,) + shape, dtype=dtype, device=device)

        extra = {k: z() for k in (
            "last_fire_time", "time_to_swap", "invulnerable_duration", "num_rounds",
            "round_num", "curr_vel_timeout", "attack_mode", "player_laser_theme",
            "boss_laser_theme", "damaged_until_time")}
        extra.update(
            attack_modes=z(MAX_ROUNDS),
            round_health=torch.ones((num_envs,), dtype=I32, device=device),
            shields_are_up=z(dtype=torch.bool),
            barriers_moves_right=z(dtype=torch.bool),
            **{k: z(dtype=F32) for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y")},
        )
        return extra

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, 20)
        return state.replace(main_width=d, main_height=d)

    def entity_draw_mask(self, cfg, states):
        # should_draw_entity: the shields only while up (bossfight.cpp:122-127)
        up = states.extra["shields_are_up"][:, None]
        return torch.where(states.ents.type == SHIELDS, up, True)

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        t = state.ents.type
        deadly = mask & ((t == BOSS) | (t == BARRIER) | (t == ENEMY_BULLET))
        return state.replace(done=state.done | deadly.any(1))

    def _prepare_boss(self, extra, ents, which):
        """prepare_boss (bossfight.cpp:224-234) in the envs of ``which``:
        shields up, the velocity clock restarted, this round's attack."""
        extra = dict(extra)
        rnd = extra["round_num"] % torch.clamp(extra["num_rounds"], min=1)
        mode = torch.gather(extra["attack_modes"], 1, rnd.to(torch.int64)[:, None])[:, 0]
        for k, v in (("shields_are_up", True), ("curr_vel_timeout", BOSS_VEL_TIMEOUT),
                     ("time_to_swap", extra["invulnerable_duration"]), ("attack_mode", mode)):
            extra[k] = torch.where(which, v, extra[k])
        ents = eo.write_slot_masked(ents, BOSS_SLOT, which, vx=0.0, vy=0.0)
        return extra, ents

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        N = state.num_envs
        dev = state.done.device
        mw = mh = 20.0
        extra = dict(state.extra)

        def full(v, dtype=F32):
            return torch.full((N,), v, dtype=dtype, device=dev)

        # the boss and its shields (bossfight.cpp:212-218)
        rs, boss_theme = R.rs_randn(rs, len(BOSS_ASSETS))
        boss_ry = fm.fdiv(cfg, full(BOSS_R), fm.pick(boss_theme, self.boss_aspects))
        boss = eo.make_entity(mw / 2, mh / 2, 0.0, 0.0, BOSS_R, boss_ry, BOSS)
        boss["image_theme"] = boss_theme
        ents, _ = eo.append_entity(state.ents, boss)
        # "1.2 * boss->ry" promotes to double and narrows on the Entity
        # ctor's float parameter (bossfight.cpp:217)
        shields = eo.make_entity(mw / 2, mh / 2, 0.0, 0.0, 1.2 * BOSS_R,
                                 fm.dmul(cfg, boss_ry, 1.2), SHIELDS)
        ents, _ = eo.append_entity(ents, shields)

        rs, rh = R.rs_randn(rs, 9)
        round_health = rh + 1
        rs, nr = R.rs_randn(rs, 5)
        num_rounds = nr + 1
        rs, inv = R.rs_randn(rs, self.max_extra_invulnerable + 1)
        ents = eo.write_slot(ents, BOSS_SLOT, health=(round_health * num_rounds).to(F32))

        rs, agent_theme = R.rs_randn(rs, len(PLAYER_ASSETS))
        rs, player_laser = R.rs_randn(rs, NUM_LASER_THEMES)
        rs, boss_laser = R.rs_randn(rs, NUM_LASER_THEMES)
        modes = []
        for i in range(MAX_ROUNDS):
            rs, m = R.rs_randn(rs, NUM_ATTACK_MODES, active=i < num_rounds)
            modes.append(torch.where(i < num_rounds, m, 0))

        zero = full(0, I32)
        extra.update(
            attack_modes=torch.stack(modes, 1).to(I32), round_health=round_health,
            num_rounds=num_rounds, invulnerable_duration=inv + 2,
            player_laser_theme=player_laser, boss_laser_theme=boss_laser,
            round_num=zero, last_fire_time=zero, damaged_until_time=zero,
        )
        extra, ents = self._prepare_boss(extra, ents, full(True, torch.bool))

        # the agent's size and place (bossfight.cpp:242-246)
        arx = full(0.75)
        ary = fm.fdiv(cfg, arx, fm.pick(agent_theme, self.player_aspects))
        ents = eo.write_slot(ents, eo.AGENT, rx=arx, ry=ary, image_theme=agent_theme)
        state, rs = eo.reposition_agent(cfg, state.replace(ents=ents), rs)
        state = state.replace(ents=eo.write_slot(state.ents, eo.AGENT, y=ary))

        rs, moves_right = R.rs_randbool(rs)
        extra["barriers_moves_right"] = moves_right

        # spawn_barriers (bossfight.cpp:328-346)
        rs, nb = R.rs_randn(rs, 3)
        barrier_r = fm.f32(0.6)
        # "2 * ry + barrier_r + .5" and "(BOTTOM_MARGIN - min_y) -
        # barrier_r", left to right in float
        min_y = fm.seq(cfg, 2 * ary + barrier_r) + 0.5
        for i in range(3):
            active = i < nb + 1
            rs, uy = R.rs_rand01(rs, active=active)
            ent_y = fm.fmuladd32(cfg, uy, fm.seq(cfg, BOTTOM_MARGIN - min_y) - barrier_r, min_y)
            rs, ux = R.rs_rand01(rs, active=active)
            ent_x = fm.fmuladd32(cfg, ux, full(mw) - 2 * barrier_r, barrier_r)
            rs, th = R.rs_randn(rs, len(BARRIER_ASSETS), active=active)
            ry = fm.fdiv(cfg, full(barrier_r), fm.pick(th, self.barrier_aspects))
            barrier = eo.make_entity(ent_x, ent_y, 0.0, 0.0, barrier_r, ry, BARRIER)
            barrier.update(image_theme=th, health=3.0, collides_with_entities=True)
            clear = ~eo.has_any_collision_mask(state.ents, ent_x, ent_y, barrier_r, ry).any(1)
            ents, _ = eo.append_entity(state.ents, barrier, active=active & clear)
            state = state.replace(ents=ents)
        return state.replace(extra=extra), rs

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """bossfight.cpp:129-190, in two phases as the reference package
        runs them: first the agent's bullets, descending (a bullet reflects
        off raised shields or damages the boss; a round's end raises the
        shields for the bullets after it), over each env's bullets that
        touch the boss or the shields at the start; then each barrier,
        descending, over its targets, descending (the barriers are the
        lowest slots after the boss, so the reference's descending sweep
        reaches them after every bullet)."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        touch = pair_mask[:, :, BOSS_SLOT] | pair_mask[:, :, SHIELDS_SLOT]
        order, count, n_max = descending_slots(
            (t == PLAYER_BULLET) & ~ents.will_erase[:, :L] & touch)
        for k in range(n_max):
            state = self._bullet_hit(cfg, state, pair_mask, order[:, k], k < count)
        with telemetry.span(BARRIER_SWEEP_SPAN):
            return self._barrier_sweep(state, pair_mask)

    def _bullet_hit(self, cfg, state, pair_mask, i, on):
        """One bullet of the sweep (bossfight.cpp:135-172); ``i`` (N,) slots."""
        ents = state.ents
        extra = dict(state.extra)
        up = extra["shields_are_up"]
        on = on & (eo.at(ents.type, i) == PLAYER_BULLET) & ~eo.at(ents.will_erase, i)
        row = torch.gather(pair_mask, 1, i[:, None, None].expand(-1, 1, pair_mask.shape[2]))[:, 0]
        hit_shield = on & row[:, SHIELDS_SLOT] & up
        hit_boss = on & row[:, BOSS_SLOT] & ~up

        # the reflection (bossfight.cpp:135-147): "PI * (1.25 + .5 *
        # rand_pct)" and "VEL * sin(theta) * .5" are double chains narrowed
        # at the float stores
        theta = fm.narrow(fm.wide(cfg, torch.full_like(up, PI, dtype=F32))
                          * (1.25 + 0.5 * fm.wide(cfg, extra["rand_pct"])))
        s, c = fm.dsincos(cfg, theta)
        refl = dict(type=REFLECTED_BULLET, vy=fm.narrow(PLAYER_BULLET_VEL * s * 0.5),
                    vx=fm.narrow(PLAYER_BULLET_VEL * c * 0.5), expire_time=4, life_time=0,
                    alpha_decay=fm.f32(0.8))
        ents = ents.replace(**{f: eo.set_at(getattr(ents, f), i, v, hit_shield)
                               for f, v in refl.items()})

        # the boss's damage and the round's end (bossfight.cpp:148-164)
        health = ents.health[:, BOSS_SLOT] - torch.where(hit_boss, 1.0, 0.0)
        ents = eo.write_slot_masked(ents, BOSS_SLOT, hit_boss, health=health)
        tick = hit_boss & (health.to(I32) % torch.clamp(extra["round_health"], min=1) == 0)
        dead = tick & (health == 0)
        reward = state.reward + torch.where(tick, fm.f32(POSITIVE_REWARD), 0.0)
        reward = reward + torch.where(dead, fm.f32(COMPLETION_BONUS), 0.0)
        advance = tick & ~dead
        extra["round_num"] = extra["round_num"] + advance.to(I32)
        extra, ents = self._prepare_boss(extra, ents, advance)
        extra["curr_vel_timeout"] = torch.where(advance, BOSS_DAMAGED_TIMEOUT,
                                                extra["curr_vel_timeout"])
        extra["damaged_until_time"] = torch.where(
            advance, state.cur_time + BOSS_DAMAGED_TIMEOUT, extra["damaged_until_time"])

        # the spent bullet and its explosion (bossfight.cpp:166-172)
        ents = ents.replace(will_erase=eo.set_at(ents.will_erase, i, True, hit_boss))
        rx_i = eo.at(ents.rx, i)
        expl = eo.make_entity(eo.at(ents.x, i), eo.at(ents.y, i), ents.vx[:, BOSS_SLOT],
                              ents.vy[:, BOSS_SLOT], 0.5 * rx_i, 0.5 * rx_i, O.EXPLOSION)
        ents, _ = eo.append_entity(ents, expl, active=hit_boss)
        return state.replace(ents=ents, extra=extra, reward=reward, done=state.done | dead,
                             level_complete=state.level_complete | dead)

    def _barrier_sweep(self, state, pair_mask):
        """bossfight.cpp:173-190: each barrier, descending, erases the
        bullets and trails it touches and leaves an explosion on each
        bullet, appended in descending target order (the append order is
        part of the state).  Nothing lowers a barrier's health in
        bossfight, so its own erase branch never runs."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        target0 = pair_mask & ((t == ENEMY_BULLET) | (t == PLAYER_BULLET) | (t == LASER_TRAIL))[:, None, :]
        order, count, n_max = descending_slots(
            (t == BARRIER) & ~ents.will_erase[:, :L] & target0.any(2))
        for k in range(n_max):
            ents = state.ents
            i = order[:, k]
            on = (k < count) & ~eo.at(ents.will_erase, i)
            row = torch.gather(pair_mask, 1, i[:, None, None].expand(-1, 1, L))[:, 0]
            tk = ents.type[:, :L]
            valid = row & ~ents.will_erase[:, :L] & on[:, None]
            bullet = valid & ((tk == ENEMY_BULLET) | (tk == PLAYER_BULLET))
            erase = torch.zeros_like(ents.will_erase)
            erase[:, :L] = bullet | (valid & (tk == LASER_TRAIL))
            ents = ents.replace(will_erase=ents.will_erase | erase)
            expl = eo.make_entity(ents.x[:, :L], ents.y[:, :L], 0.0, 0.0, 0.5 * ents.rx[:, :L],
                                  0.5 * ents.rx[:, :L], O.EXPLOSION)
            state = state.replace(ents=eo.append_entities_masked(ents, expl, bullet))
        return state

    def _boss_fire_thetas(self, cfg, state):
        """The bullets of this step's attack (bossfight.cpp:265-305): which
        of 8 bullet slots fire, and their angles, each (N, 8)."""
        ex = state.extra
        ct = state.cur_time[:, None]
        mode = ex["attack_mode"][:, None]
        i = torch.arange(MAX_BULLETS, device=ct.device)[None, :]
        i_f = i.to(F32)
        rand_pct = ex["rand_pct"][:, None]
        # attack_mode_0 (:271-277): "PI * 1.5" promotes to double; "(i -
        # 2) * PI / 8" stays float; the sum narrows once at the theta
        a0 = (ct % 8 == 0) & (i < 5)
        th0 = fm.narrow(fm.wide(cfg, (i_f - 2) * PI / 8) + PI * 1.5)
        # attack_mode_1 (:279-287): "PI * (1.25 + .5 * k / 8.0)" is a
        # double chain, "i * PI / 2" float; one narrowing
        k1 = torch.abs(8 - torch.div(ct, 5, rounding_mode="floor") % 16)
        a1 = (ct % 5 == 0) & (i < 4)
        th1 = fm.narrow(PI * (1.25 + fm.wide(cfg, k1.to(F32)) / 16.0) + fm.wide(cfg, i_f * PI / 2))
        # attack_mode_2 (:289-299): "2 * PI / num_bullets * i + offset", a
        # float mul and add, rounded in turn
        a2 = (ct % 10 == 0) & (i < 8)
        th2 = fm.fmuladd32(cfg, i_f, fm.f32(2 * PI / 8), rand_pct * 2 * PI)
        # attack_mode_3 (:301-305), and the passive shot (:265-269)
        a3 = (ct % 4 == 0) & (i < 1)
        th3 = (PI * (1 + rand_pct)).expand(-1, MAX_BULLETS)
        ap = (ex["rand_fire_pct"][:, None] < fm.f32(0.1)) & (i < 1)

        def by_mode(v0, v1, v2, v3):
            return torch.where(mode == 0, v0, torch.where(mode == 1, v1, torch.where(mode == 2, v2, v3)))

        up = ex["shields_are_up"][:, None]
        damaged = ex["damaged_until_time"][:, None] >= ct
        active = ~damaged & torch.where(up, by_mode(a0, a1, a2, a3), ap)
        return active, torch.where(up, by_mode(th0, th1, th2, th3), th3)

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        extra = dict(state.extra)
        mw = mh = 20.0
        b = BOSS_SLOT
        ents = state.ents
        # the shields follow the boss (bossfight.cpp:352-353)
        ents = eo.write_slot(ents, SHIELDS_SLOT, x=ents.x[:, b], y=ents.y[:, b])

        mt = state.rng
        for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y"):
            mt, extra[k] = R.mt_rand01(mt)

        # the boss's waypoints and the shields' clock (bossfight.cpp:360-381)
        timeout_hit = extra["curr_vel_timeout"] <= 0
        dest_x = fm.fmuladd32(cfg, extra["rand_pct_x"], mw - 2 * BOSS_R, BOSS_R)
        dest_y = fm.fmuladd32(cfg, extra["rand_pct_y"], mh - 2 * BOSS_R - BOTTOM_MARGIN,
                              BOSS_R) + BOTTOM_MARGIN
        ents = eo.write_slot_masked(
            ents, b, timeout_hit,
            vx=fm.div_const(dest_x - ents.x[:, b], BOSS_VEL_TIMEOUT),
            vy=fm.div_const(dest_y - ents.y[:, b], BOSS_VEL_TIMEOUT))
        swap_now = timeout_hit & (extra["time_to_swap"] <= 0)
        up = extra["shields_are_up"]
        extra["time_to_swap"] = torch.where(
            swap_now, torch.where(up, 500, extra["invulnerable_duration"]),
            torch.where(timeout_hit, extra["time_to_swap"] - 1, extra["time_to_swap"]))
        extra["shields_are_up"] = up ^ swap_now
        extra["curr_vel_timeout"] = torch.where(timeout_hit, BOSS_VEL_TIMEOUT,
                                                extra["curr_vel_timeout"] - 1)

        # the agent's fire (bossfight.cpp:383-390)
        fire = (state.special_action == 1) & (state.cur_time - extra["last_fire_time"] >= 3)
        a = eo.AGENT
        bullet = eo.make_entity(ents.x[:, a], ents.y[:, a], 0.0, PLAYER_BULLET_VEL, 0.25, 0.25,
                                PLAYER_BULLET)
        bullet.update(image_theme=extra["player_laser_theme"], collides_with_entities=True,
                      expire_time=25)
        ents, _ = eo.append_entity(ents, bullet, active=fire)
        extra["last_fire_time"] = torch.where(fire, state.cur_time, extra["last_fire_time"])
        state = state.replace(ents=ents, extra=extra, rng=mt)

        # the boss's attack (bossfight.cpp:392-398): up to 8 bullets in
        # order; "vel * cos(theta)" is a double chain narrowed once
        # (bossfight.cpp:259)
        active, theta = self._boss_fire_thetas(cfg, state)
        s, c = fm.dsincos(cfg, theta)
        vel = fm.wide(cfg, torch.full_like(theta, self.boss_bullet_vel))
        shots = eo.make_entity(ents.x[:, b:b + 1], ents.y[:, b:b + 1], fm.narrow(vel * c),
                               fm.narrow(vel * s), 0.5, 0.5, ENEMY_BULLET)
        shots.update(image_theme=extra["boss_laser_theme"][:, None], expire_time=50,
                     vrot=fm.f32(PI / 8))
        ents = eo.append_entities_masked(ents, _expand(shots, MAX_BULLETS), active,
                                         descending=False)

        # the damaged boss's explosions (bossfight.cpp:307-313): "boss->x +
        # (2 * rand_pct_x - 1) * boss->rx", rounded in turn
        spawn_expl = (extra["damaged_until_time"] >= state.cur_time) & (state.cur_time % 3 == 0)
        pos_x = fm.fmuladd32(cfg, 2 * extra["rand_pct_x"] - 1, ents.rx[:, b], ents.x[:, b])
        pos_y = fm.fmuladd32(cfg, 2 * extra["rand_pct_y"] - 1, ents.ry[:, b], ents.y[:, b])
        expl = eo.make_entity(pos_x, pos_y, 0.0, 0.0, 0.75, 0.75, O.EXPLOSION)
        ents, _ = eo.append_entity(ents, expl, active=spawn_expl)

        # a laser trail behind every live enemy bullet, in reverse slot
        # order (bossfight.cpp:419-431)
        is_eb = ents.alive & (ents.type == ENEMY_BULLET)
        trail = eo.make_entity(ents.x, ents.y, ents.vx * 0.5, ents.vy * 0.5, ents.rx, ents.ry,
                               LASER_TRAIL)
        trail.update(alpha_decay=fm.f32(0.7), image_type=ENEMY_BULLET,
                     image_theme=extra["boss_laser_theme"][:, None].expand_as(ents.type),
                     vrot=ents.vrot, rotation=ents.rotation, expire_time=8)
        ents = eo.append_entities_masked(ents, trail, is_eb)
        return state.replace(ents=ents)

    def serialize_extra(self, w, s, i):
        # bossfight.cpp:437-462
        nr = int(s["extra.num_rounds"][i])
        w.write_vector_int(s["extra.attack_modes"][i][:nr])
        w.write_int(s["extra.last_fire_time"][i])
        w.write_int(s["extra.time_to_swap"][i])
        w.write_int(s["extra.invulnerable_duration"][i])
        w.write_int(500)  # vulnerable_duration
        w.write_int(nr)
        w.write_int(s["extra.round_num"][i])
        w.write_int(s["extra.round_health"][i])
        w.write_int(BOSS_VEL_TIMEOUT)
        for k in ("curr_vel_timeout", "attack_mode", "player_laser_theme", "boss_laser_theme",
                  "damaged_until_time"):
            w.write_int(s[f"extra.{k}"][i])
        w.write_bool(s["extra.shields_are_up"][i])
        w.write_bool(s["extra.barriers_moves_right"][i])
        w.write_float(0.1)  # base_fire_prob
        w.write_float(self.boss_bullet_vel)
        w.write_float(0.1)  # barrier_vel
        w.write_float(0.025)  # barrier_spawn_prob
        for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y"):
            w.write_float(s[f"extra.{k}"][i])

    def deserialize_extra(self, r):
        modes = r.read_vector_int()
        out = {"attack_modes": modes + [0] * (MAX_ROUNDS - len(modes))}
        for k in ("last_fire_time", "time_to_swap", "invulnerable_duration"):
            out[k] = r.read_int()
        r.read_int()  # vulnerable_duration
        for k in ("num_rounds", "round_num", "round_health"):
            out[k] = r.read_int()
        r.read_int()  # boss_vel_timeout
        for k in ("curr_vel_timeout", "attack_mode", "player_laser_theme", "boss_laser_theme",
                  "damaged_until_time"):
            out[k] = r.read_int()
        out["shields_are_up"] = r.read_bool()
        out["barriers_moves_right"] = r.read_bool()
        for _ in range(4):
            r.read_float()  # base_fire_prob, boss_bullet_vel, barrier_vel, barrier_spawn_prob
        for k in ("rand_pct", "rand_fire_pct", "rand_pct_x", "rand_pct_y"):
            out[k] = r.read_float()
        return out


def _expand(fields: dict, k: int) -> dict:
    """Candidate fields of ``k`` sources: tensors with a trailing source axis
    of 1 broadcast to k; numbers stay numbers."""
    return {n: v.expand(-1, k) if torch.is_tensor(v) and v.dim() == 2 else v
            for n, v in fields.items()}


register_game("bossfight")(Bossfight)
