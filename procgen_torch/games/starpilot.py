"""StarPilot: a side-scrolling shooter driven by a spawner timeline rolled at
reset (reference games/starpilot.cpp); counterpart of
``procgen_tpu/games/starpilot.py``.

Level generation rolls the whole level's timeline of spawners (flyers in
groups, meteors, clouds, turrets) on the reset stream and sorts it by
spawn time, descending: a stable sort on the fast path, libstdc++'s
introsort tie order (``utils/cppsort.py``, on the host) in parity mode.
Each step releases the spawners whose time has come, enemies fire at the
agent (their bullets face their velocity, ``fmath.face_rotation``), the
agent's bullets damage the highest destructible slot they hit (the pair
collisions of ``engine/base.py``), and the space background scrolls
(``dynamic_bg_rect``, drawn by ``render/fast2.dynamic_bg_pass``).
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
from procgen_torch.engine.rand_util import first_true
from procgen_torch.games import register_game
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState
from procgen_torch.utils.serialize import read_entity_fields, write_entity_defaults

V_SCALE = fm.f32(2.0 / 5.0)
BG_RATIO = 18.0
ENEMY_REWARD = 1.0
COMPLETION_BONUS = 10.0

BULLET_PLAYER = 1
BULLET2 = 2
BULLET3 = 3
FLYER = 4
METEOR = 5
CLOUD = 6
TURRET = 7
FAST_FLYER = 8
FINISH_LINE = 9

SHOOTER_WIN_TIME = 500
NUM_BASIC_OBJECTS = 9
NUM_SHIP_THEMES = 7
PI = float(np.float32(np.pi))  # the reference's `const float PI` (cpp-utils.h:12)

MAX_SPAWNERS = 320  # the state's spawner table
# the timeline: t advances >= 10 per group up to 500, groups of <= 5
MAX_GROUPS = 51
GROUP_SLOTS = 5

SPAWNER_FIELDS = (
    "x", "y", "vx", "vy", "rx", "ry", "type", "image_theme", "render_z",
    "fire_time", "spawn_time", "health", "rotation",
)
_INT_FIELDS = ("type", "image_theme", "render_z", "fire_time", "spawn_time")

TURRET_ASSETS = ("misc_assets/spaceStation_018.png", "misc_assets/spaceStation_019.png")
FINISH_ASSETS = tuple(f"misc_assets/spaceRockets_00{i}.png" for i in range(1, 5))

SPAWNERS_SPAN = "procgen_torch.starpilot.spawners"


def _is_destructible(t):
    return (t == FLYER) | (t == FAST_FLYER) | (t == TURRET) | (t == METEOR)


def _walk_appends(ents, blocks):
    """The appends of a loop over the table's slots in descending order in
    which each slot may push back one child of each of ``blocks`` ((fields,
    mask) pairs over the E slots), in list order: one masked append over
    the E x len(blocks) candidates, slot-major.  The children land in dead
    slots, so no walked slot changes."""
    N, E = ents.alive.shape

    def weave(cols):  # [(N, E)] -> (N, E * len(cols)): slot E-1's first
        return torch.stack(cols, 2).flip(1).reshape(N, -1)

    fields = {}
    for name in blocks[0][0]:
        arr = getattr(ents, name)
        fields[name] = weave([
            f[name].to(arr.dtype).expand(N, E) if isinstance(f[name], torch.Tensor)
            else torch.full((N, E), f[name], dtype=arr.dtype, device=arr.device)
            for f, _ in blocks])
    return eo.append_entities_masked(ents, fields, weave([m for _, m in blocks]),
                                     descending=False)


def _is_lethal(t):
    return _is_destructible(t) | (t == BULLET2) | (t == BULLET3)


def _is_flyer(t):
    return (t == FLYER) | (t == FAST_FLYER)


class StarPilot(GameDef):
    name = "starpilot"
    world_w_max = 16
    world_h_max = 16
    background_group = "space_backgrounds"
    uses_pair_collisions = True
    entity_rotations = "free"
    max_substeps = 8
    max_entities = 128
    # the most a reset draws: the background's and the agent's draws and the
    # timeline's first time (8 covers them), then per group its type, size,
    # theme, row and step, and up to five spawners of at most four draws (an
    # easy timeline, all flyer groups, can pass 512)
    reset_max_draws = 8 + MAX_GROUPS * (5 + 4 * GROUP_SLOTS)

    def __init__(self, cfg):
        mode = cfg.distribution_mode
        # init_hps (starpilot.cpp:147-224): per-type tables, by mode
        f = np.float32
        hp_vs = np.ones(NUM_BASIC_OBJECTS, f)
        hp_healths = np.zeros(NUM_BASIC_OBJECTS, f)
        hp_weight = np.ones(NUM_BASIC_OBJECTS, f)
        hp_object_r = np.full(NUM_BASIC_OBJECTS, 0.5, f)
        bullet_r = 1 / 2.5
        if mode == DistributionMode.easy:
            hp_weight[[METEOR, CLOUD, TURRET, FAST_FLYER]] = 0
            hp_vs[FLYER], hp_vs[BULLET2] = 0.75, 1.25
            hp_healths[TURRET], hp_healths[FLYER], hp_healths[FAST_FLYER] = 5, 2, 1
            self.maxspeed = 0.75
        elif mode == DistributionMode.hard:
            hp_vs[BULLET2] = 2
            hp_healths[TURRET], hp_healths[FLYER], hp_healths[FAST_FLYER] = 5, 2, 1
            self.maxspeed = 0.75
        elif mode == DistributionMode.extreme:
            hp_vs[BULLET2] = 2
            hp_healths[TURRET], hp_healths[FLYER], hp_healths[FAST_FLYER] = 10, 5, 2
            self.maxspeed = 0.5
            bullet_r = 1 / 5
        else:
            raise ValueError(f"starpilot does not support mode {mode}")
        hp_healths[METEOR] = 500
        hp_vs[FAST_FLYER] = 1.5
        hp_vs[BULLET_PLAYER] = hp_vs[BULLET3] = 2
        hp_object_r[[TURRET, METEOR, CLOUD]] = 2
        hp_weight[FLYER] = 3
        hp_weight[[BULLET_PLAYER, BULLET2, BULLET3]] = 0
        self.hp_vs = [float(v) for v in hp_vs]
        self.hp_healths = [float(v) for v in hp_healths]
        self.hp_object_r = [float(v) for v in hp_object_r]
        self.bullet_r = fm.f32(bullet_r)  # hp_bullet_r: one value for every type
        self.total_prob_weight = fm.f32(hp_weight[2:].sum())
        self.cum_weights = [float(v) for v in np.cumsum(hp_weight[2:])]
        self.hp_slow_v = fm.f32(0.5)
        self.can_spawn_left = mode != DistributionMode.easy
        self.turret_aspects = [fm.f32(assets.aspect_ratio(n)) for n in TURRET_ASSETS]
        self.finish_aspects = [fm.f32(assets.aspect_ratio(n)) for n in FINISH_ASSETS]

    def asset_map(self, cfg):
        # starpilot.cpp:61-107, and the explosion frames (bag.cpp:416-427)
        ships = [f"misc_assets/spaceShips_00{i}.png" for i in range(1, 8)]
        return {
            O.PLAYER: ["misc_assets/playerShip2_blue.png"],
            BULLET_PLAYER: ["misc_assets/towerDefense_tile295.png"],
            BULLET2: ["misc_assets/towerDefense_tile296.png"],
            BULLET3: ["misc_assets/towerDefense_tile297.png"],
            FLYER: ships,
            FAST_FLYER: ships,
            METEOR: [f"misc_assets/spaceMeteors_00{i}.png" for i in range(1, 5)]
            + [f"misc_assets/meteorGrey_big{i}.png" for i in range(1, 5)],
            CLOUD: [f"misc_assets/spaceEffect{i}.png" for i in range(1, 10)],
            TURRET: list(TURRET_ASSETS),
            FINISH_LINE: list(FINISH_ASSETS),
            O.EXPLOSION: ["misc_assets/explosion1.png"],
            O.EXPLOSION + 1: ["misc_assets/explosion2.png"],
            O.EXPLOSION + 2: ["misc_assets/explosion3.png"],
            O.EXPLOSION + 3: ["misc_assets/explosion4.png"],
            O.EXPLOSION + 4: ["misc_assets/explosion5.png"],
        }

    def center_agent(self, cfg):
        return False  # starpilot.cpp:333

    def dynamic_bg_rect(self, cfg, states):
        """The scrolling tile (starpilot.cpp:110-127): a 3x-high background
        repeated 18 times along x, moving left with the time; "-t * scale *
        hp_slow_v * 2 / char_dim", each op rounded in turn (the division
        tensor by tensor)."""
        scale, bg_k = 64.0 / 16.0, 3.0
        t = states.cur_time.to(F32)
        x0 = -t * scale * self.hp_slow_v * 2 / states.char_dim
        h = 64.0 * bg_k
        w = h * BG_RATIO
        n_tiles = int(w / h)  # tile_image with ratio 1: square tiles

        def c(v):
            return torch.full_like(x0, v)

        return x0, c(w / n_tiles), c(w), c(-64.0 * (bg_k - 1) / 2), c(h)

    def init_extra(self, cfg, num_envs, device):
        extra = {
            f"sp_{f}": torch.zeros((num_envs, MAX_SPAWNERS), device=device,
                                   dtype=I32 if f in _INT_FIELDS else F32)
            for f in SPAWNER_FIELDS
        }
        extra["sp_count"] = torch.zeros((num_envs,), dtype=I32, device=device)
        return extra

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        d = torch.full_like(state.main_width, 16)
        return state.replace(main_width=d, main_height=d)

    def handle_agent_collision(self, cfg, state: EnvState, mask) -> EnvState:
        # starpilot.cpp:129-139
        t = state.ents.type
        finish = (mask & (t == FINISH_LINE)).any(1)
        dead = (mask & _is_lethal(t)).any(1)
        return state.replace(
            done=state.done | finish | dead,
            reward=state.reward + torch.where(finish, fm.f32(COMPLETION_BONUS), 0.0),
            level_complete=state.level_complete | finish,
        )

    def handle_collision_pairs(self, cfg, state: EnvState, pair_mask) -> EnvState:
        """starpilot.cpp:141-148: each player bullet, in descending slot
        order, damages the highest destructible slot (not a cloud) it
        touches and is spent, leaving an explosion.  The loop runs over each
        env's bullets that touch such a slot at the start (will_erase only
        grows)."""
        L = pair_mask.shape[1]
        ents = state.ents
        t = ents.type[:, :L]
        target0 = pair_mask & (_is_destructible(t) & (t != CLOUD))[:, None, :]
        cand = (t == BULLET_PLAYER) & ~ents.will_erase[:, :L] & target0.any(2)
        order, count, n_max = descending_slots(cand)
        idx = torch.arange(L, device=t.device)
        for k in range(n_max):
            ents = state.ents
            i = order[:, k]
            on = (k < count) & ~eo.at(ents.will_erase, i)
            row = torch.gather(target0, 1, i[:, None, None].expand(-1, 1, L))[:, 0]
            j = torch.where(row & ~ents.will_erase[:, :L] & on[:, None], idx, -1).amax(1)
            hit = j >= 0
            jc = j.clamp(min=0)
            ents = ents.replace(
                will_erase=eo.set_at(ents.will_erase, i, True, hit),
                health=eo.set_at(ents.health, jc, eo.at(ents.health, jc) - 1.0, hit),
            )
            rx_i = eo.at(ents.rx, i)
            expl = eo.make_entity(eo.at(ents.x, i), eo.at(ents.y, i), eo.at(ents.vx, jc),
                                  eo.at(ents.vy, jc), 0.5 * rx_i, 0.5 * rx_i, O.EXPLOSION)
            ents, _ = eo.append_entity(ents, expl, active=hit)
            state = state.replace(ents=ents)
        return state

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        with torch.profiler.record_function(SPAWNERS_SPAN):
            extra, rs = self._spawners(cfg, state, rs)
        rs, agent_theme = R.rs_randn(rs, 1)  # choose_random_theme (one theme)
        ents = eo.write_slot(state.ents, eo.AGENT, rotation=fm.f32(PI / 2),
                             image_theme=agent_theme)
        return state.replace(ents=ents, extra=extra), rs

    def _spawners(self, cfg, state, rs):
        """add_spawners (starpilot.cpp:226-327): the timeline, groups of up
        to five spawners at times t + 5 j, then the sort by spawn time.
        The loop runs group by group, each env's draws gated by its own
        timeline: a group's draws after its type are gated by masks known
        from that type, so they are taken in two masked runs
        (``rng.blk_raw_masked``); the arithmetic on the draws runs once,
        over every group, after the loop.  The loop stops once every env's
        time has passed SHOOTER_WIN_TIME, read on the host at each group
        (the remaining groups draw nothing and add nothing)."""
        N = state.num_envs
        dev = state.done.device
        rs, t0 = R.rs_randint(rs, 10, 30)
        t = 1 + t0
        j = torch.arange(GROUP_SLOTS, device=dev)[None, :]
        groups = []
        for _ in range(MAX_GROUPS):
            on = t <= SHOOTER_WIN_TIME
            if not bool(on.any()):
                break
            rs, u_w = R.rs_rand01(rs, active=on)
            start_weight = u_w * self.total_prob_weight
            picked = first_true(torch.stack([start_weight - w <= 0 for w in self.cum_weights], 1))
            typ = torch.clamp(picked + 2, max=NUM_BASIC_OBJECTS - 1).to(I32)
            flyer = _is_flyer(typ)
            # a flyer group's size and theme, then rand_pos's row draw (a
            # 16-high world never leaves r <= 2 a tight box)
            rs, raw = R.blk_raw_masked(rs, torch.stack([on & flyer, on & flyer, on], 1))
            r = fm.pick(typ, self.hp_object_r)
            group_size = torch.where(flyer, R.randint_value(raw[:, 0], 0, 5) + 1, 1)
            jon = on[:, None] & (j < group_size[:, None])
            tc = typ[:, None]
            # each spawner's draws, in order: fire time, angle, straight,
            # turret fire time, flyer side, cloud / meteor / turret theme;
            # then the timeline's step
            gates = torch.stack([
                jon, jon, jon, jon & (tc == TURRET), jon & flyer[:, None], jon & (tc == CLOUD),
                jon & (tc == METEOR), jon & (tc == TURRET)], 2).reshape(N, 8 * GROUP_SLOTS)
            rs, d = R.blk_raw_masked(rs, torch.cat([gates, on[:, None]], 1))
            t_next = t + torch.where(on, R.randint_value(d[:, -1], 10, 30), 0)
            d = d[:, :-1].reshape(N, GROUP_SLOTS, 8)

            def col(v):
                return v[:, None].expand(N, GROUP_SLOTS)

            groups.append(dict(
                typ=col(typ), r=col(r), fth=col(R.randn_value(raw[:, 1], NUM_SHIP_THEMES)),
                yp=col((16.0 - 2 * r) * R.rand01_value(raw[:, 2]) + r + 0.0), jon=jon,
                spawn_time=t[:, None] + j * 5,
                ft=R.randint_value(d[..., 0], 10, 100), u_th=R.rand01_value(d[..., 1]),
                z=R.randint_value(d[..., 2], 0, 2), tft=R.randint_value(d[..., 3], 20, 30),
                u_sr=R.rand01_value(d[..., 4]), th_c=R.randn_value(d[..., 5], 9),
                th_m=R.randn_value(d[..., 6], 8), th_t=R.randn_value(d[..., 7], 2)))
            t = t_next
        g = {k: torch.cat([grp[k] for grp in groups], 1) for k in groups[0]}
        return self._spawner_table(cfg, state, g), rs

    def _spawner_table(self, cfg, state, g):
        """The spawners of the drawn timeline ``g`` ((N, C) per draw and
        per group value), sorted by spawn time, descending, into the
        state's table (starpilot.cpp:253-327, 340)."""
        typ, r, jon = g["typ"], g["r"], g["jon"]
        flyer = _is_flyer(typ)
        slow = (typ == METEOR) | (typ == CLOUD)
        still = slow | (typ == TURRET)
        # "(rand01() - .5) * k": the .5 literal promotes, one narrowing into
        # the float theta (starpilot.cpp:263)
        theta = fm.narrow((fm.wide(cfg, g["u_th"]) - 0.5) * fm.f32(2 * PI / 4))
        theta = torch.where((g["z"] == 1) | still, 0.0, theta)
        v_scale = torch.where(still, self.hp_slow_v, fm.pick(typ, self.hp_vs)) * V_SCALE
        # cos/sin are the C double functions: double chains narrowed at the
        # float stores (starpilot.cpp:284-285)
        s, c = fm.dsincos(cfg, theta)
        vx = fm.narrow(-1.0 * c * fm.wide(cfg, v_scale))
        vy = fm.narrow(s * fm.wide(cfg, v_scale))
        spawn_left = jon & flyer & (g["u_sr"] > fm.f32(0.9)) & self.can_spawn_left
        vx = torch.where(spawn_left, -vx, vx)
        th_t = g["th_t"]
        vals = dict(
            x=torch.where(spawn_left, -r, 16.0 + r), y=g["yp"], vx=vx, vy=vy, rx=r,
            ry=torch.where(typ == TURRET, fm.fdiv(cfg, r, fm.pick(th_t, self.turret_aspects)), r),
            type=typ,
            image_theme=torch.where(typ == CLOUD, g["th_c"], torch.where(
                typ == METEOR, g["th_m"], torch.where(typ == TURRET, th_t, g["fth"]))),
            render_z=(jon & (typ == CLOUD)).to(I32),
            fire_time=torch.where(typ == TURRET, g["tft"], torch.where(slow, -1, g["ft"])),
            spawn_time=g["spawn_time"], health=fm.pick(typ, self.hp_healths),
            rotation=torch.where(flyer, torch.where(vx > 0, -1.0, 1.0) * fm.f32(PI / 2), 0.0),
        )
        C = jon.shape[1]
        count = jon.sum(1).to(I32)
        key = torch.where(jon, g["spawn_time"], -1)
        if cfg.parity_mode:
            order = _cpp_sort_order(key, jon)
        else:
            # std::sort by spawn time, descending; the stable order is the
            # one the reference package's fast path and the oracle
            # (std::stable_sort) keep
            order = torch.sort(-key, dim=1, stable=True).indices
        keep = torch.arange(C, device=key.device)[None, :] < count[:, None]
        extra = dict(state.extra)
        for f in SPAWNER_FIELDS:
            v = torch.gather(vals[f].to(I32 if f in _INT_FIELDS else F32), 1, order)
            v = torch.where(keep, v, torch.zeros_like(v))
            extra[f"sp_{f}"] = torch.nn.functional.pad(v, (0, MAX_SPAWNERS - C))
        extra["sp_count"] = count
        return extra

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)
        ents = state.ents
        extra = dict(state.extra)
        a = eo.AGENT

        # enemy fire and deaths (starpilot.cpp:369-394): one walk over the
        # slots in descending order, each enemy's shot appended before its
        # death explosion (every slot at once, see _walk_appends)
        t = ents.type
        ft = ents.fire_time
        dt_sp = state.cur_time[:, None] - ents.spawn_time
        fire = ents.alive & (t != O.PLAYER) & (ft > 0) & torch.where(
            t == TURRET, dt_sp % torch.clamp(ft, min=1) == 0, dt_sp == ft)
        b_vx = ents.x[:, a:a + 1] - ents.x
        b_vy = ents.y[:, a:a + 1] - ents.y
        btype = torch.where(t == TURRET, BULLET3, BULLET2)
        # "hp_vs[type] * V_SCALE / sqrt(b_vx * b_vx + b_vy * b_vy)": the
        # float numerator over the double sqrt, narrowed at the float store
        # (starpilot.cpp:383); a zero norm gives inf, as in the reference
        num = torch.where(t == TURRET, fm.f32(self.hp_vs[BULLET3] * V_SCALE),
                          fm.f32(self.hp_vs[BULLET2] * V_SCALE))
        bvs = fm.narrow(fm.wide(cfg, num) / fm.dsqrt(cfg, fm.fadd32(cfg, b_vx * b_vx, b_vy * b_vy)))
        bvx, bvy = b_vx * bvs, b_vy * bvs
        # face_direction(vx, vy, -PI / 2) of the scaled components
        # (starpilot.cpp:384-389); standing still keeps the ctor's 0
        brot = torch.where((bvx != 0) | (bvy != 0), fm.face_rotation(bvx, bvy, -PI / 2), 0.0)
        bullets = eo.make_entity(ents.x, ents.y, bvx, bvy, self.bullet_r, self.bullet_r, BULLET2)
        bullets.update(type=btype, image_type=btype, rotation=brot)

        dead = (ents.alive & (ents.health <= 0) & _is_destructible(t)
                & ~ents.will_erase & (t != O.PLAYER))
        expl = eo.make_entity(ents.x, ents.y, ents.vx, ents.vy, 0.5 * ents.rx, 0.5 * ents.rx,
                              O.EXPLOSION)
        ents = _walk_appends(ents.replace(will_erase=ents.will_erase | dead),
                             ((bullets, fire), (expl, dead)))
        reward = state.reward + dead.sum(1).to(F32) * fm.f32(ENEMY_REWARD)

        # release the spawners whose time has come (starpilot.cpp:396-399):
        # the reference pops them off the back of the descending list, so
        # the highest index goes first and the list shrinks
        slot = torch.arange(MAX_SPAWNERS, device=t.device)
        release = (slot[None, :] < extra["sp_count"][:, None]) & (
            extra["sp_spawn_time"] <= state.cur_time[:, None])
        extra["sp_count"] = extra["sp_count"] - release.sum(1).to(I32)
        spawned = eo.make_entity(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, FLYER)
        spawned.update({f: extra[f"sp_{f}"] for f in SPAWNER_FIELDS})
        spawned["image_type"] = extra["sp_type"]
        ents = eo.append_entities_masked(ents, spawned, release)

        # the player's bullet (starpilot.cpp:401-416)
        firing = state.special_action != 0
        theta = torch.where(state.special_action == 2, PI, 0.0)
        v_scale = fm.f32(self.hp_vs[BULLET_PLAYER] * V_SCALE)
        s, c = fm.dsincos(cfg, theta)
        vx = fm.narrow(c * v_scale)
        vy = fm.narrow(s * v_scale)
        x_off = fm.narrow(fm.wide(cfg, ents.rx[:, a]) * c)
        pb = eo.make_entity(ents.x[:, a] + x_off, ents.y[:, a], vx, vy, self.bullet_r,
                            self.bullet_r, BULLET_PLAYER)
        # face_direction(vx, vy), then "rotation -= PI / 2" (starpilot.cpp:417-418)
        pb.update(collides_with_entities=True, rotation=fm.face_rotation(vx, vy) - fm.f32(PI / 2))
        ents, _ = eo.append_entity(ents, pb, active=firing)

        # the finish line at t = 500 (starpilot.cpp:418-424)
        at_end = state.cur_time == SHOOTER_WIN_TIME
        mt, fin_theme = R.mt_randn(state.rng, 4, active=at_end)
        fin_ry = 8.0
        fin_rx = fin_ry * fm.pick(fin_theme, self.finish_aspects)  # match width = false
        fin = eo.make_entity(16.0 + fin_rx, 8.0, -self.hp_slow_v * V_SCALE, 0.0, fin_rx, fin_ry,
                             FINISH_LINE)
        fin["image_theme"] = fin_theme
        ents, _ = eo.append_entity(ents, fin, active=at_end)
        return state.replace(ents=ents, rng=mt, extra=extra, reward=reward)

    def serialize_extra(self, w, s, i):
        # starpilot.cpp:427-435: the spawner list serializes as entities
        n = int(s["extra.sp_count"][i])
        w.write_int(n)
        for k in range(n):
            vals = {f: s[f"extra.sp_{f}"][i][k] for f in SPAWNER_FIELDS}
            vals["image_type"] = vals["type"]
            write_entity_defaults(w, vals)

    def deserialize_extra(self, r):
        n = r.read_int()
        out = {
            f"sp_{f}": np.zeros((MAX_SPAWNERS,), np.int32 if f in _INT_FIELDS else np.float32)
            for f in SPAWNER_FIELDS
        }
        for k in range(n):
            vals = read_entity_fields(r)
            for f in SPAWNER_FIELDS:
                out[f"sp_{f}"][k] = vals[f]
        out["sp_count"] = n
        return out


def _cpp_sort_order(key: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Parity mode: each env's live candidates in libstdc++ std::sort's
    order by spawn time, descending (ties as the reference binary leaves
    them), then the others; on the host."""
    from procgen_torch.utils.cppsort import std_sort_perm

    keys, live = key.cpu().numpy(), on.cpu().numpy()
    C = keys.shape[1]
    out = np.empty(keys.shape, np.int64)
    for b in range(keys.shape[0]):
        act = np.nonzero(live[b])[0]
        perm = std_sort_perm([int(v) for v in keys[b][act]], lambda x, y: x > y)
        out[b] = np.concatenate([act[perm], np.setdiff1d(np.arange(C), act)])
    return torch.as_tensor(out).to(key.device)


register_game("starpilot")(StarPilot)
