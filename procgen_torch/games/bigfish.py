"""BigFish: eat smaller fish, grow, avoid bigger ones (reference
games/bigfish.cpp); counterpart of ``procgen_tpu/games/bigfish.py``.

Fish spawn from the per-step stream at either side of a water world; each
takes one of three themes, and its ``ry`` is its radius over that theme's
sprite aspect ratio (match_aspect_ratio, read from the PNG headers when the
game is built).  The agent's collisions are a sequential sweep: eating
grows the agent, which changes the outcome for lower slots.
"""

from __future__ import annotations

import torch

from procgen_torch import fmath as fm
from procgen_torch import objects as O
from procgen_torch import rng as R
from procgen_torch import telemetry
from procgen_torch.config import DistributionMode
from procgen_torch.engine import entity_ops as eo
from procgen_torch.engine.base import (
    AGENT_SWEEP_SPAN,
    GameDef,
    base_game_reset,
    base_game_step,
)
from procgen_torch.games import register_game
from procgen_torch.render import assets
from procgen_torch.state import F32, I32, EnvState

COMPLETION_BONUS = 10.0
POSITIVE_REWARD = 1.0
FISH = 2
FISH_MIN_R = fm.f32(0.25)
FISH_MAX_R = fm.f32(2.0)
FISH_QUOTA = 30


class BigFish(GameDef):
    name = "bigfish"
    timeout = 6000  # bigfish.cpp:25
    max_entities = 48  # unbounded in the reference; ~5-13 concurrent in practice
    world_w_max = 20
    world_h_max = 20
    background_group = "water_backgrounds"  # bigfish.cpp:31-33

    FISH_ASSETS = (
        "misc_assets/fishTile_074.png",
        "misc_assets/fishTile_078.png",
        "misc_assets/fishTile_080.png",
    )

    def __init__(self, cfg):
        self.start_r = 1.0 if cfg.distribution_mode == DistributionMode.easy else 0.5
        # match_aspect_ratio uses the per-theme sprite aspect (bag.cpp:1014-1023)
        self.fish_aspects = [fm.f32(assets.aspect_ratio(n)) for n in self.FISH_ASSETS]

    def asset_map(self, cfg):
        # bigfish.cpp:35-43
        return {
            O.PLAYER: ["misc_assets/fishTile_072.png"],
            FISH: list(self.FISH_ASSETS),
        }

    def center_agent(self, cfg):
        return False  # bigfish.cpp:64

    def init_extra(self, cfg, num_envs, device):
        return {
            "fish_eaten": torch.zeros((num_envs,), dtype=I32, device=device),
            "r_inc": torch.zeros((num_envs,), dtype=F32, device=device),
        }

    def choose_world_dim(self, cfg, state: EnvState) -> EnvState:
        # set in the ctor in the reference (bigfish.cpp:27-28)
        d = torch.full_like(state.main_width, 20)
        return state.replace(main_width=d, main_height=d)

    def game_reset(self, cfg, state: EnvState, rs):
        state, rs = base_game_reset(self, cfg, state, rs)
        start_r = fm.f32(self.start_r)
        r_inc = fm.f32((FISH_MAX_R - start_r) / FISH_QUOTA)
        ents = eo.write_slot(state.ents, eo.AGENT, rx=start_r, ry=start_r, y=fm.f32(1 + start_r))
        extra = dict(state.extra)
        extra["fish_eaten"] = torch.zeros_like(extra["fish_eaten"])
        extra["r_inc"] = torch.full_like(extra["r_inc"], r_inc)
        return state.replace(ents=ents, extra=extra), rs

    def agent_collision_phase(self, cfg, state: EnvState) -> EnvState:
        with telemetry.span(AGENT_SWEEP_SPAN):
            return self._agent_sweep(cfg, state)

    def _agent_sweep(self, cfg, state: EnvState) -> EnvState:
        """Reverse-order dispatch (bigfish.cpp:45-59): eating grows the agent
        mid-sweep, which can change the collision and size outcomes of lower
        slots, so the sweep stays sequential, one batched step per slot.  It
        runs over the slots below the batch's largest live count, read once
        (live slots are a prefix of the table; a dead slot is never hit)."""
        ents = state.ents
        a = eo.AGENT
        telemetry.count("host_reads.bigfish.sweep_width")
        L = int(ents.alive.sum(1).max())
        rx, ry = ents.rx.clone(), ents.ry.clone()
        will_erase = ents.will_erase.clone()
        reward, done = state.reward, state.done
        eaten = state.extra["fish_eaten"]
        r_inc = state.extra["r_inc"]
        for i in range(L - 1, a, -1):
            is_fish = (ents.type[:, i] == FISH) & ents.alive[:, i]
            coll = (
                torch.abs(ents.x[:, i] - ents.x[:, a])
                < rx[:, i] + rx[:, a] + ents.collision_margin[:, i]
            ) & (
                torch.abs(ents.y[:, i] - ents.y[:, a])
                < ry[:, i] + ry[:, a] + ents.collision_margin[:, i]
            )
            hit = is_fish & coll
            bigger = rx[:, i] > rx[:, a]
            done = done | (hit & bigger)
            eat = hit & ~bigger
            reward = reward + torch.where(eat, fm.f32(POSITIVE_REWARD), 0.0)
            will_erase[:, i] |= eat
            grow = torch.where(eat, r_inc, 0.0)
            rx[:, a] = rx[:, a] + grow
            ry[:, a] = ry[:, a] + grow
            eaten = eaten + eat.to(I32)
        extra = dict(state.extra)
        extra["fish_eaten"] = eaten
        return state.replace(
            ents=ents.replace(rx=rx, ry=ry, will_erase=will_erase),
            extra=extra, reward=reward, done=done,
        )

    def game_step(self, cfg, state: EnvState) -> EnvState:
        state = base_game_step(self, cfg, state)

        # fish spawner (bigfish.cpp:83-94); every draw gated on the 1/10 roll
        mt, roll = R.mt_randn(state.rng, 10)
        spawn = roll == 1
        mt, u_r = R.mt_rand01(mt, active=spawn)
        # "(FISH_MAX_R - FISH_MIN_R) * pow(rand01(), 1.4) + FISH_MIN_R": pow
        # is the double overload, so the chain is double, narrowed once at
        # the assignment (bigfish.cpp:84), in both modes (a float pow would
        # not give the same bits on the card and the CPU)
        ent_r = fm.narrow(
            (FISH_MAX_R - FISH_MIN_R) * torch.pow(u_r.to(torch.float64), 1.4) + FISH_MIN_R
        )
        mt, u_y = R.mt_rand01(mt, active=spawn)
        ent_y = u_y * (state.main_height.to(F32) - 2 * ent_r)
        mt, u_right = R.mt_rand01(mt, active=spawn)
        moves_right = u_right < 0.5
        mt, u_v = R.mt_rand01(mt, active=spawn)
        sign = torch.where(moves_right, 1.0, -1.0)
        # "(.15 + rand01() * .25) * (+-1)": double literals promote; one
        # narrowing at the assignment (bigfish.cpp:87)
        if cfg.parity_mode:
            ent_vx = ((0.15 + u_v.to(torch.float64) * 0.25) * sign.to(torch.float64)).to(F32)
        else:
            ent_vx = (fm.f32(0.15) + u_v * fm.f32(0.25)) * sign
        ent_x = torch.where(moves_right, -ent_r, state.main_width.to(F32) + ent_r)
        fields = eo.make_entity(ent_x, ent_y, ent_vx, 0.0, ent_r, ent_r, FISH)
        # choose_random_theme (bag.cpp:1038-1041): randn(3 themes)
        mt, theme = R.mt_randn(mt, len(self.FISH_ASSETS), active=spawn)
        fields["image_theme"] = theme
        # match_aspect_ratio (bag.cpp:1014-1023): ry = rx / aspect(theme)
        fields["ry"] = fm.fdiv(cfg, ent_r, fm.pick(theme, self.fish_aspects))
        fields["is_reflected"] = ~moves_right
        ents, _ = eo.append_entity(state.ents, fields, active=spawn)
        state = state.replace(rng=mt, ents=ents)

        # quota completion (bigfish.cpp:96-100)
        full = state.extra["fish_eaten"] >= FISH_QUOTA
        state = state.replace(
            done=state.done | full,
            reward=state.reward + torch.where(full, fm.f32(COMPLETION_BONUS), 0.0),
            level_complete=state.level_complete | full,
        )

        # facing (bigfish.cpp:102-105)
        refl = torch.where(
            state.action_vx > 0, False,
            torch.where(state.action_vx < 0, True, state.ents.is_reflected[:, eo.AGENT]),
        )
        return state.replace(ents=eo.write_slot(state.ents, eo.AGENT, is_reflected=refl))

    def serialize_extra(self, w, s, i):
        # bigfish.cpp:108-112
        w.write_int(s["extra.fish_eaten"][i])
        w.write_float(s["extra.r_inc"][i])

    def deserialize_extra(self, r):
        return {"fish_eaten": r.read_int(), "r_inc": r.read_float()}


register_game("bigfish")(BigFish)
