"""User-facing gym3-style environment (counterpart of ``procgen_tpu/env.py``).

``ProcgenTorchEnv`` mirrors the surface of the reference's
``ProcgenGym3Env`` (env.py:203-246 + gym3.libenv.CEnv semantics):
``observe()`` -> (rew, {"rgb": obs}, first), ``act(actions)``,
``get_info()``.  Underneath it is a thin stateful shell over batched
functions (``reset_fn`` / ``step_fn`` / ``render_fn``) with the inline
auto-reset: a finished env's next level is generated in the same step.
High-throughput loops use the level queue instead
(procgen_torch/parallel/fast.py).

Construction-time seeding follows vecgame.cpp:301-314: a master MT19937
seeded with ``rand_seed`` deals one full-width randint per env to seed that
env's level_seed_rand_gen.  The env runs on ``device`` ("cuda" unless the
caller asks for the CPU).
"""

from __future__ import annotations

import random as _pyrandom
from typing import Optional

import numpy as np
import torch

from procgen_torch import resolve_device
from procgen_torch import rng as R
from procgen_torch.config import DistributionMode, EnvConfig
from procgen_torch.engine.game import reset_env, step_env
from procgen_torch.games import make_game
from procgen_torch.render.fast2 import render_frames2, render_static2
from procgen_torch.render.pack import RenderPack
from procgen_torch.render.renderer import update_view_params
from procgen_torch.state import EnvState, init_state_template

DISTRIBUTION_MODE_NAMES = {
    "easy": DistributionMode.easy,
    "hard": DistributionMode.hard,
    "extreme": DistributionMode.extreme,
    "memory": DistributionMode.memory,
    "exploration": DistributionMode.exploration,
}

_NO_STATE = (
    "procgen_torch: get_state/set_state are not ported yet (ROADMAP A9, "
    "the reference-layout state codec)"
)


def create_random_seed() -> int:
    """env.py:54-63 (without the MPI rank offset)."""
    return _pyrandom.SystemRandom().randint(0, 2**31 - 1)


class ProcgenTorchEnv:
    """Batched procgen env on one device (one game per instance)."""

    def __init__(
        self,
        num: int,
        env_name: str = "coinrun",
        *,
        rand_seed: Optional[int] = None,
        num_levels: int = 0,
        start_level: int = 0,
        distribution_mode: str | DistributionMode = "hard",
        paint_vel_info: bool = False,
        use_generated_assets: bool = False,
        use_monochrome_assets: bool = False,
        restrict_themes: bool = False,
        use_backgrounds: bool = True,
        center_agent: bool = True,  # reference env.py:211
        use_sequential_levels: bool = False,
        num_threads: int = 4,  # accepted for API parity; no thread pool here
        render: bool = True,
        render_mode: Optional[str] = None,
        parity_mode: bool = False,
        device="cuda",
        _level_rng_seeds: Optional[list[int]] = None,
    ):
        if render_mode in ("rgb_array", "human"):
            raise NotImplementedError(
                "procgen_torch: render_mode needs the 512x512 gather renderer "
                "(render_env), which is not ported yet (ROADMAP A11)"
            )
        if isinstance(distribution_mode, str):
            distribution_mode = DISTRIBUTION_MODE_NAMES[distribution_mode]
        if rand_seed is None:
            rand_seed = create_random_seed()
        self.device = resolve_device(device)
        self.cfg = cfg = EnvConfig(
            env_name=env_name,
            num_envs=num,
            num_levels=num_levels,
            start_level=start_level,
            rand_seed=rand_seed,
            distribution_mode=distribution_mode,
            paint_vel_info=paint_vel_info,
            use_generated_assets=use_generated_assets,
            use_monochrome_assets=use_monochrome_assets,
            restrict_themes=restrict_themes,
            use_backgrounds=use_backgrounds,
            center_agent=center_agent,
            use_sequential_levels=use_sequential_levels,
            parity_mode=parity_mode,
        ).resolve_exploration()
        self.num = num
        self.gd = make_game(cfg)
        self.pack = RenderPack(self.gd, cfg)
        self._do_render = render
        self._level_rng_seeds = _level_rng_seeds
        self.state = self.reset_fn(self._initial_state(rand_seed))
        self._obs = self.render_fn(self.state) if render else None

    # ------------------------------------------------------------------
    # batched functions
    # ------------------------------------------------------------------

    def _initial_state(self, rand_seed: int) -> EnvState:
        state = init_state_template(self.gd, self.cfg, self.num, self.device)
        if self._level_rng_seeds is not None:
            # joint mode: the master RNG deals across the interleaved batch
            # (vecgame.cpp:309-314); ProcgenJointEnv passes each game its
            # own slots' draws
            seeds = list(self._level_rng_seeds)
            assert len(seeds) == self.num
        else:
            master = R.HostMT(rand_seed)
            seeds = [master.randint_full() for _ in range(self.num)]
        seeds = torch.tensor(seeds, dtype=torch.int32).to(self.device)
        return state.replace(level_seed_rng=R.mt_seed(seeds))

    def _refresh_static(self, states: EnvState, force: bool = False) -> EnvState:
        """The per-level static layer, recomputed only when some env started
        a level, and written only for those envs."""
        if not force and not bool(states.done.any()):
            return states
        new = render_static2(self.gd, self.cfg, states, self.pack)
        if not force:
            new = torch.where(states.done[:, None, None, None], new, states.static_layer)
        return states.replace(static_layer=new)

    def reset_fn(self, state: EnvState) -> EnvState:
        """Batched reset (level generation for every env)."""
        state = update_view_params(self.gd, self.cfg, reset_env(self.gd, self.cfg, state))
        return self._refresh_static(state, force=True)

    def step_fn(self, state: EnvState, actions) -> EnvState:
        """Batched step with the inline masked auto-reset."""
        if not isinstance(actions, torch.Tensor):
            actions = torch.as_tensor(np.asarray(actions, np.int32))
        actions = actions.to(device=self.device, dtype=torch.int32)
        state = update_view_params(
            self.gd, self.cfg, step_env(self.gd, self.cfg, state, actions)
        )
        return self._refresh_static(state)

    def render_fn(self, state: EnvState) -> torch.Tensor:
        """(N, 64, 64, 3) uint8 frames on the env's device."""
        return render_frames2(self.gd, self.cfg, state, self.pack)

    # ------------------------------------------------------------------
    # gym3-style stateful API (reference env.py / gym3.libenv.CEnv)
    # ------------------------------------------------------------------

    def observe(self):
        rew = self.state.reward.cpu().numpy()
        first = self.state.done.cpu().numpy()
        if self._obs is None and self._do_render:
            self._obs = self.render_fn(self.state)
        ob = {"rgb": self._obs.cpu().numpy()} if self._do_render else {}
        return rew, ob, first

    def act(self, ac) -> None:
        self.state = self.step_fn(self.state, ac)
        self._obs = self.render_fn(self.state) if self._do_render else None

    def get_info(self):
        prev_seed = self.state.prev_level_seed.cpu().numpy()
        prev_complete = self.state.level_complete.cpu().numpy()
        seed = self.state.current_level_seed.cpu().numpy()
        return [
            {
                "prev_level_seed": int(prev_seed[i]),
                "prev_level_complete": int(prev_complete[i]),
                "level_seed": int(seed[i]),
            }
            for i in range(self.num)
        ]

    def get_state(self):
        raise NotImplementedError(_NO_STATE)

    def set_state(self, blobs) -> None:
        raise NotImplementedError(_NO_STATE)

    def callmethod(self, method: str, *args):
        raise NotImplementedError(_NO_STATE)

    @property
    def ob_space(self):
        return {"rgb": ("uint8", (64, 64, 3))}

    @property
    def ac_space(self):
        return ("discrete", 15)

    def get_combos(self):
        """The 15 action combos (reference env.py:156-172)."""
        return [
            ("LEFT", "DOWN"), ("LEFT",), ("LEFT", "UP"), ("DOWN",), (),
            ("UP",), ("RIGHT", "DOWN"), ("RIGHT",), ("RIGHT", "UP"),
            ("D",), ("A",), ("W",), ("S",), ("Q",), ("E",),
        ]

    def keys_to_act(self, keys_list):
        """Longest-match combo resolution (reference env.py:174-195)."""
        result = []
        for keys in keys_list:
            action = None
            max_len = -1
            for i, combo in enumerate(self.get_combos()):
                pressed = all(k in keys for k in combo)
                if pressed and max_len < len(combo):
                    action = i
                    max_len = len(combo)
            result.append(None if action is None else np.asarray([action], np.int32))
        return result


class ProcgenJointEnv:
    """Joint multi-game env: a comma-separated ``env_name`` runs game
    ``i % num_games`` in env slot ``i`` (vecgame.cpp:295-330; requires
    ``num % num_games == 0``).  Each game is its own ``ProcgenTorchEnv``;
    the public surface interleaves them back into reference env order."""

    def __init__(self, num: int, env_name: str, *, rand_seed: Optional[int] = None, **kwargs):
        names = env_name.split(",")
        if num % len(names) != 0:
            raise ValueError(
                f"num ({num}) must be divisible by the number of games "
                f"({len(names)})"  # vecgame.cpp:299
            )
        if rand_seed is None:
            rand_seed = create_random_seed()
        self.num = num
        self.names = names
        k = len(names)
        # one master RNG deals per-env level seeds across the interleaved
        # batch (vecgame.cpp:301-314): env n runs game n % k and gets the
        # n-th draw; sub-env j owns slots j, j+k, j+2k, ...
        master = R.HostMT(rand_seed)
        all_seeds = [master.randint_full() for _ in range(num)]
        self.envs = [
            ProcgenTorchEnv(
                num=num // k, env_name=n, rand_seed=rand_seed,
                _level_rng_seeds=all_seeds[j::k], **kwargs
            )
            for j, n in enumerate(names)
        ]

    def _gather(self, pieces):
        """Interleave per-game arrays back to env order i = slot * k + game."""
        out = np.empty((self.num,) + pieces[0].shape[1:], pieces[0].dtype)
        k = len(self.envs)
        for j, arr in enumerate(pieces):
            out[j::k] = arr
        return out

    def observe(self):
        rews, obs, firsts = zip(*(e.observe() for e in self.envs))
        ob = {"rgb": self._gather([o["rgb"] for o in obs])} if obs[0] else {}
        return self._gather(list(rews)), ob, self._gather(list(firsts))

    def act(self, ac) -> None:
        ac = np.asarray(ac)
        k = len(self.envs)
        for j, e in enumerate(self.envs):
            e.act(ac[j::k])

    def get_info(self):
        k = len(self.envs)
        out = [None] * self.num
        for j, e in enumerate(self.envs):
            for s, info in enumerate(e.get_info()):
                out[s * k + j] = info
        return out

    def get_state(self):
        raise NotImplementedError(_NO_STATE)

    def set_state(self, blobs) -> None:
        raise NotImplementedError(_NO_STATE)

    def callmethod(self, method: str, *args):
        raise NotImplementedError(_NO_STATE)

    @property
    def ob_space(self):
        return self.envs[0].ob_space

    @property
    def ac_space(self):
        return self.envs[0].ac_space


def make_procgen_env(num: int, env_name: str = "coinrun", **kwargs):
    """Factory handling the joint comma-list form of ``env_name``."""
    if "," in env_name:
        return ProcgenJointEnv(num, env_name, **kwargs)
    return ProcgenTorchEnv(num, env_name, **kwargs)
