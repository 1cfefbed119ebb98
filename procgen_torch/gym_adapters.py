"""Gym/gym3-style adapters (counterpart of ``procgen_tpu/gym_adapters.py``;
reference: procgen/env.py:249-265, procgen/gym_registration.py).

``ProcgenTorchEnv`` already speaks the gym3 surface (observe/act/get_info/
callmethod).  This module adds:

* ``ProcgenVecEnv``, a baselines VecEnv-style wrapper
  (reset/step_async/step_wait), and ``ProcgenEnv``, its constructor;
* ``ProcgenGymEnv``, the single-env classic Gym adapter (reset/step
  returning (obs, rew, done, info));
* ``make_env``, mirroring gym_registration.make_env, and
  ``register_environments`` (``procgen-torch-<name>-v0``).

Every constructor passes its keyword arguments to ``ProcgenTorchEnv``: the
env runs on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from procgen_torch.env import ProcgenTorchEnv


class ProcgenVecEnv:
    """baselines VecEnv-flavored wrapper (reference ToBaselinesVecEnv)."""

    def __init__(self, venv: ProcgenTorchEnv):
        self.venv = venv
        self.num_envs = venv.num
        self._actions = None

    @property
    def observation_space(self):
        return {"rgb": ("uint8", (64, 64, 3))}

    @property
    def action_space(self):
        return ("discrete", 15)

    def reset(self):
        _, ob, _ = self.venv.observe()
        return ob

    def step_async(self, actions):
        self._actions = actions

    def step_wait(self):
        self.venv.act(self._actions)
        rew, ob, first = self.venv.observe()
        infos = self.venv.get_info()
        return ob, rew, first.astype(bool), infos

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def render(self, mode="rgb_array"):
        _, ob, _ = self.venv.observe()
        return ob["rgb"][0]

    def callmethod(self, method, *args):
        return self.venv.callmethod(method, *args)


def ProcgenEnv(num_envs: int, env_name: str, **kwargs) -> ProcgenVecEnv:
    """Reference-compatible constructor (env.py:264-265)."""
    return ProcgenVecEnv(ProcgenTorchEnv(num=num_envs, env_name=env_name, **kwargs))


class ProcgenGymEnv:
    """Classic single-env Gym interface (gym_registration.py semantics)."""

    metadata = {"render.modes": ["rgb_array"], "video.frames_per_second": 15}

    def __init__(self, env_name: str, **kwargs):
        self.venv = ProcgenTorchEnv(num=1, env_name=env_name, **kwargs)
        self._last_obs = None

    def reset(self):
        # envs auto-reset; gym3's ToGymEnv returns the current observation
        _, ob, _ = self.venv.observe()
        self._last_obs = ob["rgb"][0]
        return self._last_obs

    def step(self, action):
        self.venv.act(np.asarray([action], np.int32))
        rew, ob, first = self.venv.observe()
        self._last_obs = ob["rgb"][0]
        info = self.venv.get_info()[0]
        return self._last_obs, float(rew[0]), bool(first[0]), info

    def render(self, mode="rgb_array"):
        return self._last_obs

    @property
    def action_space_n(self) -> int:
        return 15


def make_env(env_name: str = "coinrun", render_mode: Optional[str] = None, **kwargs):
    """gym_registration.py:6-26 equivalent."""
    return ProcgenGymEnv(env_name=env_name, **kwargs)


def register_environments() -> None:
    """gym_registration.py:29-35: register ``procgen-torch-<name>-v0`` for
    every game with the classic Gym registry (a no-op without gym)."""
    try:
        from gym.envs.registration import register, registry
    except Exception:  # gym is optional
        return
    from procgen_torch.games import available_games

    for name in available_games():
        env_id = f"procgen-torch-{name}-v0"
        try:
            if hasattr(registry, "env_specs") and env_id in registry.env_specs:
                continue
            register(
                id=env_id,
                entry_point="procgen_torch.gym_adapters:make_env",
                kwargs={"env_name": name},
            )
        except Exception:
            pass
