"""Environment configuration.

Mirrors the three config tiers of the reference (Python kwargs -> libenv
options -> GameOptions struct; reference: procgen/env.py:110-124,
procgen/src/game.h:45-60, procgen/src/game.cpp:42-75) as a single frozen
dataclass.  All fields are plain Python values: they select code paths and
shapes, they never live on the device.
"""

from __future__ import annotations

import dataclasses
import enum

INT32_MAX = 2**31 - 1

# FNV-1a, used for per-game fixed_asset_seed (vecgame.cpp:156-167).
def fnv1a_hash_str_uint32(s: str) -> int:
    h = 0x811C9DC5
    for ch in s.encode():
        h = (h ^ ch) * 0x01000193 & 0xFFFFFFFF
    return h


class DistributionMode(enum.IntEnum):
    """game.h:32-37; string names per env.py:45-51."""

    easy = 0
    hard = 1
    extreme = 2
    memory = 10
    exploration = 20  # resolved to hard + fixed level before reaching the game


# Validation matrix from game.cpp:56-66.
EXTREME_GAMES = {"chaser", "dodgeball", "leaper", "starpilot"}
MEMORY_GAMES = {"caveflyer", "dodgeball", "heist", "jumper", "maze", "miner"}

# env.py:33-42
EXPLORATION_LEVEL_SEEDS = {
    "coinrun": 1949448038,
    "caveflyer": 1259048185,
    "leaper": 1318677581,
    "jumper": 1434825276,
    "maze": 158988835,
    "heist": 876640971,
    "climber": 1561126160,
    "ninja": 1123500215,
}


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static options for one batch of same-game envs.

    Field semantics match the reference option list (README "Environment
    Options"; game.h:45-60).  ``num_envs`` and ``env_name`` live here because
    the compiled program shape depends on them.
    """

    env_name: str = "coinrun"
    num_envs: int = 1
    num_levels: int = 0
    start_level: int = 0
    rand_seed: int = 0
    paint_vel_info: bool = False
    use_generated_assets: bool = False
    use_monochrome_assets: bool = False
    restrict_themes: bool = False
    use_backgrounds: bool = True
    center_agent: bool = True  # env.py:211 default
    use_sequential_levels: bool = False
    distribution_mode: DistributionMode = DistributionMode.hard
    debug_mode: int = 0
    # parity_mode: emulate the reference's float64 intermediate arithmetic at
    # double-rounding-sensitive sites (procgen_torch.fmath).  Off for the
    # fast path.
    parity_mode: bool = False

    def __post_init__(self):
        mode = self.distribution_mode
        name = self.env_name
        if mode == DistributionMode.extreme and name not in EXTREME_GAMES:
            raise ValueError(f"{name} does not support extreme mode")
        if mode == DistributionMode.memory and name not in MEMORY_GAMES:
            raise ValueError(f"{name} does not support memory mode")
        if mode == DistributionMode.exploration:
            if name not in EXPLORATION_LEVEL_SEEDS:
                raise ValueError(f"{name} does not support exploration mode")

    def resolve_exploration(self) -> "EnvConfig":
        """env.py:224-233: exploration = hard + a single fixed level."""
        if self.distribution_mode != DistributionMode.exploration:
            return self
        return dataclasses.replace(
            self,
            distribution_mode=DistributionMode.hard,
            num_levels=1,
            start_level=EXPLORATION_LEVEL_SEEDS[self.env_name],
        )

    @property
    def effective_fixed_asset_seed(self) -> int:
        """Per-game generated-asset seed: FNV-1a of the game name
        (vecgame.cpp:156-167, 322-327; the fixed_asset_seed option defaults
        to 0 which triggers the hash)."""
        return fnv1a_hash_str_uint32(self.env_name)

    @property
    def level_seed_low(self) -> int:
        # vecgame.cpp:176-183
        return 0 if self.num_levels == 0 else self.start_level

    @property
    def level_seed_high(self) -> int:
        return (
            INT32_MAX
            if self.num_levels == 0
            else self.start_level + self.num_levels
        )

    @property
    def fixed_asset_seed(self) -> int:
        # vecgame.cpp:324-327: int(FNV-1a(name)); reference allows an explicit
        # override only through internal construction paths we don't expose.
        return int_from_uint32(fnv1a_hash_str_uint32(self.env_name))


def int_from_uint32(x: int) -> int:
    return x - 2**32 if x >= 2**31 else x
