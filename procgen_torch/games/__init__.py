"""Game registry: name -> GameDef factory (reference game-registry.h).

All sixteen games of ``procgen_tpu.games``: maze (static grid), miner and
chaser (grid-dynamic), coinrun (center-agent platformer with entity push),
leaper (static view, tiled and axis-rotated sprites), ninja and jumper
(center-agent platformers with a HUD), caveflyer (a center-agent view) and
dodgeball (a static view), with free rotation and pair collisions, whose
enemies reflect off cave walls and off lava-wall entities; and the seven
that read sprite aspect ratios from the PNG assets when they are built:
bigfish, climber, heist, fruitbot (a vertical scroller with locked doors),
plunder (lanes of ships and a HUD), starpilot (a spawner timeline and a
scrolling background) and bossfight (shields, attack patterns and
barriers)."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_game(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


def make_game(cfg):
    """Instantiate the GameDef for cfg.env_name (one instance per config)."""
    _import_all()
    name = cfg.env_name
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown or unported env_name {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](cfg)


def _import_all():
    import procgen_torch.games.bigfish  # noqa: F401
    import procgen_torch.games.bossfight  # noqa: F401
    import procgen_torch.games.caveflyer  # noqa: F401
    import procgen_torch.games.chaser  # noqa: F401
    import procgen_torch.games.climber  # noqa: F401
    import procgen_torch.games.coinrun  # noqa: F401
    import procgen_torch.games.dodgeball  # noqa: F401
    import procgen_torch.games.fruitbot  # noqa: F401
    import procgen_torch.games.heist  # noqa: F401
    import procgen_torch.games.jumper  # noqa: F401
    import procgen_torch.games.leaper  # noqa: F401
    import procgen_torch.games.maze  # noqa: F401
    import procgen_torch.games.miner  # noqa: F401
    import procgen_torch.games.ninja  # noqa: F401
    import procgen_torch.games.plunder  # noqa: F401
    import procgen_torch.games.starpilot  # noqa: F401


def available_games():
    _import_all()
    return sorted(_REGISTRY)
