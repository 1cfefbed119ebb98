"""Env state as dataclasses of batched tensors (structure of arrays).

Counterpart of ``procgen_tpu/state.py``.  Every field carries a leading env
axis N: scalar fields of Game/BasicAbstractGame are ``(N,)`` tensors, the
entity list is a fixed-capacity ``(N, E)`` table with an ``alive`` mask, and
the grid is an ``(N, H, W)`` int32 tensor.  Field names match the JAX
package (``ents.x``, ``rng.key``, ``extra["maze_dim"]``) so states convert
field for field (procgen_torch/convert.py).

Code in the port is functional: a function returns new tensors and never
writes into a state it was given, so two states may share tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from procgen_torch import objects as O
from procgen_torch.rng import MT, mt_seed

F32 = torch.float32
I32 = torch.int32
BOOL = torch.bool


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class EntityTable(_Replace):
    """Fixed-capacity SoA entity table, ``(N, E)`` per field.

    Slot 0 is always the agent (basic-abstract-game.cpp:788-792), spawns
    append at ``count``, erases compact stably; slots >= count are dead."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    type: torch.Tensor
    image_type: torch.Tensor
    image_theme: torch.Tensor
    render_z: torch.Tensor
    will_erase: torch.Tensor
    collides_with_entities: torch.Tensor
    collision_margin: torch.Tensor
    rotation: torch.Tensor
    vrot: torch.Tensor
    is_reflected: torch.Tensor
    fire_time: torch.Tensor
    spawn_time: torch.Tensor
    life_time: torch.Tensor
    expire_time: torch.Tensor
    use_abs_coords: torch.Tensor
    friction: torch.Tensor
    smart_step: torch.Tensor
    avoids_collisions: torch.Tensor
    auto_erase: torch.Tensor
    alpha: torch.Tensor
    health: torch.Tensor
    theta: torch.Tensor
    grow_rate: torch.Tensor
    alpha_decay: torch.Tensor
    climber_spawn_x: torch.Tensor
    alive: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]


_ENTITY_FIELDS = {
    "x": F32, "y": F32, "vx": F32, "vy": F32, "rx": F32, "ry": F32,
    "type": I32, "image_type": I32, "image_theme": I32, "render_z": I32,
    "will_erase": BOOL, "collides_with_entities": BOOL,
    "collision_margin": F32, "rotation": F32, "vrot": F32,
    "is_reflected": BOOL, "fire_time": I32, "spawn_time": I32,
    "life_time": I32, "expire_time": I32, "use_abs_coords": BOOL,
    "friction": F32, "smart_step": BOOL, "avoids_collisions": BOOL,
    "auto_erase": BOOL, "alpha": F32, "health": F32, "theta": F32,
    "grow_rate": F32, "alpha_decay": F32, "climber_spawn_x": F32,
    "alive": BOOL,
}


def empty_entity_table(num_envs: int, capacity: int, device) -> EntityTable:
    return EntityTable(
        **{
            name: torch.zeros((num_envs, capacity), dtype=dtype, device=device)
            for name, dtype in _ENTITY_FIELDS.items()
        }
    )


def default_entity_fields(x, y, vx, vy, rx, ry, type_) -> dict:
    """Constructor defaults from entity.cpp:8-51 as a dict of Python numbers
    or tensors (``write_slot`` broadcasts either against the env axis).  The
    EXPLOSION/TRAIL specializations (entity.cpp:44-50) follow ``type_``."""
    if isinstance(type_, torch.Tensor):
        is_explosion = type_ == O.EXPLOSION
        is_trail = type_ == O.TRAIL
        expire_time = torch.where(is_explosion, 4, -1)
        grow_rate = torch.where(is_explosion, 1.4, torch.where(is_trail, 1.05, 1.0))
        alpha_decay = torch.where(is_trail, 0.8, 1.0)
    else:
        expire_time = 4 if type_ == O.EXPLOSION else -1
        grow_rate = 1.4 if type_ == O.EXPLOSION else 1.05 if type_ == O.TRAIL else 1.0
        alpha_decay = 0.8 if type_ == O.TRAIL else 1.0
    return dict(
        x=x, y=y, vx=vx, vy=vy, rx=rx, ry=ry,
        type=type_, image_type=type_, image_theme=0, render_z=0,
        will_erase=False, collides_with_entities=False,
        collision_margin=0.0, rotation=0.0, vrot=0.0, is_reflected=False,
        fire_time=-1, spawn_time=-1, life_time=0, expire_time=expire_time,
        use_abs_coords=False, friction=1.0, smart_step=False,
        avoids_collisions=False, auto_erase=True, alpha=1.0, health=1.0,
        theta=-100.0, grow_rate=grow_rate, alpha_decay=alpha_decay,
        climber_spawn_x=0.0, alive=True,
    )


@dataclasses.dataclass
class EnvState(_Replace):
    """Complete batched env state; sections mirror Game (game.h:62-106) then
    BasicAbstractGame (basic-abstract-game.h:114-163); ``extra`` holds the
    per-game fields."""

    # --- RNG streams ---
    rng: MT
    level_seed_rng: MT
    asset_rng: MT

    # --- Game episode bookkeeping ---
    reward: torch.Tensor
    done: torch.Tensor
    level_complete: torch.Tensor
    action: torch.Tensor
    timeout: torch.Tensor
    current_level_seed: torch.Tensor
    prev_level_seed: torch.Tensor
    episodes_remaining: torch.Tensor
    episode_done: torch.Tensor
    last_reward_timer: torch.Tensor
    last_reward: torch.Tensor
    cur_time: torch.Tensor
    grid_step: torch.Tensor

    # --- BasicAbstractGame world ---
    grid: torch.Tensor  # int32 (N, H_max, W_max), [y, x]
    main_width: torch.Tensor
    main_height: torch.Tensor
    out_of_bounds_object: torch.Tensor
    ents: EntityTable

    bg_pct_x: torch.Tensor
    background_index: torch.Tensor
    char_dim: torch.Tensor
    last_move_action: torch.Tensor
    move_action: torch.Tensor
    special_action: torch.Tensor
    mixrate: torch.Tensor
    maxspeed: torch.Tensor
    max_jump: torch.Tensor
    action_vx: torch.Tensor
    action_vy: torch.Tensor
    action_vrot: torch.Tensor
    center_x: torch.Tensor
    center_y: torch.Tensor
    step_rand_int: torch.Tensor

    # view parameters (prepare_for_drawing, written every step)
    unit: torch.Tensor
    view_dim: torch.Tensor
    x_off: torch.Tensor
    y_off: torch.Tensor
    visibility: torch.Tensor
    min_visibility: torch.Tensor

    # pre-rendered background + grid layer of the current level
    static_layer: torch.Tensor  # uint8 (N, 64, 64, 3)

    # --- per-game extras ---
    extra: Dict[str, Any]

    @property
    def num_envs(self) -> int:
        return self.done.shape[0]


def init_state_template(gd, cfg, num_envs: int, device="cuda") -> EnvState:
    """Fresh (pre-first-reset) batch of ``num_envs`` states with ctor
    defaults.  RNG streams are zero-seeded placeholders; the caller seeds
    ``level_seed_rng`` per env (vecgame.cpp:309-314) before the first reset,
    e.g. with ``seeded_template``."""
    from procgen_torch import resolve_device

    device = resolve_device(device)
    n = num_envs

    def full(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=device)

    zero = full(0, I32)
    mt0 = mt_seed(zero)
    return EnvState(
        rng=mt0,
        level_seed_rng=mt0,
        asset_rng=mt0,
        reward=full(0.0, F32),
        done=full(True, BOOL),  # step_data.done = true in ctor (game.cpp:36)
        level_complete=full(False, BOOL),
        action=zero,
        timeout=full(gd.timeout, I32),
        current_level_seed=zero,
        prev_level_seed=zero,
        episodes_remaining=zero,
        episode_done=full(False, BOOL),
        last_reward_timer=zero,
        last_reward=full(-1.0, F32),
        cur_time=zero,
        grid_step=full(False, BOOL),
        grid=torch.zeros((n, gd.world_h_max, gd.world_w_max), dtype=I32, device=device),
        main_width=zero,
        main_height=zero,
        out_of_bounds_object=full(gd.out_of_bounds_object, I32),
        ents=empty_entity_table(n, gd.max_entities, device),
        bg_pct_x=full(0.0, F32),
        background_index=zero,
        char_dim=full(gd.char_dim, F32),
        last_move_action=full(7, I32),
        move_action=zero,
        special_action=zero,
        mixrate=full(gd.mixrate, F32),
        maxspeed=full(gd.maxspeed, F32),
        max_jump=full(gd.max_jump, F32),
        action_vx=full(0.0, F32),
        action_vy=full(0.0, F32),
        action_vrot=full(0.0, F32),
        center_x=full(0.0, F32),
        center_y=full(0.0, F32),
        step_rand_int=zero,
        unit=full(0.0, F32),
        view_dim=full(0.0, F32),
        x_off=full(0.0, F32),
        y_off=full(0.0, F32),
        visibility=full(gd.visibility, F32),
        min_visibility=full(gd.min_visibility, F32),
        static_layer=torch.zeros((n, 64, 64, 3), dtype=torch.uint8, device=device),
        extra=gd.init_extra(cfg, n, device),
    )


def seeded_template(gd, cfg, num_envs: int, device="cuda", rows=None) -> EnvState:
    """The template batch with one level-seed stream per env, dealt from a
    master generator seeded with ``cfg.rand_seed`` (the reference package's
    bench.py and env wrapper deal seeds the same way).  ``rows`` = (start,
    count) builds only those rows of the ``num_envs`` batch (a rank's
    shard): every seed is drawn on the host, the template only for the
    rows kept."""
    from procgen_torch.rng import HostMT

    start, count = (0, num_envs) if rows is None else rows
    master = HostMT(cfg.rand_seed)
    seeds = [master.randint_full() for _ in range(num_envs)][start:start + count]
    state = init_state_template(gd, cfg, count, device)
    seeds = torch.tensor(seeds, dtype=I32, device=state.done.device)
    return state.replace(level_seed_rng=mt_seed(seeds))


# ---------------------------------------------------------------------------
# Container helpers (dataclasses, dicts and tensors)
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over matching dataclass/dict containers."""
    t = trees[0]
    if dataclasses.is_dataclass(t):
        return type(t)(
            **{
                f.name: tree_map(fn, *(getattr(x, f.name) for x in trees))
                for f in dataclasses.fields(t)
            }
        )
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    return fn(*trees)


def tree_leaves_with_names(tree, prefix: str = ""):
    """[(dotted path, tensor)] in field order: ``ents.x``, ``rng.key``,
    ``extra.maze_dim``."""
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            out += tree_leaves_with_names(getattr(tree, f.name), prefix + f.name + ".")
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_names(tree[k], prefix + k + ".")
        return out
    return [(prefix[:-1], tree)]


def tree_select(pred: torch.Tensor, a, b):
    """Per-env select between two batched containers (pred: bool (N,))."""

    def sel(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)

    return tree_map(sel, a, b)
