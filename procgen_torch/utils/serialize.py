"""get_state/set_state: byte-compatible with the reference's buffer codec
(counterpart of ``procgen_tpu/utils/serialize.py``).

Layout follows Game::serialize (game.cpp:170-229), BasicAbstractGame::
serialize (bag.cpp:1169-1223) and Entity::serialize (entity.cpp:90-134),
using buffer.h primitives (little-endian 4-byte int/float, length-prefixed
strings, RandGen streams as libstdc++ ``operator<<`` text: 624 decimal words
plus the position, space-separated).  The bytes equal the reference
package's for the same state, so dumps of either package restore in the
other.

Host-side numpy code, not a hot path (checkpointing cadence).  The state
crosses between the device and the host in one copy per call: each copy
synchronizes the stream, so one per field (about 80) would dominate the
call on the card.  MT19937 words are int64 in the port (rng.py); they are
printed as their uint32 values.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np
import torch

from procgen_torch import rng as R
from procgen_torch.rng import MT
from procgen_torch.state import tree_leaves_with_names

SERIALIZE_VERSION = 0

# entity field order of entity.cpp:90-134 with buffer types
_ENTITY_LAYOUT = [
    ("x", "f"), ("y", "f"), ("vx", "f"), ("vy", "f"), ("rx", "f"), ("ry", "f"),
    ("type", "i"), ("image_type", "i"), ("image_theme", "i"), ("render_z", "i"),
    ("will_erase", "i"), ("collides_with_entities", "i"),
    ("collision_margin", "f"), ("rotation", "f"), ("vrot", "f"),
    ("is_reflected", "i"), ("fire_time", "i"), ("spawn_time", "i"),
    ("life_time", "i"), ("expire_time", "i"), ("use_abs_coords", "i"),
    ("friction", "f"), ("smart_step", "i"), ("avoids_collisions", "i"),
    ("auto_erase", "i"),
    ("alpha", "f"), ("health", "f"), ("theta", "f"), ("grow_rate", "f"),
    ("alpha_decay", "f"), ("climber_spawn_x", "f"),
]
# one Entity::serialize record as a numpy record (packed, little-endian)
_ENTITY_DTYPE = np.dtype([(n, "<f4" if t == "f" else "<i4") for n, t in _ENTITY_LAYOUT])

# libstdc++ default-constructed mt19937 (seed 5489): the never-seeded
# asset_rand_gen, so that the byte layout matches the reference.
_DEFAULT_MT = R.HostMT(5489)

_MASK32 = 0xFFFFFFFF


def _int32(v) -> int:
    """A C++ int conversion: the low 32 bits, two's complement."""
    return ((int(v) & _MASK32) ^ 0x80000000) - 0x80000000


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def write_int(self, v):
        self.parts.append(struct.pack("<i", _int32(v)))

    def write_float(self, v):
        self.parts.append(struct.pack("<f", float(np.float32(v))))

    def write_bool(self, v):
        # buffer.h: bools travel as ints
        self.write_int(1 if v else 0)

    def write_string(self, s: str):
        b = s.encode()
        self.write_int(len(b))
        self.parts.append(b)

    def write_vector_bool(self, v):
        self.write_int(len(v))
        for x in v:
            self.write_int(1 if x else 0)

    def write_vector_int(self, v):
        self.write_int(len(v))
        for x in v:
            self.write_int(x)

    def write_vector_float(self, v):
        self.write_int(len(v))
        for x in v:
            self.write_float(x)

    def write_raw(self, b: bytes):
        """Bytes already in buffer layout (packed records, int32 arrays)."""
        self.parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def read_int(self) -> int:
        v = struct.unpack_from("<i", self.data, self.off)[0]
        self.off += 4
        return v

    def read_float(self) -> np.float32:
        v = struct.unpack_from("<f", self.data, self.off)[0]
        self.off += 4
        return np.float32(v)

    def read_string(self) -> str:
        n = self.read_int()
        s = self.data[self.off:self.off + n].decode()
        self.off += n
        return s

    def read_bool(self) -> bool:
        return self.read_int() > 0

    def read_vector_bool(self):
        return [self.read_int() > 0 for _ in range(self.read_int())]

    def read_vector_int(self):
        return [self.read_int() for _ in range(self.read_int())]

    def read_vector_float(self):
        return [self.read_float() for _ in range(self.read_int())]

    def read_array(self, dtype, count: int) -> np.ndarray:
        """``count`` packed items of numpy ``dtype`` (a copy)."""
        a = np.frombuffer(self.data, dtype=dtype, count=count, offset=self.off).copy()
        self.off += a.nbytes
        return a


_ENTITY_CTOR_DEFAULTS = {
    "vx": 0.0, "vy": 0.0, "image_theme": 0, "render_z": 0, "will_erase": 0,
    "collides_with_entities": 0, "collision_margin": 0.0, "rotation": 0.0,
    "vrot": 0.0, "is_reflected": 0, "fire_time": -1, "spawn_time": -1,
    "life_time": 0, "expire_time": -1, "use_abs_coords": 0, "friction": 1.0,
    "smart_step": 0, "avoids_collisions": 0, "auto_erase": 1, "alpha": 1.0,
    "health": 1.0, "theta": -100.0, "grow_rate": 1.0, "alpha_decay": 1.0,
    "climber_spawn_x": 0.0,
}


def write_entity_defaults(w: Writer, vals: dict) -> None:
    """Entity::serialize byte layout from a partial field dict (missing
    fields take the ctor defaults); starpilot's spawner list."""
    for name, t in _ENTITY_LAYOUT:
        v = vals.get(name, _ENTITY_CTOR_DEFAULTS.get(name, 0))
        if t == "f":
            w.write_float(float(v))
        else:
            w.write_int(int(v))


def read_entity_fields(r: Reader) -> dict:
    """Inverse of one Entity::serialize record."""
    return {name: r.read_float() if t == "f" else r.read_int() for name, t in _ENTITY_LAYOUT}


def _write_randgen(w: Writer, key, pos, seeded: bool = True):
    """RandGen::serialize (randgen.cpp:100-106): the words as uint32
    decimals (the port's int64 words masked), then the position."""
    w.write_int(1 if seeded else 0)
    words = np.asarray(key, np.int64) & _MASK32
    w.write_string(" ".join(map(str, words.tolist())) + " " + str(int(pos)))


def _read_randgen(r: Reader):
    """(int64 words, position, seeded)."""
    seeded = r.read_int()
    toks = r.read_string().split()
    key = np.asarray([int(t) for t in toks[:R.N]], np.int64)
    return key, int(toks[R.N]), bool(seeded)


# ---------------------------------------------------------------------------
# Device <-> host, one copy per call
# ---------------------------------------------------------------------------


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _padded(nbytes: int) -> int:
    """Each array's bytes start 8-aligned in the shared buffer (a dtype view
    of a slice needs an aligned offset)."""
    return -(-nbytes // 8) * 8


def tensors_to_host(tensors) -> List[np.ndarray]:
    """numpy copies of ``tensors`` (one device) through a single
    device-to-host copy of their bytes."""
    parts, offs, off = [], [], 0
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts += [b, b.new_zeros(_padded(b.numel()) - b.numel())]
        offs.append(off)
        off += _padded(b.numel())
    buf = torch.cat(parts).cpu().numpy()
    return [
        buf[o:o + t.numel() * t.element_size()].view(_np_dtype(t.dtype)).reshape(tuple(t.shape))
        for t, o in zip(tensors, offs)
    ]


def arrays_to_device(arrays, dtypes, device) -> List[torch.Tensor]:
    """Tensors of ``dtypes`` on ``device`` from numpy ``arrays`` through a
    single host-to-device copy."""
    arrays = [np.ascontiguousarray(np.asarray(a).astype(_np_dtype(d), copy=False))
              for a, d in zip(arrays, dtypes)]
    host = np.zeros((sum(_padded(a.nbytes) for a in arrays),), np.uint8)
    offs, off = [], 0
    for a in arrays:
        host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        offs.append(off)
        off += _padded(a.nbytes)
    buf = torch.from_numpy(host).to(device)
    return [buf[o:o + a.nbytes].view(d).reshape(a.shape) for a, d, o in zip(arrays, dtypes, offs)]


# fields the codec never reads (asset_rng is the never-seeded generator;
# the static layer is re-rendered after set_state)
_UNSERIALIZED = ("asset_rng.key", "asset_rng.pos", "static_layer")


def state_to_host(state) -> dict:
    """A batched EnvState as a flat {dotted path: np.ndarray} dict (the
    reference package's ``state_to_host`` keys; MT words int64), in one
    device-to-host copy."""
    leaves = [(k, t) for k, t in tree_leaves_with_names(state) if k not in _UNSERIALIZED]
    arrays = tensors_to_host([t for _, t in leaves])
    return {k: a for (k, _), a in zip(leaves, arrays)}


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------


def serialize_env(gd, cfg, s, i: int) -> bytes:
    """One env's state (host-side flat dict ``s``) -> reference bytes."""
    w = Writer()
    w.write_int(SERIALIZE_VERSION)
    w.write_string(gd.name)

    # options (game.cpp:175-187)
    w.write_int(int(cfg.paint_vel_info))
    w.write_int(0)  # use_generated_assets (refused by get_state)
    w.write_int(int(cfg.use_monochrome_assets))
    w.write_int(int(cfg.restrict_themes))
    w.write_int(int(cfg.use_backgrounds))
    # games overwrite options.center_agent in game_reset (e.g. maze.cpp:66,
    # chaser.cpp:166); the serialized value is the game-effective one
    w.write_int(int(gd.center_agent(cfg)))
    w.write_int(0)  # debug_mode
    w.write_int(int(cfg.distribution_mode))
    w.write_int(int(cfg.use_sequential_levels))
    w.write_int(0)  # use_easy_jump
    w.write_int(0)  # plain_assets
    w.write_int(0)  # physics_mode

    w.write_int(s["grid_step"][i])
    w.write_int(cfg.level_seed_low)
    w.write_int(cfg.level_seed_high)
    w.write_int(0)  # game_type
    w.write_int(i)  # game_n

    _write_randgen(w, s["level_seed_rng.key"][i], s["level_seed_rng.pos"][i])
    _write_randgen(w, s["rng.key"][i], s["rng.pos"][i])

    w.write_float(s["reward"][i])
    w.write_int(s["done"][i])
    w.write_int(s["level_complete"][i])
    w.write_int(s["action"][i])
    w.write_int(s["timeout"][i])
    w.write_int(s["current_level_seed"][i])
    w.write_int(s["prev_level_seed"][i])
    w.write_int(s["episodes_remaining"][i])
    w.write_int(s["episode_done"][i])
    w.write_int(s["last_reward_timer"][i])
    w.write_float(s["last_reward"][i])
    w.write_int(gd.default_action)
    w.write_int(cfg.fixed_asset_seed)
    w.write_int(s["cur_time"][i])
    w.write_int(0)  # is_waiting_for_step

    # BasicAbstractGame (bag.cpp:1169-1223)
    mw = int(s["main_width"][i])
    mh = int(s["main_height"][i])
    w.write_int(mw * mh)  # grid_size

    # the live entities sit at the front of the table
    count = int(s["ents.alive"][i].sum())
    w.write_int(count)
    rec = np.empty((count,), _ENTITY_DTYPE)
    for name, _ in _ENTITY_LAYOUT:
        rec[name] = s[f"ents.{name}"][i][:count]
    w.write_raw(rec.tobytes())

    w.write_int(0)  # use_procgen_background
    w.write_int(s["background_index"][i])
    w.write_float(gd.bg_tile_ratio)
    w.write_float(s["bg_pct_x"][i])
    w.write_float(s["char_dim"][i])
    w.write_int(s["last_move_action"][i])
    w.write_int(s["move_action"][i])
    w.write_int(s["special_action"][i])
    for f in ("mixrate", "maxspeed", "max_jump", "action_vx", "action_vy", "action_vrot",
              "center_x", "center_y"):
        w.write_float(s[f][i])
    w.write_int(int(gd.random_agent_start))
    w.write_int(int(gd.has_useful_vel_info))
    w.write_int(s["step_rand_int"][i])
    _write_randgen(w, _DEFAULT_MT.mt, _DEFAULT_MT.pos, seeded=False)
    w.write_int(mw)
    w.write_int(mh)
    w.write_int(s["out_of_bounds_object"][i])
    for f in ("unit", "view_dim", "x_off", "y_off", "visibility", "min_visibility"):
        w.write_float(s[f][i])

    # grid (grid.h:69-73): w, h, then row-major data cropped to actual dims
    w.write_int(mw)
    w.write_int(mh)
    w.write_int(mw * mh)
    w.write_raw(np.ascontiguousarray(s["grid"][i][:mh, :mw], "<i4").tobytes())

    gd.serialize_extra(w, s, i)
    return w.getvalue()


def get_state(gd, cfg, state) -> List[bytes]:
    """Per-env reference bytes of a batched state."""
    if cfg.use_generated_assets:
        # bag.cpp:1176: the reference fasserts generated assets off for
        # state serialization (asset RNG state is not captured)
        raise RuntimeError("get_state requires use_generated_assets=False")
    s = state_to_host(state)
    return [serialize_env(gd, cfg, s, i) for i in range(s["reward"].shape[0])]


def deserialize_env(gd, cfg, r: Reader, capacity: int, gw: int, gh: int) -> dict:
    """Parse one env's bytes -> dict of scalar/array values (the reference
    package's keys; MT words int64)."""
    out = {}
    assert r.read_int() == SERIALIZE_VERSION
    name = r.read_string()
    assert name == gd.name, (name, gd.name)
    for _ in range(12):
        r.read_int()  # options (taken from cfg)
    out["grid_step"] = r.read_int() > 0
    for _ in range(4):
        r.read_int()  # level_seed_low, level_seed_high, game_type, game_n
    lk, lp, _ = _read_randgen(r)
    out["level_seed_rng.key"], out["level_seed_rng.pos"] = lk, lp
    rk, rp, _ = _read_randgen(r)
    out["rng.key"], out["rng.pos"] = rk, rp
    out["reward"] = r.read_float()
    out["done"] = r.read_int() > 0
    out["level_complete"] = r.read_int() > 0
    for f in ("action", "timeout", "current_level_seed", "prev_level_seed",
              "episodes_remaining"):
        out[f] = r.read_int()
    out["episode_done"] = r.read_int() > 0
    out["last_reward_timer"] = r.read_int()
    out["last_reward"] = r.read_float()
    r.read_int()  # default_action
    r.read_int()  # fixed_asset_seed
    out["cur_time"] = r.read_int()
    r.read_int()  # is_waiting_for_step

    r.read_int()  # grid_size
    count = r.read_int()
    assert count <= capacity, (count, capacity)
    rec = r.read_array(_ENTITY_DTYPE, count)
    ents = {}
    for name, t in _ENTITY_LAYOUT:
        a = np.zeros((capacity,), np.float32 if t == "f" else np.int32)
        a[:count] = rec[name]
        ents[name] = a
    out["ents"] = ents
    out["ents.count"] = count

    r.read_int()  # use_procgen_background
    out["background_index"] = r.read_int()
    r.read_float()  # bg_tile_ratio
    out["bg_pct_x"] = r.read_float()
    out["char_dim"] = r.read_float()
    for f in ("last_move_action", "move_action", "special_action"):
        out[f] = r.read_int()
    for f in ("mixrate", "maxspeed", "max_jump", "action_vx", "action_vy", "action_vrot",
              "center_x", "center_y"):
        out[f] = r.read_float()
    r.read_int()  # random_agent_start
    r.read_int()  # has_useful_vel_info
    out["step_rand_int"] = r.read_int()
    _read_randgen(r)  # asset_rand_gen
    out["main_width"] = r.read_int()
    out["main_height"] = r.read_int()
    out["out_of_bounds_object"] = r.read_int()
    for f in ("unit", "view_dim", "x_off", "y_off", "visibility", "min_visibility"):
        out[f] = r.read_float()

    w_ = r.read_int()
    h_ = r.read_int()
    n = r.read_int()
    grid = np.zeros((gh, gw), np.int32)
    grid[:h_, :w_] = r.read_array("<i4", n).reshape(h_, w_)
    out["grid"] = grid

    out["extra"] = gd.deserialize_extra(r)
    return out


# scalar fields of the codec (the reference package's set_state list)
_SCALARS = (
    "reward", "done", "level_complete", "action", "timeout", "current_level_seed",
    "prev_level_seed", "episodes_remaining", "episode_done", "last_reward_timer",
    "last_reward", "cur_time", "grid_step", "grid", "main_width", "main_height",
    "out_of_bounds_object", "bg_pct_x", "background_index", "char_dim",
    "last_move_action", "move_action", "special_action", "mixrate", "maxspeed",
    "max_jump", "action_vx", "action_vy", "action_vrot", "center_x", "center_y",
    "step_rand_int", "unit", "view_dim", "x_off", "y_off", "visibility", "min_visibility",
)


def set_state(gd, cfg, state, blobs: List[bytes]):
    """A new batched EnvState from per-env byte strings.  ``state`` gives the
    shapes, the device and every field the codec does not carry (the static
    layer, which the caller re-renders, mirroring the re-observe in
    vecgame.cpp:455; asset_rng; extras a game does not serialize).  The
    entity table is rebuilt compacted to the front, ``alive = slot <
    count``, dead slots zero."""
    n = len(blobs)
    capacity = state.ents.capacity
    gh, gw = state.grid.shape[1], state.grid.shape[2]
    parsed = [deserialize_env(gd, cfg, Reader(b), capacity, gw, gh) for b in blobs]

    names, arrays, dtypes = [], [], []

    def add(name, arr, like: torch.Tensor):
        names.append(name)
        arrays.append(arr)
        dtypes.append(like.dtype)

    for mt in ("rng", "level_seed_rng"):
        like = getattr(state, mt)
        add(f"{mt}.key", np.stack([p[f"{mt}.key"] for p in parsed]), like.key)
        add(f"{mt}.pos", np.asarray([p[f"{mt}.pos"] for p in parsed]), like.pos)
    for f in _SCALARS:
        add(f, np.stack([np.asarray(p[f]) for p in parsed]), getattr(state, f))
    for name, _ in _ENTITY_LAYOUT:
        add(f"ents.{name}", np.stack([p["ents"][name] for p in parsed]),
            getattr(state.ents, name))
    counts = np.asarray([p["ents.count"] for p in parsed])
    add("ents.alive", np.arange(capacity)[None, :] < counts[:, None], state.ents.alive)
    for k, like in state.extra.items():
        vals = [p["extra"].get(k) for p in parsed]
        if all(v is not None for v in vals):
            add(f"extra.{k}", np.stack([np.asarray(v) for v in vals]), like)
    assert all(a.shape[0] == n for a in arrays)
    t = dict(zip(names, arrays_to_device(arrays, dtypes, state.done.device)))

    ents = state.ents.replace(
        **{k[len("ents."):]: v for k, v in t.items() if k.startswith("ents.")}
    )
    extra = dict(state.extra)
    extra.update({k[len("extra."):]: v for k, v in t.items() if k.startswith("extra.")})
    return state.replace(
        rng=MT(key=t["rng.key"], pos=t["rng.pos"]),
        level_seed_rng=MT(key=t["level_seed_rng.key"], pos=t["level_seed_rng.pos"]),
        ents=ents,
        extra=extra,
        **{f: t[f] for f in _SCALARS},
    )
