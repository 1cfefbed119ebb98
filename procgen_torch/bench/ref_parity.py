"""The port against the reference C++ binary: replay a golden rollout of
``native/refharness/refdump`` (the reference's sources built against a stub
Qt, ``native/refharness/dump.cpp``) through ``ProcgenTorchEnv`` in parity
mode and require, at the reset and after every step, the reference's
``get_state`` bytes, rewards, first flags and info ints.

The binary reads its sprites from an asset root compiled into it
(``dump.cpp:124``), where its stub ``QImage`` falls back to 64x64 for a
missing file (every aspect ratio 1).  ``patched_binary`` writes a copy
whose root is the relative path ``assets/``, and ``dump`` runs it from a
directory that holds ``assets`` (a link to a synthetic root,
``bench/synth_assets.py``), so both sides read the same non-square
sprites.  ``replay`` is the one comparison (tests/test_torch_ref_parity*.py
call it on each dump); ``check_game`` dumps, replays and deletes one case
(chip_smoke.py's ref_parity phase), on the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import struct
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
REFDUMP = REPO / "native" / "refharness" / "refdump"
MODE_INT = {"easy": 0, "hard": 1, "extreme": 2, "memory": 10}  # dump.cpp's dist_mode
END_OF_BUFFER = b"\xfe\xca\xfe\xca"  # get_state's trailing sentinel (vecgame.cpp:443)

_ROOT_TAIL = b"procgen/data/assets/\0"
_RELATIVE_ROOT = b"assets/"


def patched_binary(workdir, asset_root) -> Path:
    """A copy of the reference binary in ``workdir`` that reads its assets
    from ``workdir/assets`` (made a link to ``asset_root``): the compiled-in
    root is overwritten in place by ``assets/``, NUL-padded, so the copy
    must run from ``workdir`` (``dump`` does)."""
    workdir = Path(workdir)
    data = REFDUMP.read_bytes()
    end = data.find(_ROOT_TAIL)
    if end < 0 or data.find(_ROOT_TAIL, end + 1) >= 0:
        raise RuntimeError(f"{REFDUMP}: no single compiled-in asset root")
    start = data.rfind(b"\0", 0, end) + 1
    n = end + len(_ROOT_TAIL) - 1 - start
    data = data[:start] + _RELATIVE_ROOT.ljust(n, b"\0") + data[start + n:]
    out = workdir / "refdump"
    out.write_bytes(data)
    out.chmod(0o755)
    link = workdir / "assets"
    if link.is_symlink() or link.exists():
        link.unlink()
    link.symlink_to(Path(asset_root).resolve(), target_is_directory=True)
    return out


def dump(binary, out, game, num_envs, steps, rand_seed, mode="hard", num_levels=0,
         start_level=0) -> None:
    """Run the (patched) binary from its own directory: ``num_envs`` envs,
    ``steps`` steps of its seeded random actions, written to ``out``."""
    binary = Path(binary)
    subprocess.run(
        [str(binary), game, str(num_envs), str(steps), str(rand_seed), str(num_levels),
         str(start_level), str(MODE_INT[mode]), str(Path(out).resolve())],
        cwd=binary.parent, check=True, capture_output=True, timeout=600,
    )


@dataclass
class Rollout:
    """A parsed dump (dump.cpp's layout): per step ``actions``, ``rew``,
    ``first``, the three info ints (each (T, N)) and ``states`` (T lists of N
    blobs, sentinel included)."""

    num_envs: int
    steps: int
    init_states: list
    init_rew: np.ndarray
    init_first: np.ndarray
    actions: list = field(default_factory=list)
    rew: list = field(default_factory=list)
    first: list = field(default_factory=list)
    prev_level_seed: list = field(default_factory=list)
    prev_level_complete: list = field(default_factory=list)
    level_seed: list = field(default_factory=list)
    states: list = field(default_factory=list)


def parse_dump(path) -> Rollout:
    data = Path(path).read_bytes()
    off = 0

    def take(dtype, n):
        nonlocal off
        a = np.frombuffer(data, dtype, n, off)
        off += a.nbytes
        return a

    def blobs(n):
        nonlocal off
        out = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<i", data, off)
            out.append(data[off + 4:off + 4 + ln])
            off += 4 + ln
        return out

    n, steps = (int(v) for v in take("<i4", 2))
    ro = Rollout(n, steps, blobs(n), take("<f4", n), take("u1", n))
    for _ in range(steps):
        ro.actions.append(take("<i4", n))
        ro.rew.append(take("<f4", n))
        ro.first.append(take("u1", n))
        ro.prev_level_seed.append(take("<i4", n))
        ro.prev_level_complete.append(take("u1", n))
        ro.level_seed.append(take("<i4", n))
        ro.states.append(blobs(n))
    if off != len(data):
        raise ValueError(f"{path}: {len(data) - off} bytes past the last step")
    return ro


def strip_sentinel(blob: bytes) -> bytes:
    if blob[-4:] != END_OF_BUFFER:
        raise ValueError(f"no END_OF_BUFFER sentinel: {blob[-4:].hex()}")
    return blob[:-4]


def first_diff(a: bytes, b: bytes):
    """Offset of the first differing byte: the shorter length where one is
    a prefix of the other, None when equal."""
    n = min(len(a), len(b))
    i = next((k for k in range(n) if a[k] != b[k]), None)
    return i if i is not None else (None if len(a) == len(b) else n)


def _leaves(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            a = np.asarray(v)
            yield f"{prefix}{k}", a.view(np.dtype(f"u{a.itemsize}"))  # bits: -0.0, NaN


def describe(env, ref: bytes, ours: bytes) -> str:
    """The first differing byte's offset and the first field (in the
    codec's order) that differs, with its slot for an array field."""
    from procgen_torch.utils import serialize as ser

    where = f"offset {first_diff(ref, ours)} (ref {len(ref)} bytes, ours {len(ours)})"
    state = env.state
    cap, gh, gw = state.ents.capacity, state.grid.shape[1], state.grid.shape[2]
    try:
        a, b = (dict(_leaves(ser.deserialize_env(env.gd, env.cfg, ser.Reader(x), cap, gw, gh)))
                for x in (ref, ours))
    except (AssertionError, ValueError, IndexError, struct.error) as exc:
        # a blob the codec cannot read: the offset alone
        return f"{where}; unparsed ({exc})"
    for k, va in a.items():
        vb = b[k]
        if va.shape != vb.shape:
            return f"{where}; field {k}: shapes {va.shape}, {vb.shape}"
        if (va != vb).any():
            i = tuple(int(j) for j in np.argwhere(va != vb)[0])
            return f"{where}; field {k}{list(i) if i else ''}: ref bits {va[i]:#x}, ours {vb[i]:#x}"
    return where


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _diff(env, t, ref_states, ref_rew, ref_first, rew, first):
    """The first difference of rewards (bitwise), first flags and state
    bytes at step ``t``, as text, or None."""
    if not _bits_equal(rew.astype(np.float32), ref_rew):
        return f"t={t}: rewards ours {rew.tolist()} ref {ref_rew.tolist()}"
    if not _bits_equal(first.astype(np.uint8), ref_first):
        return f"t={t}: firsts ours {first.tolist()} ref {ref_first.tolist()}"
    for e, (rb, ob) in enumerate(zip(ref_states, env.get_state(), strict=True)):
        rb = strip_sentinel(rb)
        if rb != ob:
            return f"t={t} env={e}: state bytes, {describe(env, rb, ob)}"
    return None


def replay(ro: Rollout, env):
    """Step ``env`` (a parity-mode ``ProcgenTorchEnv`` of the dump's game,
    seed, mode and env count) through the dump's actions.  Returns None, or
    the first difference as text: rewards, first flags, info ints or state
    bytes, at the reset (t=-1) or after step t."""
    rew, _, first = env.observe()
    bad = _diff(env, -1, ro.init_states, ro.init_rew, ro.init_first, rew, first)
    for t in range(ro.steps):
        if bad is not None:
            break
        env.act(np.array(ro.actions[t], np.int32))
        rew, _, first = env.observe()
        bad = _diff(env, t, ro.states[t], ro.rew[t], ro.first[t], rew, first)
        info = env.get_info()
        for key in ("prev_level_seed", "prev_level_complete", "level_seed"):
            ours = [i[key] for i in info]
            if bad is None and ours != getattr(ro, key)[t].tolist():
                bad = f"t={t}: {key} ours {ours} ref {getattr(ro, key)[t].tolist()}"
    return bad


def check_game(binary, workdir, game, num_envs, steps, rand_seed, mode="hard", num_levels=0,
               start_level=0, device="cuda") -> dict:
    """Dump, replay and delete one case on ``device`` (the card unless
    ``"cpu"`` is given); returns a record with ``ok`` and the first
    difference (``diff``), the dump's seconds and the replay's."""
    from procgen_torch.env import ProcgenTorchEnv

    out = Path(workdir) / f"{game}_{mode}_{rand_seed}.bin"
    t0 = time.perf_counter()
    dump(binary, out, game, num_envs, steps, rand_seed, mode, num_levels, start_level)
    ro = parse_dump(out)
    mb = out.stat().st_size / 2**20
    out.unlink()
    t1 = time.perf_counter()
    env = ProcgenTorchEnv(num_envs, game, rand_seed=rand_seed, num_levels=num_levels,
                          start_level=start_level, distribution_mode=mode, parity_mode=True,
                          render=False, device=device)
    diff = replay(ro, env)
    return dict(game=game, mode=mode, rand_seed=rand_seed, num_envs=num_envs, steps=steps,
                num_levels=num_levels, start_level=start_level, ok=diff is None, diff=diff,
                dump_mb=round(mb, 1), dump_s=round(t1 - t0, 3),
                replay_s=round(time.perf_counter() - t1, 3))
