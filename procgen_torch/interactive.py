"""Interactive play in the terminal (counterpart of
``procgen_tpu/interactive.py``; reference: procgen/interactive.py).

The reference opens a Qt window through gym3's viewer at 15 Hz; this player
draws the 64x64 observation as 24-bit ANSI half-blocks (two pixels per
character cell), which works over any terminal or SSH session.

    python -m procgen_torch.interactive --env-name coinrun [--device cpu]

Keys: arrows or ijkl move, d/a/w/s/q/e special actions, 1 save state,
2 restore state (reference F1/shift-F1, interactive.py:14-22), ESC quits.
``--record-dir`` saves the played frames as one .npy stack;
``--steps N`` plays N random steps without a terminal and exits;
``--keys`` replays a scripted key string (one character per step, ``.``
for no key) without a terminal.  The env runs on ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np

from procgen_torch.env import ProcgenTorchEnv

FPS = 15.0  # reference tps=15 (gym_registration.py:24)


def _frame_to_ansi(rgb: np.ndarray) -> str:
    """(64, 64, 3) uint8 -> ANSI string, 2 vertical pixels per char."""
    lines = []
    for y in range(0, rgb.shape[0], 2):
        top = rgb[y]
        bot = rgb[y + 1] if y + 1 < rgb.shape[0] else rgb[y]
        parts = []
        for x in range(rgb.shape[1]):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg_, bb = (int(v) for v in bot[x])
            parts.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


_KEY_MAP = {
    "\x1b[A": "UP", "\x1b[B": "DOWN", "\x1b[C": "RIGHT", "\x1b[D": "LEFT",
    "i": "UP", "k": "DOWN", "l": "RIGHT", "j": "LEFT",
    "d": "D", "a": "A", "w": "W", "s": "S", "q": "Q", "e": "E",
}


def _read_keys(timeout: float) -> list:
    """Drain stdin; returns the logical key names pressed in the window."""
    keys = []
    end = time.time() + timeout
    while True:
        remaining = end - time.time()
        if remaining <= 0:
            break
        r, _, _ = select.select([sys.stdin], [], [], remaining)
        if not r:
            break
        ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
        if ch == "\x1b":
            rest = ""
            while select.select([sys.stdin], [], [], 0.0005)[0]:
                rest += os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
            keys.append(_KEY_MAP.get("\x1b" + rest, "") if rest else "ESC")
        else:
            keys.append(_KEY_MAP.get(ch, ch))
    return keys


class Player:
    """One env and its episode bookkeeping: keys in, frames out."""

    def __init__(self, env: ProcgenTorchEnv, record: bool = False):
        self.env = env
        self.record = record
        self.saved_state = None
        self.episode_return = 0.0
        self.frames = []  # kept when recording

    def press(self, keys) -> np.ndarray:
        """One step: ``1`` saves the state, ``2`` restores it, the other
        keys choose the action (no key: the default action).  Returns the
        new frame."""
        env = self.env
        if "1" in keys:
            self.saved_state = env.get_state()
        if "2" in keys and self.saved_state is not None:
            env.set_state(self.saved_state)
        acts = env.keys_to_act([keys])
        action = acts[0] if acts[0] is not None else np.asarray([4])
        env.act(action.astype(np.int32))
        rew, ob, first = env.observe()
        self.episode_return = float(rew[0]) + (0.0 if bool(first[0]) else self.episode_return)
        if self.record:
            self.frames.append(ob["rgb"][0])
        return ob["rgb"][0]

    def save(self, record_dir) -> None:
        if self.frames:
            os.makedirs(record_dir, exist_ok=True)
            np.save(os.path.join(record_dir, "episode.npy"), np.stack(self.frames))


def _script_keys(script: str):
    """Scripted keys: one character per step (``.`` no key)."""
    return [[] if ch == "." else [_KEY_MAP.get(ch, ch)] for ch in script]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--env-name", default="coinrun")
    p.add_argument("--distribution-mode", default="easy")
    p.add_argument("--num-levels", type=int, default=0)
    p.add_argument("--start-level", type=int, default=0)
    p.add_argument("--rand-seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--record-dir", default=None)
    p.add_argument("--steps", type=int, default=0, help="autoplay N random steps and exit")
    p.add_argument("--keys", default=None, help="replay a key string and exit")
    args = p.parse_args(argv)

    kwargs = dict(num=1, env_name=args.env_name, distribution_mode=args.distribution_mode,
                  num_levels=args.num_levels, start_level=args.start_level, device=args.device)
    if args.rand_seed is not None:
        kwargs["rand_seed"] = args.rand_seed
    player = Player(ProcgenTorchEnv(**kwargs), record=bool(args.record_dir))

    if args.steps or args.keys is not None:
        if args.keys is not None:
            for keys in _script_keys(args.keys):
                player.press(keys)
            n = len(args.keys)
        else:
            rng = np.random.RandomState(0)
            for _ in range(args.steps):
                player.env.act(rng.randint(0, 15, size=1))
                rew, ob, first = player.env.observe()
                player.episode_return += float(rew[0])
                if player.record:
                    player.frames.append(ob["rgb"][0])
            n = args.steps
        player.save(args.record_dir)
        print(f"played {n} steps, return {player.episode_return:+.2f}")
        return 0

    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    try:
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            t0 = time.time()
            keys = _read_keys(max(0.0, 1.0 / FPS - 0.001))
            if "ESC" in keys:
                break
            frame = player.press(keys)
            sys.stdout.write("\x1b[H" + _frame_to_ansi(frame))
            sys.stdout.write(
                f"\n\x1b[0m{args.env_name}  return {player.episode_return:+.2f}   "
                "(arrows move, d/a/w/s/q/e special, 1/2 save/restore, ESC quit)\n"
            )
            sys.stdout.flush()
            dt = time.time() - t0
            if dt < 1.0 / FPS:
                time.sleep(1.0 / FPS - dt)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        player.save(args.record_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
