"""procgen_torch against the reference C++ itself: ``native/refharness/refdump``
(the reference's sources built against a stub Qt) plays a golden rollout,
and the port replays its actions in parity mode on the CPU.  At the reset
and after every step the port's ``get_state`` bytes, rewards, first flags
and the three info ints must equal the reference's, bit for bit.  No JAX
package stands in between (the reference's own state_test.py protocol).

The dump is read with ``tools/ref_parity.py``'s ``parse_dump`` and
replayed by the port's ``bench/ref_parity.replay`` (the comparison that
chip_smoke.py runs on the card), whose parser, ``strip_sentinel`` and
``first_diff`` are held against the tools' here.  The binary runs as a copy whose compiled-in asset root
points at this module's synthetic root (``bench/ref_parity.patched_binary``),
so both sides read the same non-square sprites, and the seven games that
read aspect ratios are checked with them.

All 16 games, hard, seed 23, 2 envs, 100 steps (the JAX package's gate,
tests/test_ref_parity.py).  The two fault witnesses are in
tests/test_torch_ref_parity_faults.py and the whole sweep, marked slow, in
tests/test_torch_ref_parity_sweep.py.
"""

import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from procgen_torch.bench import ref_parity as rp
from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.games import available_games
from test_torch_assets import asset_root_fixture

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("tools_ref_parity", REPO / "tools" / "ref_parity.py")
tools_rp = sys.modules.setdefault(_spec.name, importlib.util.module_from_spec(_spec))
_spec.loader.exec_module(tools_rp)

GAMES = available_games()

synth_root = asset_root_fixture()


@pytest.fixture(scope="module")
def refbin(synth_root):
    """The patched reference binary, in a directory of its own."""
    with tempfile.TemporaryDirectory(prefix="refdump_") as work:
        yield rp.patched_binary(work, synth_root)


def as_rollout(ro):
    """The tools' parsed dump as the port's ``Rollout``: the same fields,
    the per-env lists as arrays of the dump's types."""
    def arrays(rows, dtype):
        return [np.asarray(r, dtype) for r in rows]

    return rp.Rollout(
        ro.num_envs, ro.steps, ro.init_states, np.asarray(ro.init_rew, np.float32),
        np.asarray(ro.init_first, np.uint8), arrays(ro.actions, np.int32),
        arrays(ro.rew, np.float32), arrays(ro.first, np.uint8),
        arrays(ro.prev_level_seed, np.int32), arrays(ro.prev_level_complete, np.uint8),
        arrays(ro.level_seed, np.int32), ro.states)


def check_against_reference(refbin, game, steps, rand_seed, mode="hard", num_envs=2,
                            num_levels=0, start_level=0):
    """Dump one case with the reference binary, read it with the tools'
    parser and replay it through the port (``rp.replay``: state bytes,
    rewards, first flags and info ints at the reset and after every step);
    returns the rollout."""
    out = refbin.parent / f"{game}_{mode}_{rand_seed}.bin"
    rp.dump(refbin, out, game, num_envs, steps, rand_seed, mode, num_levels, start_level)
    ro = as_rollout(tools_rp.parse_dump(out))
    out.unlink()
    env = ProcgenTorchEnv(num_envs, game, rand_seed=rand_seed, num_levels=num_levels,
                          start_level=start_level, distribution_mode=mode, parity_mode=True,
                          render=False, device="cpu")
    bad = rp.replay(ro, env)
    assert bad is None, f"{game} {mode} seed {rand_seed}: {bad}"
    return ro


@pytest.mark.parametrize("game", GAMES)
def test_port_matches_reference_binary(refbin, game):
    ro = check_against_reference(refbin, game, 100, 23)
    assert ro.steps == 100 and ro.num_envs == 2


def test_port_parser_matches_tools_parser(refbin):
    """``bench/ref_parity.parse_dump`` (the port's copy, which chip_smoke.py
    reads) against the tools' parser, and its replay on one case."""
    out = refbin.parent / "bigfish.bin"
    rp.dump(refbin, out, "bigfish", 3, 30, 5, "easy")
    ours, want = rp.parse_dump(out), tools_rp.parse_dump(out)
    out.unlink()
    assert (ours.num_envs, ours.steps) == (want.num_envs, want.steps) == (3, 30)
    assert ours.init_states == want.init_states and ours.states == want.states
    for k in ("init_rew", "init_first"):
        assert getattr(ours, k).tolist() == getattr(want, k), k
    for k in ("actions", "rew", "first", "prev_level_seed", "prev_level_complete", "level_seed"):
        assert [v.tolist() for v in getattr(ours, k)] == getattr(want, k), k
    assert rp.strip_sentinel(ours.states[-1][0]) == tools_rp.strip_sentinel(want.states[-1][0])
    blob = want.states[-1][0]
    for a, b in ((blob, blob), (blob, blob[:-1]), (blob[:-1], blob), (blob, blob[:9] + b"?")):
        assert rp.first_diff(a, b) == tools_rp.first_diff(a, b)
    env = ProcgenTorchEnv(3, "bigfish", rand_seed=5, distribution_mode="easy", parity_mode=True,
                          render=False, device="cpu")
    assert rp.replay(ours, env) is None


def test_replay_names_the_first_difference(refbin):
    """Rollouts with one byte of a state, or one reward, changed: the replay
    stops at that step and names the field."""
    out = refbin.parent / "maze.bin"
    rp.dump(refbin, out, "maze", 2, 12, 3, "easy")
    ro = rp.parse_dump(out)
    out.unlink()

    def replay():
        return rp.replay(ro, ProcgenTorchEnv(2, "maze", rand_seed=3, distribution_mode="easy",
                                             parity_mode=True, render=False, device="cpu"))

    assert replay() is None
    blob = ro.states[7][1]
    x = len(blob) - 8  # maze's last int, before the sentinel: its world_dim
    ro.states[7][1] = blob[:x] + bytes([blob[x] ^ 1]) + blob[x + 1:]
    bad = replay()
    assert bad.startswith(f"t=7 env=1: state bytes, offset {x} ") and "field extra.world_dim:" in bad, bad
    ro.states[7][1] = blob
    ro.rew[4] = ro.rew[4] + np.float32(1)
    assert replay().startswith("t=4: rewards ours"), replay()
