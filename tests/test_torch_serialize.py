"""procgen_torch's state codec (``utils/serialize.py``, ``get_state`` /
``set_state``) against procgen_tpu's, on the CPU, in the default
configuration (PNG assets from a synthetic root).

* ``Writer``/``Reader`` against the JAX package's on random ints, floats
  (both zeros, denormals, the extremes), strings and vectors: equal bytes,
  equal parses;
* for all 16 games, 3 envs in hard mode, 40 random steps with a forced
  reset: the port's blobs equal the JAX package's ``serialize_env`` of the
  same state (carried across with ``convert.state_to_numpy``), byte for
  byte, and the port's parse equals the JAX package's ``deserialize_env``
  (MT19937 words compared as uint32);
* the joint env's interleaving (env ``s * k + j`` is game ``j``'s env
  ``s``), the generated-assets refusal and ``set_state`` idempotence.

The resume test (tests/test_serialize.py:10-37 for all 16 games) is in
tests/test_torch_serialize_resume.py.  Nothing here compiles a JAX game:
the JAX codec is host numpy code.
"""

import numpy as np
import pytest
import torch

from procgen_tpu.config import DistributionMode as JMode
from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.utils import serialize as j_ser

from procgen_torch import convert
from procgen_torch.env import ProcgenTorchEnv, make_procgen_env
from procgen_torch.utils import serialize as ser
from test_torch_assets import GAMES, asset_root_fixture

torch.set_num_threads(1)

synth_root = asset_root_fixture()

N = 3
STEPS = 40


def _write_all(w, ints, floats, strings, bools):
    for v in ints:
        w.write_int(v)
    for v in floats:
        w.write_float(v)
    for s in strings:
        w.write_string(s)
    for b in bools:
        w.write_bool(b)
    w.write_vector_int(ints)
    w.write_vector_float(floats)
    w.write_vector_bool(bools)
    return w.getvalue()


def test_writer_reader_match_reference():
    """Exact: equal bytes, equal parsed values (floats by bits)."""
    rs = np.random.RandomState(0)
    ints = [0, 1, -1, 2**31 - 1, -(2**31), 2**32 - 1, 2**31] + list(rs.randint(-2**31, 2**31, 200))
    floats = np.float32([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 3.4028235e38, -3.4028235e38,
                         np.inf, -np.inf])
    floats = list(floats) + list(
        (rs.randn(200) * np.exp(rs.uniform(-80, 80, 200))).astype(np.float32))
    strings = ["", "maze", "1 2 3", "été"]
    bools = [True, False, np.bool_(True), 0, 3]
    got = _write_all(ser.Writer(), ints, floats, strings, bools)
    want = _write_all(j_ser.Writer(), ints, floats, strings, bools)
    assert got == want

    r, jr = ser.Reader(got), j_ser.Reader(got)
    for _ in ints:
        assert r.read_int() == jr.read_int()
    for _ in floats:
        a, b = r.read_float(), jr.read_float()
        assert np.float32(a).view(np.int32) == np.float32(b).view(np.int32)
    for _ in strings:
        assert r.read_string() == jr.read_string()
    for _ in bools:
        assert r.read_bool() == jr.read_bool()
    assert r.read_vector_int() == jr.read_vector_int()
    a, b = r.read_vector_float(), jr.read_vector_float()
    assert np.array_equal(np.float32(a).view(np.int32), np.float32(b).view(np.int32))
    assert r.read_vector_bool() == jr.read_vector_bool()
    assert r.off == jr.off == len(got)


def _assert_parse_equal(got, want, where):
    """A port parse against the JAX package's: MT words as uint32, floats
    by bits, containers recursively."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_parse_equal(got[k], want[k], f"{where}.{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    if w.dtype == np.uint32:
        g = g.astype(np.uint32)
    if w.dtype == np.float32 or g.dtype == np.float32:
        assert g.dtype == w.dtype, where
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=where)


def _run(game, steps=STEPS, n=N, seed=11):
    """A hard-mode port env on the CPU after ``steps`` random steps, env 0
    forced to reset (action -1) at step 15."""
    env = ProcgenTorchEnv(n, game, rand_seed=seed, distribution_mode="hard", device="cpu",
                          render=False)
    rs = np.random.RandomState(2)
    firsts = 0
    for t in range(steps):
        a = rs.randint(0, 15, size=n).astype(np.int32)
        if t == 15:
            a[0] = -1
        env.act(a)
        firsts += int(env.observe()[2].sum())
    assert firsts >= 1
    return env


@pytest.mark.parametrize("game", GAMES)
def test_blobs_match_reference(synth_root, game):
    """Exact, byte for byte."""
    env = _run(game)
    blobs = env.get_state()
    assert len(blobs) == N and all(isinstance(b, bytes) for b in blobs)
    s = convert.state_to_numpy(env.state)
    jcfg = JConfig(env_name=game, num_envs=N, rand_seed=11, distribution_mode=JMode.hard)
    jgd = j_make_game(jcfg)
    gd, cfg = env.gd, env.cfg
    cap = env.state.ents.capacity
    gh, gw = env.state.grid.shape[1:]
    for i in range(N):
        assert blobs[i] == j_ser.serialize_env(jgd, jcfg, s, i), (game, i)
        got = ser.deserialize_env(gd, cfg, ser.Reader(blobs[i]), cap, gw, gh)
        want = j_ser.deserialize_env(jgd, jcfg, j_ser.Reader(blobs[i]), cap, gw, gh)
        _assert_parse_equal(got, want, f"{game}[{i}]")


def test_joint_env_interleaves_blobs(synth_root):
    """Exact: blob ``s * k + j`` is game ``j``'s env ``s``, and a restore
    from the joint blobs resumes every game."""
    joint = make_procgen_env(4, "maze,miner", rand_seed=3, distribution_mode="easy", device="cpu")
    rs = np.random.RandomState(0)
    for _ in range(5):
        joint.act(rs.randint(0, 15, size=4))
    blobs = joint.callmethod("get_state")
    per = [e.get_state() for e in joint.envs]
    assert blobs == [per[0][0], per[1][0], per[0][1], per[1][1]]
    assert [b"maze" in b[:16] for b in blobs] == [True, False, True, False]

    other = make_procgen_env(4, "maze,miner", rand_seed=99, distribution_mode="easy",
                             device="cpu")
    assert other.callmethod("set_state", blobs) is None
    acts = [rs.randint(0, 15, size=4) for _ in range(6)]
    for a in acts:
        joint.act(a)
        other.act(a)
        (r1, o1, f1), (r2, o2, f2) = joint.observe(), other.observe()
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(o1["rgb"], o2["rgb"])
    assert joint.get_state() == other.get_state()


def test_generated_assets_refuse_get_state():
    """bag.cpp:1176: the reference refuses to serialize generated assets
    (tests/test_flags.py:97-99)."""
    env = ProcgenTorchEnv(2, "maze", rand_seed=3, use_generated_assets=True, device="cpu")
    with pytest.raises(RuntimeError, match="use_generated_assets"):
        env.get_state()
    with pytest.raises(AttributeError):
        env.callmethod("no_such_method")


def test_set_state_idempotent(synth_root):
    """Exact: get, set, get gives the same bytes, and the version and the
    name lead each blob."""
    env = _run("bigfish", steps=20, n=2)
    b1 = env.get_state()
    env.set_state(b1)
    assert env.get_state() == b1
    assert b1[0][:4] == b"\x00\x00\x00\x00" and b"bigfish" in b1[0][:16]
