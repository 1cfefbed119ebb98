"""procgen_torch's copy of the libstdc++ std::sort emulation
(``procgen_torch/utils/cppsort.py``) against the real std::sort: the
g++-compiled native/stdsort_oracle.cpp, on the cases of
tests/test_cppsort.py.  The tie order is the point: starpilot's parity
reset sorts its spawner list by spawn_time through it, and equal spawn
times are common."""

import os
import random
import subprocess
from pathlib import Path

import pytest

from procgen_torch.utils.cppsort import std_sort_perm

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def oracle():
    src = REPO / "native" / "stdsort_oracle.cpp"
    binary = REPO / "native" / "build" / "stdsort_oracle_torch"
    binary.parent.mkdir(exist_ok=True)
    if not binary.exists() or binary.stat().st_mtime < src.stat().st_mtime:
        tmp = binary.with_name(f"{binary.name}.{os.getpid()}")
        subprocess.run(["g++", "-O2", "-o", str(tmp), str(src)], check=True)
        os.replace(tmp, binary)

    def run(keys, desc):
        inp = f"{len(keys)} {int(desc)} " + " ".join(map(str, keys))
        out = subprocess.run(
            [str(binary)], input=inp, capture_output=True, text=True, check=True
        ).stdout.split()
        return [int(x) for x in out]

    return run


def _comp(desc):
    return (lambda a, b: a > b) if desc else (lambda a, b: a < b)


@pytest.mark.parametrize("n", [0, 1, 2, 15, 16, 17, 33, 64, 100, 257, 1000])
@pytest.mark.parametrize("desc", [True, False])
def test_torch_cppsort_tie_heavy(oracle, n, desc):
    rng = random.Random(1234 + n + desc)
    # keys from a tiny alphabet: the most ties
    keys = [rng.randrange(0, max(1, n // 8)) for _ in range(n)]
    assert list(std_sort_perm(keys, _comp(desc))) == oracle(keys, desc)


@pytest.mark.parametrize("seed", range(8))
def test_torch_cppsort_random(oracle, seed):
    rng = random.Random(seed)
    n = rng.randrange(1, 400)
    keys = [rng.randrange(-50, 50) for _ in range(n)]
    assert list(std_sort_perm(keys, _comp(True))) == oracle(keys, True)


def test_torch_cppsort_adversarial(oracle):
    # sorted, reverse-sorted and all-equal inputs reach the deep recursion
    # and the heapsort fallback
    for keys in (
        list(range(300)),
        list(range(300))[::-1],
        [7] * 300,
        [0, 1] * 150,
        sorted([i % 17 for i in range(500)]),
    ):
        for desc in (True, False):
            assert list(std_sort_perm(keys, _comp(desc))) == oracle(keys, desc)


def test_torch_cppsort_spawner_keys(oracle):
    # spawn_time-like keys: t + j * 5 collisions across groups
    rng = random.Random(99)
    t, keys = 1 + rng.randrange(10, 31), []
    while t <= 500:
        g = rng.randrange(1, 6)
        for j in range(g):
            keys.append(t + j * 5)
        t += rng.randrange(10, 31)
    assert list(std_sort_perm(keys, _comp(True))) == oracle(keys, True)
