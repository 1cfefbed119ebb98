"""Procgen's random generator, one stream at a time: ``std::mt19937`` wrapped
by ``RandGen`` (procgen/src/randgen.cpp).

The 32-bit outputs come from Python's own MT19937 (``random.Random``), put
into the state that ``std::mt19937::seed(s)`` leaves (``init_genrand``:
``mt[i] = 1812433253 * (mt[i-1] ^ (mt[i-1] >> 30)) + i``, the next output
read after a twist), so ``getrandbits(32)`` returns the C++ generator's
outputs.  The draws are RandGen's:

- ``randint_full()``: the output as a signed 32-bit int;
- ``randn(n)``: output % n;
- ``randint(low, high)``: low + output % (high - low), as 32-bit ints;
- ``rand01()``: float(double(output) / 2**32), a float32.
"""

from __future__ import annotations

import random

import numpy as np

_MASK = 0xFFFFFFFF


def _int32(v: int) -> int:
    v &= _MASK
    return v - (1 << 32) if v >= 1 << 31 else v


class RandGen:
    def __init__(self, seed: int):
        key = [seed & _MASK]
        for i in range(1, 624):
            prev = key[-1]
            key.append((1812433253 * (prev ^ (prev >> 30)) + i) & _MASK)
        self._gen = random.Random()
        self._gen.setstate((3, tuple(key) + (624,), None))

    def raw(self) -> int:
        return self._gen.getrandbits(32)

    def randint_full(self) -> int:
        return _int32(self.raw())

    def randn(self, n: int) -> int:
        return self.raw() % (n & _MASK)

    def randint(self, low: int, high: int) -> int:
        return _int32(low + self.raw() % ((high - low) & _MASK))

    def rand01(self) -> np.float32:
        return np.float32(self.raw() / 4294967296.0)
