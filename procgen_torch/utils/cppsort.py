"""Exact emulation of libstdc++ ``std::sort``, including its unstable
tie order (counterpart of ``procgen_tpu/utils/cppsort.py``; pure Python, on
the host).

The reference sorts starpilot's spawner list with
``std::sort(spawners.begin(), spawners.end(), spawn_cmp)``
(starpilot.cpp:340), where ``spawn_cmp`` compares ``spawn_time`` only.
Spawners often share a spawn_time (``t + j * 5`` collisions across
groups), and std::sort is not stable: the order of tied spawners, which the
serialized state carries, depends on the introsort the reference binary
links (GNU libstdc++).  A stable sort gives a behaviourally equivalent but
byte-different state, so parity mode sorts through this module.

It reimplements libstdc++'s sort step for step (bits/stl_algo.h:
__introsort_loop + __unguarded_partition_pivot + __final_insertion_sort,
with __partial_sort's heapsort fallback from bits/stl_heap.h), so the
permutation applied to tied keys is the reference binary's.
tests/test_torch_cppsort.py holds it against a g++-compiled oracle
(native/stdsort_oracle.cpp).
"""

from __future__ import annotations

import numpy as np

_S_THRESHOLD = 16


def _lg(n: int) -> int:
    return n.bit_length() - 1


def _move_median_to_first(a, result, i1, i2, i3, comp):
    # __move_median_to_first(result, a, b, c)
    if comp(a[i1], a[i2]):
        if comp(a[i2], a[i3]):
            a[result], a[i2] = a[i2], a[result]
        elif comp(a[i1], a[i3]):
            a[result], a[i3] = a[i3], a[result]
        else:
            a[result], a[i1] = a[i1], a[result]
    elif comp(a[i1], a[i3]):
        a[result], a[i1] = a[i1], a[result]
    elif comp(a[i2], a[i3]):
        a[result], a[i3] = a[i3], a[result]
    else:
        a[result], a[i2] = a[i2], a[result]


def _unguarded_partition(a, first, last, pivot, comp):
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not (first < last):
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, first, last, comp):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
    return _unguarded_partition(a, first + 1, last, first, comp)


# --- heap operations (bits/stl_heap.h), used by the introsort depth
# fallback.  __pop_heap moves the top to the back then __adjust_heap
# sifts the displaced value down and __push_heap bubbles it up.


def _push_heap(a, first, hole, top, value, comp):
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, first, hole, length, value, comp):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if length % 2 == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, comp)


def _make_heap(a, first, last, comp):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, first, parent, length, value, comp)
        if parent == 0:
            return
        parent -= 1


def _sort_heap(a, first, last, comp):
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, comp)


def _partial_sort_full(a, first, last, comp):
    # __partial_sort(first, last, last): heap-sort the whole range
    _make_heap(a, first, last, comp)
    _sort_heap(a, first, last, comp)


def _introsort_loop(a, first, last, depth_limit, comp):
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            _partial_sort_full(a, first, last, comp)
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, first, last, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


def _unguarded_linear_insert(a, last, comp):
    val = a[last]
    nxt = last - 1
    while comp(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        nxt -= 1
    a[nxt + 1] = val


def _insertion_sort(a, first, last, comp):
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def _final_insertion_sort(a, first, last, comp):
    if last - first > _S_THRESHOLD:
        _insertion_sort(a, first, first + _S_THRESHOLD, comp)
        for i in range(first + _S_THRESHOLD, last):
            _unguarded_linear_insert(a, i, comp)
    else:
        _insertion_sort(a, first, last, comp)


def std_sort(a: list, comp) -> None:
    """In-place libstdc++ std::sort(a.begin(), a.end(), comp)."""
    n = len(a)
    if n == 0:
        return
    _introsort_loop(a, 0, n, 2 * _lg(n), comp)
    _final_insertion_sort(a, 0, n, comp)


def std_sort_perm(keys, comp_keys) -> np.ndarray:
    """The permutation std::sort applies to ``keys`` under a key-only
    comparator (ties land exactly where libstdc++ leaves them)."""
    pairs = [(k, i) for i, k in enumerate(keys)]
    std_sort(pairs, lambda x, y: comp_keys(x[0], y[0]))
    return np.asarray([i for _, i in pairs], np.int32)
