"""The program's spans and counters, collected while a ``torch.profiler``
session runs.

``span(name)`` marks a stretch of host work and ``count(name, n)`` adds to
a counter.  Both read one flag, torch's own ``_is_profiler_enabled``, and
do nothing more when no profiler session is collecting: ``span`` hands back
one shared no-op context (no ``record_function``, no clock read, no
allocation).  While a session collects, a span enters
``torch.profiler.record_function(name)``, so it sits on the profiler's
timeline beside the kernels, and adds its host duration (the
``record_function`` calls included), its count and its self time (the
duration less that of the spans opened inside it) to totals kept here; a counter adds a Python int on the host, or a device
tensor (its sum) into an accumulator on that device, without a sync.

``snapshot()`` gives the totals of the latest profiler session: they
restart whenever a session starts.  Spans nest on the thread that runs the
program (the program has one).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

# every span name in the program (the modules keep their own constants;
# a test holds this tuple to them)
SPANS = (
    "procgen_torch.game_step",
    "procgen_torch.frame",
    "procgen_torch.frame.grid_pass",
    "procgen_torch.refill",
    "procgen_torch.refill.levelgen",
    "procgen_torch.refill.bake",
    "procgen_torch.rollout",
    "procgen_torch.policy",
    "procgen_torch.gae",
    "procgen_torch.update",
    "procgen_torch.pair_collisions",
    "procgen_torch.agent_collision_sweep",
    "procgen_torch.physics.entity_reflect",
    "procgen_torch.reposition",
    "procgen_torch.roomgen.find_path",
    "procgen_torch.mazegen.doors",
    "procgen_torch.starpilot.spawners",
    "procgen_torch.jumper.levelgen_scans",
    "procgen_torch.dodgeball.enemy_sweep",
    "procgen_torch.bossfight.barrier_sweep",
    "procgen_torch.miner.gravity_sweep",
    "procgen_torch.leaper.preroll",
)

_spans: dict = {}  # name -> [count, total ns, self ns]
_counters: dict = {}  # name -> host int
_device_counters: dict = {}  # (name, device) -> int64 0-d tensor
_open: list = []  # per open span: ns of the spans closed inside it


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "mark", "t0")

    def __init__(self, name: str):
        self.name = name
        self.mark = _profiler.record_function(name)

    def __enter__(self):
        _open.append(0)
        self.t0 = time.perf_counter_ns()
        self.mark.__enter__()

    def __exit__(self, *exc):
        self.mark.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        inner = _open.pop()
        if _open:
            _open[-1] += ns
        total = _spans.setdefault(self.name, [0, 0, 0])
        total[0] += 1
        total[1] += ns
        total[2] += ns - inner
        return False


def span(name: str):
    """A context manager over the work named ``name``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``: a Python int, or a tensor whose
    sum is added on its device (read once, by ``snapshot``)."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(n, torch.Tensor):
        key = (name, n.device)
        n = n.sum(dtype=torch.int64)
        acc = _device_counters.get(key)
        if acc is None:
            _device_counters[key] = n
        else:
            acc.add_(n)
    else:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """``{"spans": {name: (count, total_ns, self_ns)}, "counters": {name:
    value}}`` of the latest profiler session: the spans closed and the
    counts added while it collected (device counters read here)."""
    counters = dict(_counters)
    for (name, _), acc in _device_counters.items():
        counters[name] = counters.get(name, 0) + int(acc)
    return {"spans": {k: tuple(v) for k, v in _spans.items()}, "counters": counters}


def _on_profiler_start(start=_profiler._run_on_profiler_start):
    # torch calls this as a session starts collecting (it sets the flag)
    start()
    _spans.clear()
    _counters.clear()
    _device_counters.clear()


_profiler._run_on_profiler_start = _on_profiler_start
