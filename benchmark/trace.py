"""The traced window: a profiler around it and the summary the per-layer
metrics read.

``summarize`` walks the profiler's raw event list once, as
``procgen_torch/bench/profiling.py`` (commit 46b2158) does, since building
the parsed event tree takes minutes for a window of millions of ops.  It
keeps, per named span, its host time and count, and the time of each named
span spent inside each other one; per device operation, its device time and
count; the device's busy time as the union of the intervals in which any
operation ran (a sum of durations would count two streams twice); and the
longest idle gaps of the device, each named by the innermost span the host
was in at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

WINDOW_SPAN = "benchmark.window"


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # host clock, synchronized at both ends
    busy_s: float  # union of device activity in the window
    span_ns: dict  # span name -> host ns
    span_count: dict  # span name -> occurrences
    nested_ns: dict  # (outer, inner) -> ns of ``inner`` spans inside ``outer``
    device_ns: dict  # device op name -> ns
    device_count: dict  # device op name -> launches
    device_ops: list  # [[name, seconds]] the 10 that took the most time
    idle_gaps: list  # [[host span at the gap, seconds]] the 10 longest gaps

    def share(self, span: str) -> float | None:
        """Host time in ``span`` over the window; None if it never ran."""
        if not self.span_count.get(span):
            return None
        return self.span_ns[span] / 1e9 / self.window_s


@contextlib.contextmanager
def traced(spans):
    """Profile the body (host and device); yields a holder whose
    ``summary`` is set on exit.  The body runs inside ``WINDOW_SPAN``."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Traced", (), {})()
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            yield holder
            sync()
        window_s = time.perf_counter() - t0
    holder.summary = summarize(prof.profiler.kineto_results.events(), spans, window_s)


def short(name: str, width: int = 96) -> str:
    """A kernel's name cut to ``width`` characters (templated names run to
    thousands)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def union(intervals):
    """Merged, sorted (start, end) intervals of a list of them."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, spans, window_s: float) -> TraceSummary:
    spans = set(spans) | {WINDOW_SPAN}
    host, device = [], []
    host_names = set()
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            device.append((e.start_ns(), e.end_ns(), name))
        else:
            host_names.add(name)
            if name in spans:
                host.append((e.start_thread_id(), e.start_ns(), e.end_ns(), name))
    # a span's device-side annotation has the span's name: not an operation
    device = [d for d in device if d[2] not in host_names and d[1] > d[0]]

    win = [h for h in host if h[3] == WINDOW_SPAN]
    lo, hi = (win[0][1], win[0][2]) if win else (float("-inf"), float("inf"))
    host.sort(key=lambda h: (h[0], h[1], -h[2]))
    span_ns, span_count, nested = {}, {}, {}
    stack, tid = [], None
    for t, s0, s1, name in host:
        if t != tid:
            stack, tid = [], t
        while stack and stack[-1][0] <= s0:
            stack.pop()
        if name != WINDOW_SPAN:
            span_ns[name] = span_ns.get(name, 0) + s1 - s0
            span_count[name] = span_count.get(name, 0) + 1
            for outer in {n for _, n in stack if n not in (name, WINDOW_SPAN)}:
                nested[(outer, name)] = nested.get((outer, name), 0) + s1 - s0
        stack.append((s1, name))

    device = [(max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi]
    device_ns, device_count = {}, {}
    for s, e, n in device:
        device_ns[n] = device_ns.get(n, 0) + e - s
        device_count[n] = device_count.get(n, 0) + 1
    busy = union([(s, e) for s, e, _ in device])
    busy_ns = sum(e - s for s, e in busy)

    gaps = []
    if win:
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, reverse=True)[:10]
    inner = sorted((s0, s1, name) for _, s0, s1, name in host if name != WINDOW_SPAN)
    starts = [s for s, _, _ in inner]

    def at(t):
        best = "no span"
        for s0, s1, name in inner[:bisect.bisect_right(starts, t)]:
            if s1 > t:
                best = name  # later starts that still cover t are deeper
        return best

    top = sorted(device_ns.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=window_s,
        busy_s=busy_ns / 1e9,
        span_ns=span_ns,
        span_count=span_count,
        nested_ns=nested,
        device_ns=device_ns,
        device_count=device_count,
        device_ops=[[short(n), v / 1e9] for n, v in top],
        idle_gaps=[[at((a + b) // 2), g / 1e9] for g, a, b in gaps],
    )
