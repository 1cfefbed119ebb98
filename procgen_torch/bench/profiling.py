"""Profiler summaries read from the raw events.

``profiled(fn, spans)`` runs ``fn`` under ``torch.profiler`` and sums, per
named span (``torch.profiler.record_function``), its host time, its count
and the torch ops inside it (aten ops that no other op encloses, one or
more kernels each), the torch ops outside every span, and device time by
kernel name.  It reads the profiler's raw event list: building the parsed
event tree takes minutes for a leaper refill (about a million ops).
"""

from __future__ import annotations

import time

import torch


def profiled(fn, spans, cuda=True):
    """Run ``fn`` under the profiler (device activity too when ``cuda``);
    returns (wall ns, summary dict with ns, count, ops, ops_outside and
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter_ns()
        fn()
        sync()
        wall_ns = time.perf_counter_ns() - t0
    return wall_ns, summarize(prof.profiler.kineto_results.events(), spans)


def summarize(events, spans) -> dict:
    spans = tuple(spans)
    host, kernels = [], {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() not in spans:  # the spans' device-side annotations
                kernels[e.name()] = kernels.get(e.name(), 0) + e.duration_ns()
        else:
            host.append((e.start_thread_id(), e.start_ns(), e.end_ns(), e.name()))
    host.sort(key=lambda h: (h[0], h[1], -h[2]))
    ns, count, ops = (dict.fromkeys(spans, 0) for _ in range(3))
    outside, stack, tid = 0, [], None
    for t, s0, s1, name in host:
        if t != tid:
            stack, tid = [], t
        while stack and stack[-1][0] <= s0:
            stack.pop()
        if name in ns:
            ns[name] += s1 - s0
            count[name] += 1
        elif name.startswith("aten::") and all(n in ns for _, n in stack):
            for n in {n for _, n in stack}:
                ops[n] += 1
            outside += not stack
        stack.append((s1, name))
    return dict(ns=ns, count=count, ops=ops, ops_outside=outside, kernels=kernels)
