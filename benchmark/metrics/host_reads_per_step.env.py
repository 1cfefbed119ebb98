"""Device-to-host reads per step of the fast path: the sum of the program's
``host_reads.*`` counters (one per read in the step, the refill, the frame
and the learner) over its ``fast.steps`` counter in the traced window; None
where the program has no telemetry or no step ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    counters = telemetry.snapshot()["counters"]
    steps = counters.get("fast.steps", 0)
    if not steps:
        return None
    return sum(v for k, v in counters.items() if k.startswith("host_reads.")) / steps
