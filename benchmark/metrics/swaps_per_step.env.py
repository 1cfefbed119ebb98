"""Env rows a step that swap in their queued level (an episode ended): the
program's counter ``fast.swaps`` over ``fast.steps`` in the traced window;
None where the program has no such counter or no step ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    counters = telemetry.snapshot()["counters"]
    steps = counters.get("fast.steps", 0)
    if "fast.swaps" not in counters or not steps:
        return None
    return counters["fast.swaps"] / steps
