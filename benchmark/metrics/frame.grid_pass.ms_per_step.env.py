"""Host milliseconds a step of the program's ``procgen_torch.frame.grid_pass``
span (the grid drawn into every frame: a grid-dynamic game's, between its
two composites, or a moving view's), its total over the program's
``fast.steps`` counter in the traced window; None where the program has no
such span or no step ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    snap = telemetry.snapshot()
    n, ns, _ = snap["spans"].get("procgen_torch.frame.grid_pass", (0, 0, 0))
    steps = snap["counters"].get("fast.steps", 0)
    return ns / steps / 1e6 if n and steps else None
