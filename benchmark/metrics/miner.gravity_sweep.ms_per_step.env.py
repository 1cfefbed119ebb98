"""Mean host milliseconds of the program's ``procgen_torch.miner.gravity_sweep``
span (miner's sweep over the 400 cells of a hard level, once in every game
step), from ``procgen_torch.telemetry``'s totals of the traced window; None
where the program has no telemetry or the span never ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    n, ns, _ = telemetry.snapshot()["spans"].get("procgen_torch.miner.gravity_sweep", (0, 0, 0))
    return ns / n / 1e6 if n else None
