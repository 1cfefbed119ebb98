"""Mean host milliseconds of the program's ``procgen_torch.game_step`` span
(``step_env_no_reset`` in the fast path's step: the game step without the
refill), from ``procgen_torch.telemetry``'s totals of the traced window;
None where the program has no telemetry or the span never ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    n, ns, _ = telemetry.snapshot()["spans"].get("procgen_torch.game_step", (0, 0, 0))
    return ns / n / 1e6 if n else None
