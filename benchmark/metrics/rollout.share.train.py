"""Host time in the program's ``procgen_torch.rollout`` spans (the rollout's
env steps, frames and policy, and its bootstrap forward; the one the window
closes in counts up to the close) over the traced window; None where the
program has no telemetry or no rollout ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    n, ns, _ = telemetry.snapshot()["spans"].get("procgen_torch.rollout", (0, 0, 0))
    return ns / 1e9 / run.trace.window_s if n else None
