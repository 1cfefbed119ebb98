"""Mean host seconds of the program's ``procgen_torch.update`` span (the
epochs of minibatch steps of one iteration, enqueued from the host: beside
``train_update_s``, the device's time, it says whether launching bounds the
update), from ``procgen_torch.telemetry``'s totals of the traced window;
None where the program has no telemetry or no update ran inside it."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    n, ns, _ = telemetry.snapshot()["spans"].get("procgen_torch.update", (0, 0, 0))
    return ns / n / 1e9 if n else None
