"""Host milliseconds of the static bake (``render_static2`` of the
pregenerated levels: the program's ``procgen_torch.refill.bake`` spans) per
``procgen_torch.refill`` span, from ``procgen_torch.telemetry``'s totals of
the traced window; None where the program has no telemetry or no refill
ran."""


def read(run):
    try:
        from procgen_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.snapshot()["spans"]
    calls = spans.get("procgen_torch.refill", (0,))[0]
    if not calls or "procgen_torch.refill.bake" not in spans:
        return None
    return spans["procgen_torch.refill.bake"][1] / calls / 1e6
