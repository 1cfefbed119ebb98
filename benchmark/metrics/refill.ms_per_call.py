"""Mean host milliseconds of one ``procgen_torch.refill`` span (one
bucket-sized pass of levelgen and static bake)."""


def read(run):
    count = run.trace.span_count.get("procgen_torch.refill", 0)
    return run.trace.span_ns["procgen_torch.refill"] / count / 1e6 if count else None
