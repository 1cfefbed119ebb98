"""Host time in the benchmark's span around the fast step, less the
program's refill spans inside it, over the traced window: the game step
and the step loop's bookkeeping."""


def read(run):
    t = run.trace
    if not t.span_count.get("benchmark.fast_step"):
        return None
    ns = t.span_ns["benchmark.fast_step"] - t.nested_ns.get(
        ("benchmark.fast_step", "procgen_torch.refill"), 0)
    return ns / 1e9 / t.window_s
