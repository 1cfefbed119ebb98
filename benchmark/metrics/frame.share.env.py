"""Host time in the benchmark's span around ``render_frames2`` over the
traced window."""


def read(run):
    return run.trace.share("benchmark.frame")
