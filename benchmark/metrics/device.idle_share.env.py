"""One less the union of the device's activity intervals over the traced
window."""


def read(run):
    return 1.0 - run.trace.busy_s / run.trace.window_s
