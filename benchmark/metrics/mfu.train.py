"""The whole training step's share of the card's bf16 peak, in percent: the
IMPALA CNN's FLOPs in the traced window (``yardstick.impala_forward_flops``
per observation forward, three times that for a forward with its backward)
over the window and 989 TFLOP/s (H100 SXM, dense bf16, at 700 W)."""

from benchmark import yardstick


def read(run):
    flops = run.counts.get("flops")
    if not flops:
        return None
    return 100.0 * flops / run.trace.window_s / yardstick.PEAK_BF16_FLOPS
