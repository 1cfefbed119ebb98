"""The compositor's share of its roofline in the env cells, in percent:
the least time for one frame's composite (``yardstick.composite_work``:
the uint8 base layer and frame, the drawn records and the atlas, 20 float32
operations per covered pixel) over the device time of the compositor's
launches per frame in the traced window."""

from benchmark import yardstick


def read(run):
    t, c = run.trace, run.counts
    ns = sum(v for k, v in t.device_ns.items() if "composite_kernel" in k)
    if not ns or not c.get("frames") or "composite_bytes" not in c:
        return None
    per_frame_s = ns / 1e9 / c["frames"]
    return 100.0 * yardstick.bound_s(c["composite_bytes"], c["composite_flops"]) / per_frame_s
