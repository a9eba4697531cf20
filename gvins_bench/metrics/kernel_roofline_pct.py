"""The three frontend kernels' least time on the inputs they were given (the
harness's byte and operation counts over H100 SXM peaks) over their device
time in the profiled sub-window, as a percentage."""

from gvins_bench.roofline import KERNELS


def read(ctx):
    p = ctx.get("profile")
    if not p or not p["least_s"]:
        return None
    measured = sum(s for name, s in p["op_s"].items() if any(k in name for k in KERNELS.values()))
    return 100.0 * sum(p["least_s"].values()) / measured if measured else None
