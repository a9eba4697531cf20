"""The share of a frame's wall time (unprofiled part of the window) in which
the device runs nothing, from its busy time per frame in the profiled
sub-window."""


def read(ctx):
    p, u = ctx.get("profile"), ctx.get("unprofiled")
    if not p or not u or not p["frames"] or not u["frames"]:
        return None
    return 100.0 * (1.0 - (p["busy_s"] / p["frames"]) / (u["wall_s"] / u["frames"]))
