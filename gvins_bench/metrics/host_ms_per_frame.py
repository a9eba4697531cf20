"""Wall time per frame of the unprofiled part of the window less the
device's busy time per frame of the profiled sub-window: the time a frame's
host work keeps the card waiting."""


def read(ctx):
    p, u = ctx.get("profile"), ctx.get("unprofiled")
    if not p or not u or not p["frames"] or not u["frames"]:
        return None
    return 1e3 * (u["wall_s"] / u["frames"] - p["busy_s"] / p["frames"])
