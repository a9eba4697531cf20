"""Device kernels launched per frame of the profiled sub-window (copies and
fills left out)."""


def read(ctx):
    p = ctx.get("profile")
    return p["kernels"] / p["frames"] if p and p["frames"] else None
