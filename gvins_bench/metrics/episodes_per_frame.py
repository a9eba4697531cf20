"""Keyframe episodes (window solves, the program's ``tier_counts``) per frame
handed over in the window."""


def read(ctx):
    (c0, c1), n = ctx["counters"], ctx["frames"]
    return (c1["episodes"] - c0["episodes"]) / n if n else None
