"""Mean host-clock time of a keyframe episode (``_optimize_visual``, the
second-new-frame removal and the marginalizations after it), over the
episodes of the unprofiled part of the window."""


def read(ctx):
    u = ctx.get("unprofiled")
    if not u or not u["episodes"]:
        return None
    return 1e3 * sum(u["spans"]["episode"]) / u["episodes"]
