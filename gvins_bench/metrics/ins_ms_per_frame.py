"""Host-clock time inside ``InsPropagator.propagate_to`` per frame of the
unprofiled part of the window."""


def read(ctx):
    u = ctx.get("unprofiled")
    if not u or not u["frames"]:
        return None
    return 1e3 * sum(u["spans"]["ins"]) / u["frames"]
