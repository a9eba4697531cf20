"""The program's own ``Tracker.track_ms`` (a host clock around the whole
frontend call), mean over the tracked frames of the unprofiled part."""


def read(ctx):
    u = ctx.get("unprofiled")
    if not u or not u["track_ms"]:
        return None
    return sum(u["track_ms"]) / len(u["track_ms"])
