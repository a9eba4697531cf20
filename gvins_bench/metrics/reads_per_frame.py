"""Device -> host reads (the program's ``fetch.reads``, each a host-device
synchronization on the card) per frame of the unprofiled part."""


def read(ctx):
    u = ctx.get("unprofiled")
    p = u and u.get("program")
    if not p or not u["frames"]:
        return None
    return p["reads"] / u["frames"]
