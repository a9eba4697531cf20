"""Host time inside the device -> host reads (``host.fetch`` spans: the host
waiting on the card) per frame of the unprofiled part; None where the run
holds no such span (the tracer off)."""


def read(ctx):
    u = ctx.get("unprofiled")
    p = u and u.get("program")
    ms = [(e - s) / 1e6 for name, s, e, _, _ in p["records"] if name == "host.fetch"] if p else []
    return sum(ms) / u["frames"] if ms and u["frames"] else None
