"""Mean ``marg`` span (a window slide: its factor tables rebuilt on the host,
then the Schur complement), over the unprofiled part of the window."""


def read(ctx):
    u = ctx.get("unprofiled")
    p = u and u.get("program")
    ms = [(e - s) / 1e6 for name, s, e, _, _ in p["records"] if name == "marg"] if p else []
    return sum(ms) / len(ms) if ms else None
