"""One LM iteration's host time: the two solve passes' spans (``lm.pass1``,
``lm.pass2``: each iteration's dispatch and its ``done`` read) over the
iterations run, unprofiled part of the window; None where the run holds no
such span (the tracer off)."""


def read(ctx):
    u = ctx.get("unprofiled")
    p = u and u.get("program")
    ms = [(e - s) / 1e6 for name, s, e, _, _ in p["records"] if name in ("lm.pass1", "lm.pass2")] if p else []
    return sum(ms) / p["steps"] if ms and p["steps"] else None
