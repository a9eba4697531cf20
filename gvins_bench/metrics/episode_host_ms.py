"""The keyframe episode's host bookkeeping outside the solve and the Schur
complement, per episode of the unprofiled part: the spans ``ep.optimize``,
``ep.remove`` and ``marg`` less the ``lm.pass1``, ``lm.surgery``,
``lm.pass2`` and ``marg.schur`` spans inside them; None where the run holds
no such span (the tracer off)."""

OUTER = ("ep.optimize", "ep.remove", "marg")
INNER = ("lm.pass1", "lm.surgery", "lm.pass2", "marg.schur")


def _inside(recs, parent):
    while parent >= 0:
        if recs[parent][0] in OUTER:
            return True
        parent = recs[parent][3]
    return False


def read(ctx):
    u = ctx.get("unprofiled")
    p = u and u.get("program")
    if not p or not u["episodes"]:
        return None
    recs, ns, outer = p["records"], 0, 0
    for name, s, e, parent, _ in recs:
        if name in OUTER:
            ns += e - s
            outer += 1
        elif name in INNER and _inside(recs, parent):
            ns -= e - s
    return ns / 1e6 / u["episodes"] if outer else None
