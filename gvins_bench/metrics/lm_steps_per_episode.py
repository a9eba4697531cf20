"""LM iterations run (accepted or not, the program's ``lm.solve.steps``) per
keyframe episode, over the unprofiled part of the window; None where the
run does not hold the program's tracer records."""


def read(ctx):
    u = ctx.get("unprofiled")
    p = u and u.get("program")
    if not p or not u["episodes"]:
        return None
    return p["steps"] / u["episodes"]
