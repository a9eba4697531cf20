"""Process start to window start: world, frames, kernel build (first run in
a checkout), the initializations and the warm-up (host clock)."""


def read(ctx):
    return ctx["setup_s"]
