"""The 95th percentile, over every frame of the window, of the wall time
between two successive requests of the image provider: all the estimator
does for one frame interval (host clock)."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx["intervals_ms"], 95)) if len(ctx["intervals_ms"]) else None
