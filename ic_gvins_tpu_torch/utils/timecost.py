"""Wall-clock stopwatches (TimeCost, common/timecost.h:29-77) and a
profiler trace context. The per-stage costs feed statistics.txt columns
10-12.

A carried-over copy of ``ic_gvins_tpu/utils/timecost.py``; ``profile_trace``
takes the place of its ``jax.profiler`` trace with ``torch.profiler``."""

import contextlib
import os
import time


class TimeCost:
    def __init__(self):
        self.restart()

    def restart(self):
        self._t0 = time.perf_counter()

    def cost_ms(self):
        return (time.perf_counter() - self._t0) * 1000.0

    def cost_s(self):
        return time.perf_counter() - self._t0


@contextlib.contextmanager
def profile_trace(logdir):
    """torch.profiler trace context: host ops and, where a CUDA device is
    present, its kernels; the Chrome trace lands in ``logdir/trace.json``.
    Usage: with profile_trace('/tmp/trace'): step()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
