#!/usr/bin/env python3
"""Host cost of the port's GVINS replay loop on the card (the port of
scripts/bench_replay_host.py, which measures the JAX package on the CPU).

    python3 scripts/bench_replay_host_torch.py [--device cuda|cpu]

The world and configuration of scripts/profile_replay_sections_torch.py
(``replay_world``: 15.2 s of tests/gins_data.py's drive with earth rate on,
320x240 frames rendered beforehand, production slots, 20 LM iterations,
200 features). A warm replay first (the port has no jit to fill, but the
first replay pays the cuBLAS / cuSOLVER handles and the caching
allocator), then the measured replay, synchronized at both ends, then the
same replay again under ``torch.profiler`` (CUDA activity only):

  host_s  = (wall of the measured replay - device busy time) / frames

where the device busy time is the union of the profiled replay's kernel
and copy intervals (``chip_smoke.device_activity``): host_s is the time a
frame's host work keeps the card waiting. Synchronized wrappers around the
device calls, as the JAX script used, would count host dispatch as device
time, which is the very cost being measured; and the profiler's own cost
(tens of microseconds a kernel) makes the profiled replay's wall no
measure of the host, so the wall comes from the unprofiled replay. The
replay is deterministic: ``profiled_replay_same`` says the two ran the same
frames, episodes and marginalizations. ``kf_ratio`` = keyframe episodes /
frames and ``marg_ratio`` = marginalizations / frames are counted from the
run; ``fps_e2e`` is frames over the measured replay's wall time.

Prints one JSON line: the card, host_s, kf_ratio, marg_ratio, fps_e2e,
frames, episodes, margs, the solver and marginalization tiers, the device
busy seconds and kernels, and the kernels' launches in the measured
replay. ``main(argv)``
returns it.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from profile_replay_sections_torch import replay_world  # noqa: E402


def replay(torch, device, world, profiler=None):
    """One replay, synchronized at both ends (under ``profiler`` if given):
    (wall s, frames, marginalizations, the model, launches)."""
    from ic_gvins_tpu_torch.models import gvins as gvins_mod

    imu, gnss, _, times, images, cfg = world
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    model = gvins_mod.GvinsModel(cfg, device=device)
    counts = dict(frames=0, margs=0)
    track, marginalize = model.tracker.track, model._marginalize_visual

    def counted_track(frame, image):
        counts["frames"] += 1
        return track(frame, image)

    def counted_marginalize():
        counts["margs"] += 1
        return marginalize()

    model.tracker.track, model._marginalize_visual = counted_track, counted_marginalize
    launches0 = cs.kernel_launches()
    sync()
    t0 = time.perf_counter()
    with profiler if profiler is not None else contextlib.nullcontext():
        model.run(imu, gnss, times, lambda k: images[k])
        sync()
    wall = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in cs.kernel_launches().items()}
    return wall, counts["frames"], counts["margs"], model, launches


def measure(torch, device, world, warm=True):
    """The warm replay, the measured one, then the profiled one; returns the
    result dict."""
    cuda = torch.device(device).type == "cuda"
    if warm:
        replay(torch, device, world)
    wall, frames, margs, model, launches = replay(torch, device, world)
    episodes = sum(model.tier_counts.values())
    rec = dict(host_s=None, kf_ratio=episodes / max(frames, 1), marg_ratio=margs / max(frames, 1),
               fps_e2e=frames / wall, frames=frames, episodes=episodes, margs=margs, wall_s=wall,
               device_busy_s=None, kernels=None, profiled_wall_s=None, state=model.state,
               solver_tiers=dict(model.tier_counts), marg_tiers=dict(model.tier_counts_marg), launches=launches)
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        pwall, pframes, pmargs, pmodel, _ = replay(torch, device, world, prof)
        same = (pframes, pmargs, dict(pmodel.tier_counts)) == (frames, margs, dict(model.tier_counts))
        kernels, busy_ms = cs.device_activity(torch, prof, 1e3 * pwall)
        if busy_ms is not None:
            rec.update(host_s=(wall - busy_ms / 1e3) / max(frames, 1), device_busy_s=busy_ms / 1e3,
                       kernels=kernels, profiled_wall_s=pwall, profiled_replay_same=same)
    return rec


def main(argv=None, seconds=15.2, warm=True):
    """Measure; print and return the JSON record. ``seconds`` (the drive)
    and ``warm`` (the warm replay first) shrink the run for a CPU check."""
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = cs.card_record(torch, dev)
    rec.update(seconds=seconds, **measure(torch, dev, replay_world(seconds), warm=warm))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
