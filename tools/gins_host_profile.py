"""Where the host time of the port's GNSS/INS replay goes, on the card.

    python3 tools/gins_host_profile.py [SECONDS] [DEVICE]

Runs ``GinsModel`` (earth rate on) on ``chip_smoke.gins_world``'s drive of
SECONDS (default 60) on DEVICE (default cuda) twice: once plain, once under
cProfile. Prints the card, the wall time per epoch and per LM iteration, and
the 30 functions with the most own time under cProfile (a torch operator
called from Python, such as ``a * b``, counts in the caller's own time).
"""

import cProfile
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.models import gins as gins_mod
    from ic_gvins_tpu_torch.solver import lm as lm_mod

    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    card = cs.the_card(torch) if device == "cuda" else "CPU"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    imu, gnss, truth = cs.gins_world(turn_duration=seconds - 6.0, with_earth=True, seed=cs.SEED)
    cfg = cs.gins_config(parse_config, truth)

    calls = {"iter": 0, "epoch": 0}
    build, process = lm_mod.build_normal_blocks, gins_mod.GinsModel._process_gnss

    def counted_build(*a, **k):
        calls["iter"] += 1
        return build(*a, **k)

    def counted_process(*a, **k):
        calls["epoch"] += 1
        return process(*a, **k)

    lm_mod.build_normal_blocks, gins_mod.GinsModel._process_gnss = counted_build, counted_process
    try:
        sync()
        t0 = time.perf_counter()
        gins_mod.GinsModel(cfg, device=device).run(imu, gnss)
        sync()
        wall = time.perf_counter() - t0
    finally:
        lm_mod.build_normal_blocks, gins_mod.GinsModel._process_gnss = build, process
    print(f"[host] {seconds:.0f} s drive on {device}: {wall:.3f} s wall, {calls['epoch']} epochs, "
          f"{calls['iter']} LM iterations: {1e3 * wall / calls['epoch']:.2f} ms an epoch, "
          f"{1e3 * wall / calls['iter']:.2f} ms an LM iteration incl. its share of the rest ({card})")

    prof = cProfile.Profile()
    prof.enable()
    gins_mod.GinsModel(cfg, device=device).run(imu, gnss)
    sync()
    prof.disable()
    stats = pstats.Stats(prof)
    stats.sort_stats("tottime").print_stats(30)


if __name__ == "__main__":
    main()
