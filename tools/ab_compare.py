"""Compare this checkout of the PyTorch port with another one on the same card, in turns.

    python3 tools/ab_compare.py OTHER_DIR [OUT_DIR]
    python3 tools/ab_compare.py --kernels OTHER_DIR [OUT_DIR]

OTHER_DIR is an unpacked checkout of the port, for example the parent commit
(``git archive HEAD | tar -x -C build/parent`` before the change). Eight runs,
each in its own process, in this order: OTHER's ``chip_smoke.py``, this one's,
this one's, OTHER's; then a stage pass over OTHER's package, this one's, this
one's, OTHER's. A stage pass drives a package with this checkout's
``chip_smoke.py`` helpers: the slice once as the main path runs it (frame
times), once with ``_pyr_body`` and ``_lk_stage`` synchronized on both sides
and timed; then ``vision/lk.py:track_bidirectional`` on the frame 0 -> 1
pair, timed with CUDA events as issued and device-only: one frame's LK,
whatever kernels and glue that package runs for it. Each run's output goes to
``OUT_DIR/<n>_<label>.log`` (default ``build/ab``); printed are each run's
exit code, its ``[kernel]``, ``[slice]`` and ``[stages]`` lines and its JSON
lines. Exits nonzero if a run failed.

With ``--kernels`` only four kernel passes run, OTHER, this, this, OTHER:
each builds its tree's kernels and times the three unbatched calls of the
slice's frame 0 -> 1 (phase 3's inputs), as issued and device-only, one
JSON line a pass with the ptxas report of a pass that built (~15 s each).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KEEP = ("[kernel]", "[slice]", "[stages]", '{"kernels"', '{"card"', "NVIDIA", "H100")


def stage_pass(tree):
    """Time the stages and one frame's LK of the package in ``tree``; print
    them as one JSON line."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.vision import camera as cam
    from ic_gvins_tpu_torch.vision import features as feat
    from ic_gvins_tpu_torch.vision import lk as lk_mod
    from ic_gvins_tpu_torch.vision import map as vmap_mod
    from ic_gvins_tpu_torch.vision import pyramid
    from ic_gvins_tpu_torch.vision import tracking as trk

    assert Path(trk.__file__).resolve().is_relative_to(tree), trk.__file__
    card = cs.the_card(torch)
    camera, _, poses, images = cs.slice_world(cam)
    cfg = parse_config(cs.CFG)

    def tracker():
        vmap = vmap_mod.VisualMap(cfg.optimize_windows_size)
        return trk.Tracker(camera, vmap, cfg, device=cs.DEVICE), vmap

    rows = cs.run_tracker(trk, vmap_mod, *tracker(), images, poses)
    stages, timed_ms = cs.timed_stages(torch, trk, vmap_mod, *tracker(), images, poses)
    dev = torch.device(cs.DEVICE)
    img0, img1 = (torch.tensor(images[k], dtype=torch.float32, device=dev) for k in (0, 1))
    pyr0, pyr1, pts, valid = cs.lk_inputs(torch, pyramid, feat, img0, img1)

    def lk():
        return lk_mod.track_bidirectional(pyr0, pyr1, pts, pts, valid)

    print(json.dumps(dict(card=card, **cs.frame_stats([r[4] for r in rows]), stages=stages,
                          timed_frame_ms_median=float(np.median(timed_ms)),
                          lk_frame_ms=cs.cuda_ms(torch, lk),
                          lk_frame_device_ms=cs.cuda_ms(torch, lk, queued=True))))
    return 0


def kernel_pass(tree):
    """Time the three kernels of the package in ``tree`` on phase 3's inputs
    (one unbatched call each); print them as one JSON line."""
    sys.path.insert(0, str(tree))
    import torch
    from ic_gvins_tpu_torch.ops import _build, clahe, lk, subpix
    from ic_gvins_tpu_torch.vision import camera as cam
    from ic_gvins_tpu_torch.vision import features as feat
    from ic_gvins_tpu_torch.vision import pyramid

    assert Path(lk.__file__).resolve().is_relative_to(tree), lk.__file__
    card = cs.the_card(torch)
    _, _, _, images = cs.slice_world(cam)
    dev = torch.device(cs.DEVICE)
    img0, img1 = (torch.tensor(images[k], dtype=torch.float32, device=dev) for k in (0, 1))
    tables = pyramid.clahe_tables(img0)
    pyr0, pyr1, pts, valid = cs.lk_inputs(torch, pyramid, feat, img0, img1)
    sp_args = cs.subpix_inputs(torch, feat, pyr0[0])
    calls = {"clahe_apply": lambda: clahe.clahe_apply(*tables),
             "lk_pyr": lambda: lk.lk_pyr(pyr0, pyr1, pts, pts, valid),
             "subpix": lambda: subpix.subpix(*sp_args)}
    times = {name: dict(ms=cs.cuda_ms(torch, fn), device_ms=cs.cuda_ms(torch, fn, queued=True))
             for name, fn in calls.items()}
    ptxas = [line.split(":", 1)[-1].strip() for line in _build.build_log.splitlines()
             if "registers" in line or "stack frame" in line]
    print(json.dumps(dict(card=card, kernels=times, ptxas=ptxas)))
    return 0


def run(n, label, cmd, cwd, out_dir):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    log = out_dir / f"{n}_{label}.log"
    log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    print(f"=== {n} {label}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s ({log})")
    for line in proc.stdout.splitlines():
        if line.startswith(KEEP):
            print(line)
    if proc.returncode != 0:
        print(proc.stderr[-3000:])
    return proc.returncode


def main():
    if sys.argv[1] == "--pass":
        return stage_pass(Path(sys.argv[2]).resolve())
    if sys.argv[1] == "--kernel-pass":
        return kernel_pass(Path(sys.argv[2]).resolve())
    kernels_only = sys.argv[1] == "--kernels"
    args = sys.argv[2:] if kernels_only else sys.argv[1:]
    other = Path(args[0]).resolve()
    out_dir = Path(args[1] if len(args) > 1 else ROOT / "build" / "ab")
    out_dir.mkdir(parents=True, exist_ok=True)
    me = [sys.executable, str(Path(__file__).resolve())]
    turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    plan = [(f"{who}_kernels", [*me, "--kernel-pass", str(tree)], tree) for who, tree in turns]
    if not kernels_only:
        plan = ([(f"{who}_smoke", [sys.executable, "chip_smoke.py"], tree) for who, tree in turns]
                + [(f"{who}_stages", [*me, "--pass", str(tree)], tree) for who, tree in turns])
    codes = [run(n, label, cmd, tree, out_dir) for n, (label, cmd, tree) in enumerate(plan)]
    return 0 if not any(codes) else 1


if __name__ == "__main__":
    sys.exit(main())
