#!/usr/bin/env python3
"""Production-envelope replay of the PyTorch port on the card: full-resolution
frames through the real model (the port of scripts/bench_production.py,
which runs the JAX package).

    PROD_DURATION_S=300 python3 scripts/bench_production_torch.py [--device cuda|cpu]

The KAIST urban38 operating regime: 1278x1022 imagery at 10 Hz, 200 Hz
IMU, 1 Hz GNSS, minutes of driving, through ``GvinsModel.run`` at the
production slots (20 nodes, 512 landmarks, 24 GNSS, 2048 reprojection
rows), earth rate on. The world is the JAX script's: tests/gins_data.py's
drive with its turn lasting the duration less 6 s (``chip_smoke.gins_world``,
its jax-free copy), a ground corridor of 120 textured points an anchor (one
anchor a second of the path, +-22 m around it, 9-13 m below; seed 7), each
frame rendered from the points of the 3 x 3 cells of 30 m around the
camera (``_render``: tests/test_gvins_e2e.py's blobs, sigma 2.2 px, at full
size). Rendering is timed apart and left out of ``wall_s``. The duration is
``PROD_DURATION_S`` seconds (default 300; a small value gives a smoke run).

Gates, as the JAX script's: final state TRACKING_NORMAL and ATE RMSE of the
node positions < 0.25 m. If the replay stops early (the estimator refuses a
window slide of more than ``marg_cap`` nodes, as the JAX package does), the
record says where and why, and the script exits nonzero.

Prints one JSON line (the JAX script's keys, ``backend`` the card's name,
plus ``peak_device_mb``, ``sim_s_per_wall_s``, ``episodes``, the card's
power limit, the kernels' launches) and writes it to
``build/PRODUCTION_torch.json``. ``main(argv)`` returns it.
"""

import argparse
import json
import os
import resource
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

W, H = 1278, 1022
FX = 700.0
ATE_GATE_M = 0.25
CAMERA = ([FX, FX, W / 2.0, H / 2.0], [-0.05, 0.01, 0.0, 0.0], [W, H])   # intrinsic, distortion, resolution
BLOB = (2.2, 6)                  # blob sigma and half-width (px)
# the production configuration: earth rate on, extrinsic and td estimation
# off, 200 features, 10 keyframes, the production slots
PROD_RAW = dict(initlength=3, imudatarate=200, iswithearth=True,
                imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
                optimize_windows_size=10, optimize_num_iterations=20, optimize_estimate_extrinsic=False,
                optimize_estimate_td=False, track_min_parallax=20, track_max_interval=0.5, track_max_features=200,
                reprojection_error_std=1.5, node_slots=20, landmark_slots=512, gnss_slots=24, reproj_slots=2048)


def _render(camera, pts_w, Rwb, twb):
    """Gaussian blobs (+-80 gray, sigma 2.2 px, cut at 6 px) at the distorted
    projections over a flat background: the JAX script's ``_render``."""
    from ic_gvins_tpu_torch.vision import camera as cam

    return cs.ground_frame(cam, camera, pts_w, Rwb, twb, *BLOB)


def corridor(truth, rate=200.0, per_anchor=120, seed=7):
    """Textured points +-22 m around each second's position of the path,
    9-13 m below it."""
    rng = np.random.default_rng(seed)
    pts = []
    for a in truth["p"][:: int(rate)]:
        off = np.stack([rng.uniform(-22, 22, per_anchor), rng.uniform(-22, 22, per_anchor),
                        rng.uniform(9, 13, per_anchor)], axis=1)
        pts.append(a * np.array([1.0, 1.0, 0.0]) + off)
    return np.concatenate(pts)


def production_config(truth):
    from ic_gvins_tpu_torch.engine.config import parse_config

    return parse_config(cs.gvins_raw(truth, PROD_RAW, CAMERA))


def main(argv=None, duration=None):
    """Run the envelope; print, save and return the record (``ok`` the
    gates). ``duration`` (seconds) overrides PROD_DURATION_S."""
    import torch

    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.models.gvins import GvinsModel
    from ic_gvins_tpu_torch.vision import camera as cam

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = cs.card_record(torch, dev)
    duration = float(duration if duration is not None else os.environ.get("PROD_DURATION_S", "300"))
    imu, gnss, truth = cs.gins_world(turn_duration=duration - 6.0, with_earth=True)
    cfg = production_config(truth)
    pts_w = corridor(truth)
    camera = cam.PinholeCamera.from_config(*CAMERA)
    rate = 200.0
    frame_times = np.arange(0.05, imu["time"][-1] - 0.2, 0.1)

    # cell index over the scene, so each frame projects only nearby points
    cell = 30.0
    grid = defaultdict(list)
    for i, (cx, cy) in enumerate(np.floor(pts_w[:, :2] / cell).astype(np.int64)):
        grid[(cx, cy)].append(i)
    grid = {k: np.asarray(v) for k, v in grid.items()}
    render_s, last_frame = [0.0], [None]

    def image_provider(k):
        t0 = time.perf_counter()
        i = min(int(round(frame_times[k] * rate)) - 1, len(truth["p"]) - 1)
        p = truth["p"][i]
        cx, cy = int(np.floor(p[0] / cell)), int(np.floor(p[1] / cell))
        idx = [grid[(cx + dx, cy + dy)] for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (cx + dx, cy + dy) in grid]
        local = pts_w[np.concatenate(idx)] if idx else pts_w[:0]
        img = _render(camera, local, rotation_np.to_matrix(truth["q"][i]), p).astype(np.float32)
        render_s[0] += time.perf_counter() - t0
        last_frame[0] = float(frame_times[k])
        return img

    model = GvinsModel(cfg, device=dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    launches0 = cs.kernel_launches()
    stopped = None
    t0 = time.perf_counter()
    try:
        model.run(imu, gnss, frame_times, image_provider)
    except ValueError as e:   # the estimator's refusal of a slide past marg_cap
        stopped = dict(after_frame_s=last_frame[0], error=str(e))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - render_s[0]
    launches = {k: v - launches0[k] for k, v in cs.kernel_launches().items()}

    # accuracy: node positions against the truth (a constant local-frame offset)
    traj = np.asarray(model.trajectory) if model.trajectory else np.zeros((0, 8))
    offset = truth["gnss_local"][0]
    errs = np.asarray([np.linalg.norm(row[1:4] + offset - truth["p"][int(round(row[0] * rate)) - 1])
                       for row in traj if 0 <= int(round(row[0] * rate)) - 1 < len(truth["p"])])
    ate_rmse = float(np.sqrt(np.mean(errs ** 2))) if len(errs) else float("nan")
    n_frames = len(frame_times)
    sim_s = float(imu["time"][-1] - imu["time"][0])
    gates = dict(tracking_normal=model.state == "TRACKING_NORMAL", ate_rmse_below_0_25_m=bool(ate_rmse < ATE_GATE_M),
                 ran_to_the_end=stopped is None)
    rec.update(
        regime="urban38-envelope synthetic", resolution=[W, H], duration_s=float(imu["time"][-1]), frames=n_frames,
        imu_rate_hz=200, cam_rate_hz=10, gnss_rate_hz=1, wall_s=wall, render_s=render_s[0], fps=n_frames / wall,
        sim_s_per_wall_s=sim_s / wall, ate_rmse_m=ate_rmse, ate_max_m=float(errs.max()) if len(errs) else None,
        final_state=model.state, nodes=len(traj), episodes=sum(model.tier_counts.values()),
        solver_tiers=dict(model.tier_counts), marg_tiers=dict(model.tier_counts_marg),
        peak_rss_mb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        peak_device_mb=torch.cuda.max_memory_allocated() / 2**20 if cuda else None,
        backend=rec["device"], launches=launches, stopped=stopped, gates=gates, ok=all(gates.values()),
        ts=time.strftime("%Y-%m-%dT%H:%M:%S"))
    print(json.dumps(rec))
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "PRODUCTION_torch.json").write_text(json.dumps(rec, indent=1) + "\n")
    return rec


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
