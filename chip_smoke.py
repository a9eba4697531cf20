#!/usr/bin/env python3
"""Drive the PyTorch port's visual frontend on one NVIDIA GPU (H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (the kernels are built from
``ic_gvins_tpu_torch/csrc`` into ``build/`` on first use) and imports nothing
of JAX. Phases, in order; any failure raises and the script exits nonzero:

1. the card: ``torch.cuda.is_available()``, and its name and power limit
   from nvidia-smi;
2. build the three CUDA kernels and report the build time and ptxas usage;
3. each kernel against its plain PyTorch version on the card, on a seeded
   synthetic 1278x1022 scene at the slice's shapes, timed with CUDA events;
4. the slice: >= 30 rendered 1278x1022 frames with known camera poses
   through ``Tracker.track`` (device="cuda", track_max_features=200), the
   keyframes inserted into the ``VisualMap`` as the engine does; the
   launch counters are zeroed just before and read just after;
5. the same port on the CPU (the plain versions) against the CUDA run on a
   small 320x240 sequence: identical track states and keyframe flags.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
W, H = 1278, 1022                      # KAIST urban38 stereo_left
KAIST_INTRINSIC = [787.16, 787.39, 664.40, 519.51]
KAIST_DISTORTION = [-0.0917, 0.0813, 0.000176, 0.000167]
N_FRAMES = 36
DEVICE = "cuda"
# Tracker statics at this size: F_MAX, block rows, block cols, per block,
# min pixel distance (vision/tracking.py:135-147 of the JAX package)
SLICE_STATICS = (256, 5, 6, 7, 62)
CFG = dict(track_check_histogram=False, track_min_parallax=20, track_max_interval=0.5,
           track_max_features=200, reprojection_error_std=1.5, optimize_windows_size=10)


# --------------------------------------------------------------------------
# synthetic world: blobs over band-limited texture, seen by a camera moving
# sideways at 1.5 m/s, 10 Hz (the pattern of tests/test_tracking.py)
# --------------------------------------------------------------------------

def make_scene(rng, n_pts, span_x, span_y, span_z):
    return np.stack([rng.uniform(*span_x, n_pts), rng.uniform(*span_y, n_pts),
                     rng.uniform(*span_z, n_pts)], axis=1)


def render(cam_mod, camera, pts_w, R, t, height, width, sigma, radius):
    """Gaussian blobs of alternating sign at the DISTORTED projections."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    img = 90.0 + 15.0 * np.sin(xx / (29.0 * width / 320)) * np.sin(yy / (31.0 * height / 240))
    pc = (pts_w - t) @ R
    front = pc[:, 2] > 0.5
    dis = cam_mod.distort_points(camera, cam_mod.cam2pixel(camera, pc[front]))
    amps = 80.0 * np.where(np.arange(len(pts_w)) % 2 == 0, 1.0, -1.0)[front]
    r = np.arange(-radius, radius + 1)
    for (x, y), a in zip(dis, amps):
        if not (-radius <= x < width + radius and -radius <= y < height + radius):
            continue
        ys = np.clip(int(round(y)) + r, 0, height - 1)
        xs = np.clip(int(round(x)) + r, 0, width - 1)
        ys, xs = np.unique(ys), np.unique(xs)
        blob = np.exp(-((xs[None, :] - x) ** 2 + (ys[:, None] - y) ** 2) / (2 * sigma**2))
        img[np.ix_(ys, xs)] += a * blob
    return np.clip(img, 0, 255)


def sequence(cam_mod, camera, n_frames, height, width, seed, n_pts, spans, sigma, radius):
    rng = np.random.default_rng(seed)
    pts = make_scene(rng, n_pts, *spans)
    poses = [(np.eye(3), np.array([0.15 * k, 0.0, 0.0])) for k in range(n_frames)]
    images = [render(cam_mod, camera, pts, R, t, height, width, sigma, radius) for R, t in poses]
    return pts, poses, images


def run_tracker(trk_mod, map_mod, tracker, vmap, images, poses):
    rows = []
    for k, (img, (R, t)) in enumerate(zip(images, poses)):
        frame = map_mod.VFrame(stamp=0.1 * k)
        frame.R, frame.t = R, t.copy()
        st = tracker.track(frame, img)
        # the engine layer inserts tracker keyframes into the map
        if tracker.is_new_keyframe or st == trk_mod.TRACK_FIRST_FRAME:
            if frame.kf_id is None:
                frame.set_keyframe(map_mod.KEYFRAME_NORMAL)
            vmap.insert_keyframe(frame)
        rows.append((st, tracker.is_new_keyframe, len(frame.features), len(tracker.pts_new),
                     tracker.track_ms))
    return rows


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def cuda_ms(torch, fn, reps=20, warmup=3, queued=False):
    """Mean time per fn() call over reps back-to-back calls, from CUDA events.

    By default the host issues the calls as the main path does, so a call
    whose launches take longer on the host than on the device is timed at
    its host cost. With ``queued`` the stream is first held busy (a device
    sleep) while every launch is enqueued, so the events bracket only the
    device's own execution of the queued kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)  # ~50 ms of device cycles: ample to enqueue reps calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    # ---- phase 1: the card ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.ops import _build
    from ic_gvins_tpu_torch.ops import clahe as kclahe
    from ic_gvins_tpu_torch.ops import lk as klk
    from ic_gvins_tpu_torch.ops import subpix as ksubpix
    from ic_gvins_tpu_torch.vision import camera as cam
    from ic_gvins_tpu_torch.vision import features as feat
    from ic_gvins_tpu_torch.vision import map as vmap_mod
    from ic_gvins_tpu_torch.vision import pyramid
    from ic_gvins_tpu_torch.vision import tracking as trk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- phase 2: build ------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'not run: cached .so'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # ---- phase 3: kernels against their plain versions ---------------------
    camera = cam.PinholeCamera.from_config(KAIST_INTRINSIC, KAIST_DISTORTION, [W, H])
    spans = ((-12.0, 17.0), (-9.0, 9.0), (7.0, 20.0))
    pts_w, poses, images = sequence(cam, camera, N_FRAMES, H, W, SEED, 700, spans, 2.5, 10)
    img0 = torch.tensor(images[0], dtype=torch.float32, device=dev)
    img1 = torch.tensor(images[1], dtype=torch.float32, device=dev)
    records = {}

    def record(name, source, replaces, err, fn, plain_fn):
        ms, plain_ms = cuda_ms(torch, fn), cuda_ms(torch, plain_fn)
        device_ms = cuda_ms(torch, fn, queued=True)
        records[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                             max_abs_err=float(err), ms=float(ms), plain_ms=float(plain_ms))
        print(f"[kernel] {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms per call "
              f"(device-only {device_ms:.4f} ms)  plain {plain_ms:.4f} ms  ({card})")

    # K3 CLAHE apply, on the frame's own tables
    tables = pyramid.clahe_tables(img0)
    out_k = kclahe.clahe_apply(*tables)
    out_p = kclahe.clahe_apply_plain(*tables)
    torch.cuda.synchronize()
    d = (out_k - out_p).abs()
    frac = float((d <= 1e-3).float().mean())
    assert frac >= 0.999 and float(d.max()) <= 1e-2, f"K3 clahe_apply: {frac} within 1e-3, max {float(d.max())}"
    record("clahe_apply", "ic_gvins_tpu_torch/csrc/clahe_apply.cu",
           "ic_gvins_tpu/ops/pallas_clahe.py:64", d.max(),
           lambda: kclahe.clahe_apply(*tables), lambda: kclahe.clahe_apply_plain(*tables))

    # K1 LK level: the main path's cascade (256 slots, 4 levels, frame 0 -> 1)
    pyr0 = pyramid.build_pyramid(pyramid.clahe(img0))
    pyr1 = pyramid.build_pyramid(pyramid.clahe(img1))
    c, _, v = feat.detect_blockwise(pyr0[0], torch.ones_like(pyr0[0]),
                                    torch.zeros(30, dtype=torch.int32, device=dev),
                                    block_rows=5, block_cols=6, per_block=9, min_distance=31)
    pts = c[:256].contiguous()
    valid = v[:256].contiguous()
    assert pts.shape == (256, 2) and int(valid.sum()) > 150, int(valid.sum())
    guess = pts / 8.0
    level_args, errs, agree = [], [], []
    for lvl in range(3, -1, -1):
        args = (pyr0[lvl], pyr1[lvl], (pts / 2.0**lvl).contiguous(), guess.contiguous(), valid)
        level_args.append(args)
        (ok_pts, ok_k), (pl_pts, ok_p) = klk.lk_level(*args), klk.lk_level_plain(*args)
        agree.append(float((ok_k == ok_p).float().mean()))
        both = ok_k & ok_p
        e = torch.linalg.vector_norm(ok_pts[both] - pl_pts[both], dim=1)
        med = float(e.median()) if e.numel() else float("nan")
        print(f"[kernel] lk_level level {lvl} {tuple(args[0].shape)}: ok agree {agree[-1]:.4f}, "
              f"jointly ok {int(both.sum())}, median endpoint diff {med:.2e} px")
        assert agree[-1] >= 0.99 and e.numel() > 50 and med < 1e-3, f"K1 level {lvl}"
        errs.append(float(e.max()))
        guess = pl_pts * 2.0 if lvl > 0 else pl_pts
    record("lk_level", "ic_gvins_tpu_torch/csrc/lk_level.cu",
           "ic_gvins_tpu/ops/pallas_lk.py:309", max(errs),
           lambda: [klk.lk_level(*a) for a in level_args],
           lambda: [klk.lk_level_plain(*a) for a in level_args])
    print("[kernel] lk_level times are one pyr_lk direction: the 4 level calls together")

    # K2 subpix: the slice's detection (5x6 blocks x 7 corners, min distance 62)
    c, _, v = feat.detect_blockwise(pyr0[0], torch.ones_like(pyr0[0]),
                                    torch.zeros(30, dtype=torch.int32, device=dev),
                                    block_rows=5, block_cols=6, per_block=7, min_distance=62)
    sp_args = (pyr0[0], c.contiguous(), v.contiguous())
    out_k, out_p = ksubpix.subpix(*sp_args), ksubpix.subpix_plain(*sp_args)
    e = torch.linalg.vector_norm(out_k - out_p, dim=1)[v]
    assert c.shape == (210, 2) and int(v.sum()) > 150
    med, within = float(e.median()), float((e <= 0.05).float().mean())
    print(f"[kernel] subpix {tuple(c.shape)}: median diff {med:.2e} px, within 0.05 px {within:.4f}")
    assert med < 1e-3 and within >= 0.99, "K2 subpix"
    record("subpix", "ic_gvins_tpu_torch/csrc/subpix.cu", "ic_gvins_tpu/ops/pallas_subpix.py:204",
           e.max(), lambda: ksubpix.subpix(*sp_args), lambda: ksubpix.subpix_plain(*sp_args))

    # argmax tie-breaks: detection on the card equals the CPU on the same frame
    kw = dict(block_rows=5, block_cols=6, per_block=7, min_distance=62)
    cg, _, vg = feat.detect_blockwise(pyr0[0], torch.ones_like(pyr0[0]),
                                      torch.zeros(30, dtype=torch.int32, device=dev), **kw)
    img_cpu = pyr0[0].cpu()
    cc, _, vc = feat.detect_blockwise(img_cpu, torch.ones_like(img_cpu),
                                      torch.zeros(30, dtype=torch.int32), **kw)
    assert torch.equal(cg.cpu(), cc) and torch.equal(vg.cpu(), vc), "detect_blockwise CUDA != CPU"
    print("[detect] corner tables on the card equal the CPU's on the same frame")

    # ---- phase 4: the slice at full width ----------------------------------
    cfg = parse_config(CFG)
    vmap = vmap_mod.VisualMap(cfg.optimize_windows_size)
    tracker = trk.Tracker(camera, vmap, cfg, device=DEVICE)
    assert (tracker.F_MAX, tracker.block_rows, tracker.block_cols, tracker.per_block,
            tracker.min_pixel_distance) == SLICE_STATICS
    wrappers = {"clahe_apply": kclahe.clahe_apply, "lk_level": klk.lk_level,
                "subpix": ksubpix.subpix}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t_slice = time.perf_counter()
    rows = run_tracker(trk, vmap_mod, tracker, vmap, images, poses)
    torch.cuda.synchronize()
    t_slice = time.perf_counter() - t_slice
    launches = {k: w.launches for k, w in wrappers.items()}
    states = [r[0] for r in rows]
    errs = np.array([np.linalg.norm(pts_w - lm.pos, axis=1).min() for lm in vmap.landmarks.values()])
    track_ms = np.array([r[4] for r in rows])
    print(f"[slice] {len(rows)} frames {W}x{H} in {t_slice:.2f} s; states {states}")
    print(f"[slice] features per frame {[r[2] for r in rows]}")
    print(f"[slice] keyframes {len(vmap.keyframes)}, landmarks {len(vmap.landmarks)}, "
          f"landmark error median {np.median(errs) if len(errs) else float('nan'):.3f} m, "
          f"p25 {np.percentile(errs, 25) if len(errs) else float('nan'):.3f} m")
    print(f"[slice] track_ms median {np.median(track_ms):.2f} (frames 2+: "
          f"{np.median(track_ms[2:]):.2f}, p90 {np.percentile(track_ms[2:], 90):.2f}) ({card})")
    print(f"[slice] launches {launches}")
    assert trk.TRACK_TRACKING in states, "tracker never reached TRACK_TRACKING"
    assert len(vmap.keyframes) >= 2, "fewer than 2 keyframes"
    assert len(vmap.landmarks) >= 50, "fewer than 50 landmarks"
    assert np.median(errs) < 0.6 and np.percentile(errs, 25) < 0.3, "landmarks far from truth"
    assert all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}"
    for k, n in launches.items():
        records[k]["launches"] = int(n)

    # ---- phase 5: the CPU plain path agrees with the CUDA run --------------
    small = cam.PinholeCamera.from_config([250.0, 250.0, 160.0, 120.0], [-0.05, 0.01, 0.0, 0.0],
                                          [320, 240])
    _, s_poses, s_images = sequence(cam, small, 14, 240, 320, SEED + 1, 120,
                                    ((-6.0, 8.0), (-4.5, 4.5), (6.0, 14.0)), 1.8, 7)
    small_cfg = parse_config(dict(CFG, track_max_features=120, optimize_windows_size=8))
    out = {}
    for device in (DEVICE, "cpu"):
        m = vmap_mod.VisualMap(small_cfg.optimize_windows_size)
        t = trk.Tracker(small, m, small_cfg, F_MAX=256, device=device)
        out[device] = run_tracker(trk, vmap_mod, t, m, s_images, s_poses)
    for rg, rc in zip(out[DEVICE], out["cpu"]):
        assert rg[:2] == rc[:2] and abs(rg[2] - rc[2]) <= 2 and abs(rg[3] - rc[3]) <= 2, (rg, rc)
    print(f"[small] 320x240 x14: CUDA and CPU states {[r[0] for r in out[DEVICE]]} agree")

    print(json.dumps({"kernels": [records[k] for k in ("clahe_apply", "lk_level", "subpix")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
