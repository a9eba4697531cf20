#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (H100): its visual frontend, its
GNSS/INS replay (with and without the wheel odometer), its
GNSS-visual-inertial replay, from memory and from files, its batched
forms over a device mesh and its checkpoint, its user functions, its
measurement scripts, the replay with extrinsic and td estimation on, and
the replay's fault paths to their end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (the kernels are built from
``ic_gvins_tpu_torch/csrc`` into ``build/`` on first use) and imports nothing
of JAX. Phases, in order; any failure raises and the script exits nonzero:

1. the card: ``torch.cuda.is_available()``, and its name and power limit
   from nvidia-smi;
2. build the three CUDA kernels (one nvcc per source, in parallel) and
   report the build time and ptxas usage;
3. each kernel against its plain PyTorch version on the card, on a seeded
   synthetic 1278x1022 scene at the slice's shapes, timed with CUDA events,
   with its bound (the bytes these inputs need over 3.35 TB/s or the
   float32 operations they need over 67 TFLOP/s, the larger: LK and subpix
   count the pixels under their windows and the steps they took); the
   fused LK also on a near-border pair whose flow carries windows past the
   image edge, the CLAHE apply also at an odd width, subpix also on a set of
   corners near the four edges and on blob flanks (``subpix_edge_set``) that
   must reach its clip-shifted slice and its divergence guard, its step
   counts held against the plain version's;
4. the slice: >= 30 rendered 1278x1022 frames with known camera poses
   through ``Tracker.track`` (device="cuda", track_max_features=200), the
   keyframes inserted into the ``VisualMap`` as the engine does; the
   launch counters are zeroed just before and read just after; then a
   second pass with the ``_pyr_body`` and ``_lk_stage`` stages synchronized
   on both sides and timed;
5. the same port on the CPU (the plain versions) against the CUDA run on a
   small 320x240 sequence: identical track states and keyframe flags;
6. the GNSS/INS replay (``GinsModel``, device="cuda", earth rate on) on a
   seeded 90 s drive at 200 Hz with an 8 s GNSS gap (``gins_world``, the
   world of tests/gins_data.py), into a temporary output directory: its
   accuracy, bias and output-file gates; its wall time, LM iterations and
   host reads per epoch; a second run over the drive's first 40 s with each
   stage synchronized and timed, 10 epochs of it under torch.profiler
   (kernels per epoch, device busy share); then the port on CUDA against
   the port on the CPU on the 24 s world, earth off and on: same state,
   nodes and node times; then one odometer run (``odo_replay``): the
   EARTH_ODO replay of tests/test_gins_e2e.py::test_earth_odo_replay, its
   configuration written as a gvins.yaml text and read back with the port's
   load_config, with that test's gates (10-dim mix blocks, node error,
   the estimated wheel scale) and its wall time;
7. the GNSS-visual-inertial replay (``GvinsModel``, device="cuda", the
   production widths: 10 keyframes, 24 node slots, 512 landmark and 2048
   reprojection slots, 200 features) on a seeded 30 s drive (phase 6's world,
   earth rate on) seen by the KAIST camera at 1278x1022 over rendered ground
   blobs 9-13 m below: its gates (TRACKING_NORMAL, node error vs truth, >= 50
   landmarks, output schemas, all three kernels launched inside the replay,
   their counters zeroed just before it); its wall time, LM iterations and
   host reads per keyframe episode, stage medians and a profiler window;
   then the port on CUDA against the port on the CPU on the 24 s 320x240
   world of tests/test_gvins_e2e.py: same states, keyframes and node times,
   positions within 1e-3 m (the CPU run is this script as a child process,
   ``--gvins-cpu-twin``, started with the phase on 4 cores of its own).
8. the long fault world of tests/test_gvins_long_e2e.py (``long_phase``):
   its 120 s drive at 200 Hz with GNSS dropped in [60, 75) s, 10 Hz frames
   at 160x120 brightened x1.35 in [45, 46) s and featureless in [85, 86.5)
   s, extrinsic and td estimation and the histogram gate on; written to
   files (imu.txt, gnss.txt, frames.txt with 'stamp relpath' lines, 8-bit
   PNGs, gvins.yaml), read back and checked against the streams (native
   against numpy parse), each kernel held against its plain version on a
   normal, a glitch and a featureless frame of it, then replayed through
   ``scripts/run_gvins_torch.py``'s ``main`` (``--device cuda``, the three
   counters zeroed just before): that test's five gates against the truth
   and the evidence that the histogram gate, TRACK_LOST in the blackout and
   tracking after it, a GNSS-free bridge with reprojection rows, the
   td/extrinsic updates and the three kernels ran. The JAX package refuses
   a window slide of more than marg_cap nodes, and the port refuses it
   alike: on these files it stops after the frame at 40.25 s (on the CPU),
   every gate whose window lies after the stop is printed NOT MET (ROADMAP
   R1) and the phase holds the gates of the span that ran. The fault paths
   past that stop run to their end in phase 12.
9. the batched forms of ``parallel/mesh.py`` on ``make_mesh()`` (the card)
   and the checkpoint (``fleet_phase``): B = 1, 8 and 32 distinct windows
   of ``np_problem`` (this script's copy of ``__graft_entry__._np_problem``)
   at the production widths (N 20, L 512, G 24, R 2048, earth rate on)
   through ``sharded_two_pass`` with 20 iterations, each element against
   its own single solve, wall time against the B single solves looped,
   host reads, the busy share of one profiled solve at B = 8;
   ``sharded_frontend`` on 4 worlds of the slice (200 features), each
   kernel's one launch for all worlds against its batched plain version
   (phase 3's checks), each world against its unbatched frame, the launch
   counters zeroed just before the batched call and read just after,
   device-only ms a world; ``sharded_marg_step`` and ``sharded_ins_step``
   on 8 worlds, each against its single call; phase 6's estimator saved
   with ``save_checkpoint``, loaded into a fresh estimator on the card and
   both optimized once more.
10. the user functions of the last slice and the measurement scripts
   (``script_phase``): the undistortion remap at 1278x1022 on the card
   against the CPU and the analytic dot test of
   tests/test_vision_kernels.py, the world/pixel transforms and
   ``state_to_camera_pose`` CUDA against CPU, the dense
   ``build_normal_equations`` at the production widths (N 20, L 512, R
   2048) on ``np_problem``'s window against the block assembly, with
   ``apply_gauge`` freezing the inactive columns; then
   scripts/bench_frontend_stages_torch.py (every stage printed, device-only
   and as issued, and the frontend's busy share), one run of
   scripts/profile_replay_sections_torch.py (its top ten sections printed)
   and a 20 s run of scripts/bench_production_torch.py at 1278x1022 with
   its gates (TRACKING_NORMAL, ATE RMSE < 0.25 m); each script with the
   launch counters set to 0 just before it and read just after, every
   kernel launched, its record in build/phase10_*.json.
11. ``GvinsModel`` with extrinsic and td estimation on (``estimation_phase``):
   the drifted-clock world of tests/test_td_estimation.py (``td_world``: its
   36 s drive, 320x240 frames exposed 30 ms after their stamps, td from 0)
   with that test's gates (TRACKING_NORMAL, |td - 0.03| < 0.012 s, max td >
   0.015 s, > 30 nodes, all finite), the td after every episode and the
   adoptions; the hard-cadence stability world of
   tests/test_gvins_stability_e2e.py (``stability_world``, cut from 300 s to
   STAB_DURATION = 90 s: 160x120 frames, a keyframe on most frames, GNSS
   removed over [40.5, 60.5) s) with that test's seven gates at their
   duration-scaled thresholds (``stability_gates``), the episodes,
   marginalizations, bridge error and the device busy share over three
   profiled episodes; the JAX tests' hooks on the model's own methods
   (``EstimationLog``); each kernel held against its plain version on a
   frame pair of each world, its counter set to 0 just before each replay
   and read just after; then both worlds on the card against the CPU (this
   script as a child process, ``--estimation-cpu-twins``): the td world's
   final state, and the stability world's frames before STAB_TWIN_UNTIL s
   up to the first frame at which the two part, printed with what differs
   there (``first_parting``). A gate the JAX package fails alike is printed
   and left standing: a replay stopped by the marg_cap refusal (NOT MET
   after the stop, ROADMAP R1), time-consistency violations that are all
   the 1e-4 s sample snap of ``ImuStream.series`` (R4), and, where the
   stability replay reaches the end, the gates in ``STAB_JAX_F64_FAILS``,
   which the JAX package's own replay of that world fails at the port's
   precision (f64 solve, sync dispatch) at a drive of its test's own
   ICGVINS_STAB_DURATION or in one of its CPU configurations (R5, R6). The
   phase starts with ``scatter_check``: the assembly's scatter is
   repeatable on the card. ``python3 chip_smoke.py --scatter-ab`` times
   phase 7's small replay with that scatter and with ``index_add`` in turns. ``python3 chip_smoke.py --stab-parting OUT_DIR
   [SECONDS [VARIANT,...]]`` replays the stability world on the card twice
   as phase 11 does, once in each other variant (under torch's
   deterministic algorithms, with the plain kernels), and on the CPU, and
   prints where each pair parts (``stability_parting``).
12. the GVINS fault paths to their end (``fault_phase``): ``fault_world``,
   the long world's recipe over a 40 s drive with the faults inside it
   (frames brightened x1.35 in [14, 15) s, GNSS fixes removed over [18, 26)
   s, featureless frames in [30, 31.5) s, fixes with std 15 m on each axis
   in [10, 12) s and one with std 0 at 28 s). (a) At 160x120 with
   LONG_RAW (extrinsic and td estimation and the histogram gate on) on the
   card: each kernel against its plain version on a normal, a glitch and a
   featureless frame, then the replay with its counters set to 0 just
   before and read just after and ``fault_gates`` (tests/test_gvins_long_
   e2e.py's gates moved with the windows, TRACK_PASSED in the glitch,
   TRACK_LOST in the blackout, the degraded and zero-std fixes dropped,
   every other fix taken, TRACKING_NORMAL at the end); then against the CPU
   (this script as a child process, ``--fault-cpu-twin``) up to the first
   frame at which the two part. (b) The same faults at 1278x1022 over the
   production envelope's corridor with its configuration, the histogram
   gate on and ``isusegnssoutage`` from 36 s: the same gates, its kernel
   checks, sim-s per wall-s, frames per second, the device busy share over
   three profiled episodes and the launches.

Each phase prints its seconds. The kernels' ``launches`` are phase 8's
replay's (``launches_by_path`` keeps phase 4's, phase 7's, phase 9's
batched frame's, phase 10's scripts' and phase 11's and phase 12's two
replays' too).

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The helpers take the port's modules as
arguments, so ``tools/ab_compare.py`` can drive another checkout with them.
"""

import collections
import json
import os
import pickle
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
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 peak rate
F32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores
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

def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def timed_stages(torch, trk, map_mod, tracker, vmap, images, poses):
    """The slice again with ``_pyr_body`` and ``_lk_stage`` synchronized on
    both sides: their ms per call (host clock), and the frame times."""
    times = {"_pyr_body": [], "_lk_stage": []}
    originals = {name: getattr(trk, name) for name in times}

    def wrap(name):
        fn = originals[name]

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    for name in times:
        setattr(trk, name, wrap(name))
    try:
        rows = run_tracker(trk, map_mod, tracker, vmap, images, poses)
    finally:
        for name, fn in originals.items():
            setattr(trk, name, fn)
    return {name: dict(calls=len(t), median_ms=float(np.median(t)), total_ms=float(np.sum(t)))
            for name, t in times.items()}, [r[4] for r in rows]


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


def nvidia_smi():
    """nvidia-smi's "name, power limit" line of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def the_card(torch):
    """Print and return nvidia-smi's name and power limit of the card."""
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return card


def slice_world(cam):
    camera = cam.PinholeCamera.from_config(KAIST_INTRINSIC, KAIST_DISTORTION, [W, H])
    spans = ((-12.0, 17.0), (-9.0, 9.0), (7.0, 20.0))
    return (camera, *sequence(cam, camera, N_FRAMES, H, W, SEED, 700, spans, 2.5, 10))


def frame_stats(track_ms):
    ms = np.asarray(track_ms)
    return dict(frame_ms_median=float(np.median(ms)), frame_ms_median_2plus=float(np.median(ms[2:])),
                frame_ms_p90_2plus=float(np.percentile(ms[2:], 90)))


def lk_inputs(torch, pyramid, feat, img0, img1):
    """The LK call of the main path on frame 0 -> 1: both CLAHE pyramids,
    256 slots of corners (pts, valid)."""
    pyr0 = pyramid.build_pyramid(pyramid.clahe(img0))
    pyr1 = pyramid.build_pyramid(pyramid.clahe(img1))
    c, _, v = feat.detect_blockwise(pyr0[0], torch.ones_like(pyr0[0]),
                                    torch.zeros(30, dtype=torch.int32, device=img0.device),
                                    block_rows=5, block_cols=6, per_block=9, min_distance=31)
    return pyr0, pyr1, c[:256].contiguous(), v[:256].contiguous()


def subpix_inputs(torch, feat, img):
    """The subpix call of the main path on ``img``: the slice's detection
    (5x6 blocks x 7 corners, min distance 62), 210 corner slots."""
    c, _, v = feat.detect_blockwise(img, torch.ones_like(img),
                                    torch.zeros(30, dtype=torch.int32, device=img.device),
                                    block_rows=5, block_cols=6, per_block=7, min_distance=62)
    return img, c.contiguous(), v.contiguous()


def slice_pixels(torch, img, pts, half, pad):
    """Flat indices into ``img`` of the raw (2*half+2)^2 slices that
    ``extract_patch`` reads around ``pts`` of ``img`` edge-padded by ``pad``
    px: the slice corner clipped inward, the padding an index clamp."""
    H, W = img.shape
    size = 2 * half + 2
    r = torch.arange(size, device=img.device)
    x0 = torch.clamp(torch.floor(pts[:, 0] + pad).long() - half, 0, W + 2 * pad - size)
    y0 = torch.clamp(torch.floor(pts[:, 1] + pad).long() - half, 0, H + 2 * pad - size)
    xs = torch.clamp(x0[:, None] + r - pad, 0, W - 1)
    ys = torch.clamp(y0[:, None] + r - pad, 0, H - 1)
    return (ys[:, :, None] * W + xs[:, None, :]).reshape(-1)


def lk_pyr_bytes(torch, klk, args):
    """Bytes the fused LK must move on these inputs, from its plain version's
    level calls: each level pixel under a template slice (24x24 at a gated
    slot's previous point) or under its first step's window slice (22x22 at
    the level's first guess, slots whose template passed) read once, the
    points and flags read once, the outputs written once. The windows of
    later steps, a pixel or two further on, are not counted: a lower bound."""
    calls, level = [], klk.lk_level_plain

    def traced(img_prev, img_next, pts_prev, guess, valid):
        nxt, ok = level(img_prev, img_next, pts_prev, guess, valid)
        calls.append((img_prev, img_next, pts_prev, guess, valid, ok))
        return nxt, ok

    klk.lk_level_plain = traced
    try:
        klk.lk_pyr_plain(*args)
    finally:
        klk.lk_level_plain = level
    read = {}
    for img_prev, img_next, pts_prev, guess, gate, ok in calls:
        for img, pts, mask, half in ((img_prev, pts_prev, gate, klk.WIN_HALF + 1),
                                     (img_next, guess, ok, klk.WIN_HALF)):
            read.setdefault(img.data_ptr(), []).append(
                slice_pixels(torch, img, pts[mask], half, klk.PAD))
    n_px = sum(int(torch.unique(torch.cat(idx)).numel()) for idx in read.values())
    _, _, pts_prev, pts_pred, valid = args
    return 4 * n_px + nbytes(pts_prev, pts_pred, valid) + valid.numel() * (2 * 4 + 1)


def near_border_pair(torch, pyramid, base, sign, n=256):
    """Level 0 ``base`` and its copy shifted by (7.3, 6.2) px * sign; n
    slots 6-15 px from the edge the flow points to (half near the x edge,
    half near the y edge), guesses within 0.4 px of the flow: the pattern of
    tests/test_torch_lk.py, at the slice's size."""
    dev = base.device
    Hb, Wb = base.shape
    rng = np.random.default_rng(SEED + (1 if sign > 0 else 2))
    flow = np.array([7.3, 6.2]) * sign
    yy, xx = torch.meshgrid(torch.arange(Hb, dtype=torch.float32, device=dev),
                            torch.arange(Wb, dtype=torch.float32, device=dev), indexing="ij")
    shifted = pyramid.bilinear_sample(base, torch.stack([xx - flow[0], yy - flow[1]], dim=-1))
    dist = rng.uniform(6.0, 15.0, (n, 2))
    pts = rng.uniform(20.0, [Wb - 20.0, Hb - 20.0], (n, 2))
    near = np.where(sign > 0, [Wb - 1.0, Hb - 1.0] - dist, dist)
    pts[: n // 2, 0] = near[: n // 2, 0]
    pts[n // 2 :, 1] = near[n // 2 :, 1]
    pred = pts + flow + rng.uniform(-0.4, 0.4, (n, 2))
    f32 = dict(dtype=torch.float32, device=dev)
    return (pyramid.build_pyramid(base), pyramid.build_pyramid(shifted), torch.tensor(pts, **f32),
            torch.tensor(pred, **f32), torch.ones(n, dtype=torch.bool, device=dev))


def check_clahe(kclahe, tag, tables):
    """K3 against its plain version on ``tables``: >= 99.9 % of pixels within
    1e-3 gray and none off by more than 1e-2. Returns (max error, output)."""
    out_k = kclahe.clahe_apply(*tables)
    d = (out_k - kclahe.clahe_apply_plain(*tables)).abs()
    frac, worst = float((d <= 1e-3).float().mean()), float(d.max())
    print(f"[kernel] clahe_apply {tag} {tuple(out_k.shape)}: {frac:.6f} of pixels within "
          f"1e-3 gray, max {worst:.3g}")
    assert frac >= 0.999 and worst <= 1e-2, f"K3 clahe_apply {tag}"
    return worst, out_k


def check_lk(torch, klk, tag, args, directions, min_joint):
    """K1 against its plain version: the status flags agree on >= 99 % of the
    slots, >= ``min_joint`` slots are tracked by both, and their endpoints
    agree within 1e-3 px in the median. Returns (max endpoint difference,
    the plain endpoints)."""
    (fk, ok_k), (fp, ok_p) = (klk.lk_pyr(*args, directions=directions),
                              klk.lk_pyr_plain(*args, directions=directions))
    agree = float((ok_k == ok_p).float().mean())
    both = ok_k & ok_p
    e = torch.linalg.vector_norm(fk[both] - fp[both], dim=1)
    med = float(e.median()) if e.numel() else float("nan")
    print(f"[kernel] lk_pyr {tag}, {directions} direction(s): ok agree {agree:.4f}, "
          f"jointly ok {int(both.sum())}, median endpoint diff {med:.2e} px")
    assert agree >= 0.99 and e.numel() >= min_joint and (not e.numel() or med < 1e-3), f"K1 {tag} {directions}"
    return (float(e.max()) if e.numel() else 0.0), fp


def check_subpix(torch, ksubpix, tag, args):
    """K2 against its plain version: over the valid corners the refined
    points agree within 1e-3 px in the median and within 0.05 px for >= 99 %,
    the step counts are equal for >= 99 %, and invalid slots stay put.
    Returns (max difference, plain output, plain step counts)."""
    valid_s = args[2]
    iters_k, steps_p = (torch.zeros(valid_s.shape, dtype=torch.int32, device=args[0].device) for _ in range(2))
    out_k = ksubpix.subpix(*args, iters=iters_k)
    out_p = ksubpix.subpix_plain(*args, steps=steps_p)
    e = torch.linalg.vector_norm(out_k - out_p, dim=-1)[valid_s]
    assert e.numel() > 0, f"K2 {tag}: no valid corner"
    med, within = float(e.median()), float((e <= 0.05).float().mean())
    same = float((iters_k == steps_p)[valid_s].float().mean())
    print(f"[kernel] subpix {tag} {tuple(args[1].shape)}: median diff {med:.2e} px, within "
          f"0.05 px {within:.4f}, max {float(e.max()):.2e}; steps equal to the plain count "
          f"{same:.4f} ({int(steps_p.sum())} plain steps, longest {int(steps_p.max())})")
    assert med < 1e-3 and within >= 0.99 and same >= 0.99, f"K2 subpix {tag}"
    assert torch.equal(out_k[~valid_s], args[1][~valid_s]), f"K2 {tag}: invalid slots moved"
    return float(e.max()), out_p, steps_p


SUBPIX_CASES = ("border", "guard", "interior", "invalid")


def subpix_edge_set(height, width, seed, spacing=40):
    """A seeded image and corner table that drive K2 through its border and
    divergence paths. Gaussian blobs (sigma 2.5 px, +-80 gray) over the
    band-limited texture of ``render``:

    - ``border``: a blob centred 0-8 px inside each edge every ``spacing``
      px along it; its corner lies 0-8 px from that edge (clip-shifted
      slices), within 1.5 px of the blob's centre or 6-9 px from it along
      the edge;
    - ``guard`` / ``interior``: blobs on a jittered grid ``spacing`` +- 4
      px apart and from the edges, alternately with a corner 6-9 px from the
      centre (the refinement climbs toward the centre in steps clipped to
      +-1 px and ends >= 5 px away: the divergence guard) or within 1.5 px
      of it (kept);
    - ``invalid``: every 16th slot of the above, flagged invalid.

    Returns (img (H, W) f32, corners (N, 2) f32 xy, valid (N,) bool,
    kind (N,) str), all numpy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    img = 90.0 + 15.0 * np.sin(xx / (29.0 * width / 320)) * np.sin(yy / (31.0 * height / 240))
    centres, corners, kinds = [], [], []

    def near_or_flank(n, far, axis):
        """Offsets from a blob centre: within 1.5 px, or (where ``far``)
        6-9 px along ``axis`` (0: x, 1: y; None: any direction)."""
        off = rng.uniform(-1.5, 1.5, (n, 2))
        r = rng.uniform(6.0, 9.0, n) * rng.choice([-1.0, 1.0], n)
        if axis is None:
            a = rng.uniform(0.0, 2 * np.pi, n)
            flank = np.stack([r * np.cos(a), r * np.sin(a)], axis=1)
        else:
            flank = np.zeros((n, 2))
            flank[:, axis] = r
        return np.where(far[:, None], flank, off)

    for edge in range(4):  # left, right, top, bottom
        along_len = height if edge < 2 else width
        along = np.arange(spacing / 2, along_len - spacing / 2, spacing)
        n = len(along)
        depth = rng.uniform(0.0, 8.0, n)                # blob centre from the edge
        inward = depth if edge % 2 == 0 else (width if edge < 2 else height) - 1.0 - depth
        c = np.stack([inward, along], 1) if edge < 2 else np.stack([along, inward], 1)
        p = c + near_or_flank(n, np.arange(n) % 2 == 1, 1 if edge < 2 else 0)
        perp = 0 if edge < 2 else 1                     # the corner too lies 0-8 px inside
        lim = width if edge < 2 else height
        lo, hi = (0.0, 8.0) if edge % 2 == 0 else (lim - 9.0, lim - 1.0)
        p[:, perp] = np.clip(p[:, perp], lo, hi)
        centres.append(c)
        corners.append(p)
        kinds += ["border"] * n
    gx = np.arange(spacing, width - spacing + 1, spacing, dtype=np.float64)
    gy = np.arange(spacing, height - spacing + 1, spacing, dtype=np.float64)
    c = np.stack(np.meshgrid(gx, gy), -1).reshape(-1, 2) + rng.uniform(-4.0, 4.0, (len(gx) * len(gy), 2))
    far = np.arange(len(c)) % 2 == 0
    centres.append(c)
    corners.append(c + near_or_flank(len(c), far, None))
    kinds += ["guard" if f else "interior" for f in far]
    centres = np.concatenate(centres)
    amps = 80.0 * np.where(np.arange(len(centres)) % 2 == 0, 1.0, -1.0)
    rad = np.arange(-10, 11)
    for (x, y), a in zip(centres, amps):
        ys = np.unique(np.clip(int(round(y)) + rad, 0, height - 1))
        xs = np.unique(np.clip(int(round(x)) + rad, 0, width - 1))
        blob = np.exp(-((xs[None, :] - x) ** 2 + (ys[:, None] - y) ** 2) / (2 * 2.5**2))
        img[np.ix_(ys, xs)] += a * blob
    kind = np.array(kinds)
    valid = np.arange(len(kind)) % 16 != 5
    kind[~valid] = "invalid"
    return (np.clip(img, 0, 255).astype(np.float32), np.concatenate(corners).astype(np.float32),
            valid, kind)


def subpix_paths(torch, corners, valid, out, steps, W, H, half=5):
    """How many valid corners of a plain run took the clip-shifted slice at
    their first step, and how many the divergence guard sent back: they
    took more than one step (so the first one moved them) and their output
    is their input."""
    ix, iy = torch.floor(corners[:, 0]).long() - (half + 1), torch.floor(corners[:, 1]).long() - (half + 1)
    clipped = valid & ((ix < 0) | (ix > W - (2 * half + 4)) | (iy < 0) | (iy > H - (2 * half + 4)))
    rejected = valid & (steps > 1) & (out == corners).all(dim=1)
    return clipped, rejected


# --------------------------------------------------------------------------
# phase 6: the GNSS/INS replay (GinsModel) on a seeded synthetic drive
# --------------------------------------------------------------------------

GINS_RAW = dict(initlength=3, imudatarate=200, iswithearth=True,
                imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0),
                gnssthreshold=20, optimize_windows_size=10, preint_samples=512)
# The drive: 4 s still, 2 s accelerating, then a coordinated turn; 90 s, cut
# from 300 s because the replay is host-bound on the card (~0.45 s an epoch),
# and the phase must stay near 90 s.
GINS_SECONDS = 90.0
GINS_GAP = (45.0, 53.0)          # fixes dropped inside: 8 s = 1600 samples > 512
GINS_TIMED_SECONDS = 40.0        # the stage-timed second run: the drive's first 40 s
GINS_PROFILED = (20, 30)         # its epochs [20, 30) run under torch.profiler
GINS_BG = (0.002, -0.001, 0.0005)
GINS_CUDA_CPU_TOL = 1e-9         # m: node positions, CUDA against CPU (measured <= 5e-12 m)


def gins_world(rate=200.0, bg_true=GINS_BG, ba_true=(0.01, -0.02, 0.03), gnss_noise=0.01,
               gnss_std=0.02, lever=(-0.3, 0.01, 0.35), origin_deg=(30.5, 114.3, 40.0), seed=0,
               with_odo=False, odo_scale_err=0.01, odo_noise=0.02, turn_duration=18.0, with_earth=False):
    """A seeded GNSS/INS drive with ground truth, the world of
    tests/gins_data.py:make_gins_dataset built from the port on the CPU in
    f64: 4 s stationary, 2 s accelerating at 1.3 m/s^2, then a coordinated
    turn (0.05 rad/s) with motion-correlated vibration; gravity from
    ``earth.gravity(origin)``; with earth rate, the gyro senses it through
    the truth attitude (fixed point by iteration); truth is the port's
    mechanization of the bias-free increments; the measured increments carry
    the biases and white noise at 0.1 deg/sqrt(hr) and 0.1 m/s/sqrt(hr);
    with the odometer, wheel distance increments (the true body-x velocity a
    sample, scaled by 1 - ``odo_scale_err``, plus white noise); GNSS at whole
    seconds, the antenna through the lever arm plus noise.
    Returns (imu_data, gnss_data, truth) numpy dicts, as the generator
    there."""
    import torch

    from ic_gvins_tpu_torch.core import earth
    from ic_gvins_tpu_torch.core import quaternion as quat
    from ic_gvins_tpu_torch.core.types import ImuBatch, NavState
    from ic_gvins_tpu_torch.ins import mechanization as mech

    t64 = lambda a: torch.tensor(np.asarray(a, np.float64))  # noqa: E731
    origin = np.array([np.deg2rad(origin_deg[0]), np.deg2rad(origin_deg[1]), origin_deg[2]])
    g = float(earth.gravity(t64(origin)))
    dt = 1.0 / rate
    segs = [(4.0, np.zeros(3), np.array([0, 0, -g]), False),
            (2.0, np.zeros(3), np.array([1.3, 0, -g]), True),
            (turn_duration, np.array([0, 0, 0.05]), np.array([0.0, 0.13, -g]), True)]
    w_list, f_list, t_off = [], [], 0.0
    for dur, w, f, moving in segs:
        n = int(round(dur * rate))
        ts = t_off + dt * np.arange(n)
        wseg, fseg = np.tile(w, (n, 1)).astype(float), np.tile(f, (n, 1)).astype(float)
        if moving:  # vibration, so the zero-velocity detector sees motion
            wseg += 0.02 * np.sin(2 * np.pi * 2.0 * ts)[:, None] * np.array([1.0, 0.5, 0.8])
            fseg += 0.4 * np.sin(2 * np.pi * 1.3 * ts)[:, None] * np.array([0.6, 1.0, 0.7])
        w_list.append(wseg)
        f_list.append(fseg)
        t_off += dur
    w, f = np.concatenate(w_list), np.concatenate(f_list)
    n = len(w)
    t = dt * (np.arange(n) + 1)

    iewn = np.zeros(3)
    if with_earth:
        iewn = earth.iewn(t64(origin), torch.zeros(3, dtype=torch.float64)).numpy()
    cfg = mech.MechConfig(gravity=t64([0, 0, g]), iewn=t64(iewn), iswithearth=with_earth)
    dtheta_true = w * dt
    q_true = np.tile(np.array([0.0, 0, 0, 1.0]), (n, 1))
    for _ in range(3 if with_earth else 1):
        if with_earth:  # the earth rate seen through the attitude at each interval's start
            q_prev = np.concatenate([[[0, 0, 0, 1.0]], q_true[:-1]])
            dtheta_true = w * dt + quat.rotate(quat.conj(t64(q_prev)), t64(iewn)).numpy() * dt
        imu_true = ImuBatch(time=t64(t), dt=t64(np.full(n, dt)), dtheta=t64(dtheta_true), dvel=t64(f * dt),
                            odovel=torch.zeros(n, dtype=torch.float64))
        _, traj = mech.mechanize_scan(cfg, NavState.identity(), imu_true)
        p_true, q_true, v_true = (x.numpy() for x in traj)

    rng = np.random.default_rng(seed)
    arw, vrw = 0.1 * np.pi / 180.0 / 60.0, 0.1 / 60.0
    dtheta_m = dtheta_true + np.asarray(bg_true) * dt + rng.normal(0, arw * np.sqrt(dt), (n, 3))
    dvel_m = (f + np.asarray(ba_true)) * dt + rng.normal(0, vrw * np.sqrt(dt), (n, 3))
    odovel = np.zeros(n)
    if with_odo:   # vehicle frame = body frame (abv = 0, lodo = 0)
        v_body_x = np.einsum("ij,ij->i", v_true, quat.to_matrix(t64(q_true)).numpy()[:, :, 0])
        odovel = v_body_x * dt * (1.0 - odo_scale_err) + rng.normal(0, odo_noise * np.sqrt(dt), n)
    imu_data = dict(time=t, dt=np.full(n, dt), dtheta=dtheta_m, dvel=dvel_m, odovel=odovel)

    gt_times = np.arange(1.0, t[-1], 1.0)
    i = np.round(gt_times * rate).astype(int) - 1
    lever = np.asarray(lever, np.float64)
    gnss_local = p_true[i] + quat.rotate(t64(q_true[i]), t64(lever)).numpy() + rng.normal(0, gnss_noise, (len(i), 3))
    gnss_blh = earth.local2global(t64(origin), t64(gnss_local)).numpy()
    gnss_data = dict(time=gt_times, blh=gnss_blh, std=np.full((len(gt_times), 3), gnss_std))
    truth = dict(time=t, p=p_true, q=q_true, v=v_true, origin=origin, lever=lever, gnss_local=gnss_local,
                 iewn=iewn)
    return imu_data, gnss_data, truth


# tests/test_gins_e2e.py::test_earth_odo_replay: EARTH_ODO with the wheel
# odometer, tight forward and loose lateral/vertical (the world has real
# sideslip the wheel cannot observe)
ODO_RAW = dict(GINS_RAW, optimize_windows_size=10, isuseodo=True,
               odometer=dict(std=[0.02, 0.5, 0.5], srw=1000.0, abv=[0.0, 0.0, 0.0], lodo=[0.0, 0.0, 0.0]))
ODO_SCALE_ERR = 0.01


def yaml_text(raw):
    """A gvins.yaml text of the config dict ``raw`` in the reference's
    layout: scalars, flow lists, ``imumodel`` as a flow map, ``cam0`` and
    ``odometer`` as block maps."""
    def scalar(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        return "~" if v is None else repr(v) if isinstance(v, float) else str(v)

    def flow(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return "[" + ", ".join(scalar(float(x) if isinstance(x, np.floating) else x) for x in v) + "]"
        return scalar(v)

    lines = ["# gvins.yaml"]
    for key, v in raw.items():
        if isinstance(v, dict) and key in ("cam0", "odometer"):
            lines.append(f"{key}:")
            lines += [f"  {k}: {flow(x)}" for k, x in v.items()]
        elif isinstance(v, dict):
            lines.append(f"{key}: {{" + ", ".join(f"{k}: {flow(x)}" for k, x in v.items()) + "}")
        else:
            lines.append(f"{key}: {flow(v)}")
    return "\n".join(lines) + "\n"


def gins_config(parse_config, truth, with_earth=True):
    return parse_config(dict(GINS_RAW, iswithearth=with_earth, antlever=list(truth["lever"])))


def node_errors(traj, truth, rate=200.0):
    """(node times, |p - truth| at node times): the model's local frame is
    anchored at the first GNSS antenna fix, the truth's at its start."""
    off = truth["gnss_local"][0]
    idx = np.round(traj[:, 0] * rate).astype(int) - 1
    return traj[:, 0], np.linalg.norm(traj[:, 1:4] + off - truth["p"][idx], axis=1)


class StageTimer:
    """Synchronized host-clock timers around methods of classes (ms per call),
    installed and removed as a context; ``counts`` counts calls of the
    functions given in ``count``."""

    def __init__(self, torch, targets, count=()):
        self.torch, self.targets, self.count = torch, targets, count
        self.ms = {name: [] for _, name in targets}
        self.counts = {name: 0 for _, name in count}
        self._saved = []

    def __enter__(self):
        torch = self.torch
        for owner, name in self.targets:
            fn = getattr(owner, name)

            def timed(*args, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.ms[_name].append(1e3 * (time.perf_counter() - t0))
                return out
            self._saved.append((owner, name, fn))
            setattr(owner, name, timed)
        for owner, name in self.count:
            fn = getattr(owner, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                self.counts[_name] += 1
                return _fn(*args, **kw)
            self._saved.append((owner, name, fn))
            setattr(owner, name, counted)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


def device_activity(torch, prof, wall_ms):
    """(kernels, busy ms) of a finished torch.profiler session: the device
    kernels it recorded and the union of their and the copies' intervals,
    read from the raw trace (parsing it into FunctionEvents takes seconds
    per thousand events); (None, None) if it holds no device event."""
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is not None:
        dev = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3) for e in raw.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    else:
        dev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None
    spans = sorted((s, e) for _, s, e in dev)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    kernels = sum(1 for name, _, _ in dev if not name.lower().startswith(("memcpy", "memset")))
    return kernels, min(busy / 1e3, wall_ms)


def annotated_device_ms(torch, prof, prefix):
    """Device busy ms inside each ``torch.profiler.record_function`` span of
    a finished session whose name starts with ``prefix``: [(name, busy ms,
    span ms)] in start order, busy the union of the device kernels' and
    copies' intervals clipped to the span (the profiler puts both on one
    clock). Spans that end in a synchronize hold all their device work.
    The profiler mirrors each span onto the device's timeline (a
    "gpu_user_annotation" of the same name, from its first kernel to its
    last): those are not device work and are left out. None if the session
    holds no device event."""
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev = [], []
    for e in raw:
        s, d, named = e.start_ns(), e.duration_ns(), e.name().startswith(prefix)
        if e.device_type() == cuda:
            if not named:
                dev.append((s, s + d))
        elif named:
            spans.append((s, s + d, e.name()))
    if not dev:
        return None
    dev.sort()
    starts = np.array([s for s, _ in dev])
    out = []
    for s0, e0, name in sorted(spans):
        busy, cur = 0, None
        for s, e in dev[max(int(np.searchsorted(starts, s0)) - 64, 0):]:
            if s >= e0:
                break
            s, e = max(s, s0), min(e, e0)
            if e <= s:
                continue
            if cur is None or s > cur[1]:
                busy += 0 if cur is None else cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        busy += 0 if cur is None else cur[1] - cur[0]
        out.append((name, busy / 1e6, (e0 - s0) / 1e6))
    return out


def card_record(torch, device):
    """The run's device fields of a script's JSON line: the card's name and
    power limit (nvidia-smi), torch and CUDA versions; on the CPU the name
    is "cpu" and the power limit null."""
    rec = dict(device="cpu", power_limit_w=None, torch=torch.__version__, cuda=torch.version.cuda)
    if torch.device(device).type == "cuda":
        smi = nvidia_smi()
        rec.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                   power_limit_w=float(smi.rsplit(",", 1)[1].strip().split()[0]))
    return rec


def kernel_launches():
    """The three kernel wrappers' launch counters, by name."""
    from ic_gvins_tpu_torch.ops import clahe, lk, subpix

    return {"clahe_apply": clahe.clahe_apply.launches, "lk_pyr": lk.lk_pyr.launches,
            "subpix": subpix.subpix.launches}


def gins_phase(torch, card):
    """Phase 6: the port's GinsModel on the card at full size, its gates, its
    stage times, host reads, launches and busy share; then CUDA against the
    CPU on the 24 s world, earth off and on. Returns the first replay's
    model."""
    import tempfile

    from ic_gvins_tpu_torch.engine import estimator as est_mod
    from ic_gvins_tpu_torch.engine import replay as rep_mod
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.models import gins as gins_mod
    from ic_gvins_tpu_torch.solver import lm as lm_mod

    t_phase = t0 = time.perf_counter()
    imu, gnss, truth = gins_world(turn_duration=GINS_SECONDS - 6.0, with_earth=True, seed=SEED)
    keep = ~((gnss["time"] > GINS_GAP[0]) & (gnss["time"] < GINS_GAP[1]))
    gnss = {k: v[keep] for k, v in gnss.items()}
    print(f"[gins] world: {len(imu['time'])} IMU samples, {len(gnss['time'])} GNSS fixes "
          f"(gap {GINS_GAP}), made in {time.perf_counter() - t0:.2f} s on the CPU")
    cfg = gins_config(parse_config, truth)

    # run 1: the replay as a user runs it, output files written
    with tempfile.TemporaryDirectory() as outdir:
        model = gins_mod.GinsModel(cfg, outdir=outdir, device=DEVICE)
        assert model.device == torch.device(DEVICE)
        reads0 = fetch.reads
        with StageTimer(torch, [], count=[(lm_mod, "build_normal_blocks"),
                                          (gins_mod.GinsModel, "_process_gnss")]) as counter:
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            traj = model.run(imu, gnss)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t_run
        reads = fetch.reads - reads0
        nav = np.loadtxt(f"{outdir}/gvins.nav")
        trajcsv = np.loadtxt(f"{outdir}/trajectory.csv")
        imuerr = np.fromfile(f"{outdir}/IMU_ERR.bin", dtype=np.float64)
    epochs = counter.counts["_process_gnss"]
    sim_s = float(imu["time"][-1] - imu["time"][0])
    print(f"[gins] replay {sim_s:.0f} s simulated in {t_run:.3f} s wall: {sim_s / t_run:.2f} sim-s per "
          f"wall-s; {epochs} epochs, {len(traj)} trajectory nodes ({card})")
    print(f"[gins] per epoch: {counter.counts['build_normal_blocks'] / epochs:.2f} LM iterations, "
          f"{reads / epochs:.2f} host reads ({reads} reads in the run) ({card})")

    # gates
    assert model.state == "INITIALIZING_INS", model.state
    times, err = node_errors(traj, truth)
    inside = (times > GINS_GAP[0]) & (times <= GINS_GAP[1] + 10.0)
    steady = ~inside & (np.arange(len(times)) >= 2)
    after = (times >= GINS_GAP[1] + 10.0)
    post = err[after][:4]
    bg = model.est.mixes[model.est.n_nodes - 1, 3:6]
    print(f"[gins] node position error vs truth: mean {err[steady].mean():.4f} m, max {err[steady].max():.4f} m "
          f"over {int(steady.sum())} nodes outside the gap and the 10 s after it; the 4 epochs from "
          f"{GINS_GAP[1] + 10.0:.0f} s: mean {post.mean():.4f} m; gyro bias {bg} (truth {GINS_BG})")
    assert err[steady].mean() < 0.08 and err[steady].max() < 0.30, "GINS accuracy outside the gap"
    assert len(post) == 4 and post.mean() < 0.15, "GINS accuracy after the gap"
    np.testing.assert_allclose(bg[:2], GINS_BG[:2], atol=1e-3, err_msg="gyro bias x/y")
    # a row per 10 IMU samples from the alignment on (~4 s): >= 10 a second
    assert nav.shape[1] == 11 and len(nav) >= 10 * (sim_s - 6.0) and abs(nav[0, 2] - 30.5) < 0.01, nav.shape
    assert trajcsv.shape[1] == 8 and len(imuerr) % 8 == 0 and len(imuerr) > 0
    print(f"[gins] outputs: gvins.nav {nav.shape}, trajectory.csv {trajcsv.shape}, IMU_ERR.bin "
          f"{len(imuerr) // 8} records of 8 doubles")

    # run 2: the drive's first GINS_TIMED_SECONDS, each stage synchronized on
    # both sides; epochs GINS_PROFILED under the profiler
    stages = [(rep_mod.InsPropagator, "propagate_to"), (est_mod.SlidingWindowEstimator, "optimize"),
              (est_mod.SlidingWindowEstimator, "reintegrate_if_needed"),
              (est_mod.SlidingWindowEstimator, "marginalize")]
    from torch.profiler import ProfilerActivity, profile

    process = gins_mod.GinsModel._process_gnss
    calls, prof = [0], {}

    def profiled(self, stream, g):
        """Epochs GINS_PROFILED[0] .. GINS_PROFILED[1]-1 in one profiler session."""
        calls[0] += 1
        if calls[0] == GINS_PROFILED[0]:
            torch.cuda.synchronize()
            prof["session"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof["session"].__enter__()
            prof["t0"] = time.perf_counter()
        out = process(self, stream, g)
        if calls[0] == GINS_PROFILED[1] - 1:
            torch.cuda.synchronize()
            prof["wall"] = 1e3 * (time.perf_counter() - prof["t0"])
            prof["session"].__exit__(None, None, None)
        return out

    n_imu = int(np.searchsorted(imu["time"], GINS_TIMED_SECONDS, side="right"))
    gins_mod.GinsModel._process_gnss = profiled
    try:
        with StageTimer(torch, stages) as timer:
            gins_mod.GinsModel(cfg, device=DEVICE).run({k: v[:n_imu] for k, v in imu.items()},
                                                       {k: v[gnss["time"] <= GINS_TIMED_SECONDS]
                                                        for k, v in gnss.items()})
    finally:
        gins_mod.GinsModel._process_gnss = process
    print(f"[gins] second run, the first {GINS_TIMED_SECONDS:.0f} s of the drive, each stage synchronized:")
    for (_, name) in stages:
        ms = np.asarray(timer.ms[name])
        print(f"[gins] {name}: {len(ms)} calls, median {np.median(ms):.3f} ms, p90 "
              f"{np.percentile(ms, 90):.3f} ms (synchronized on both sides) ({card})")
    assert "wall" in prof, f"the timed run has {calls[0]} epochs, fewer than GINS_PROFILED {GINS_PROFILED}"
    n_prof = GINS_PROFILED[1] - GINS_PROFILED[0]
    kernels, busy = device_activity(torch, prof["session"], prof["wall"])
    if kernels is None:
        print("[gins] profiler: no device events in the trace; launches and busy share not measured")
    else:
        print(f"[gins] profiler, epochs {GINS_PROFILED[0]}-{GINS_PROFILED[1] - 1}: {kernels / n_prof:.0f} CUDA "
              f"kernels per epoch, device busy {busy:.2f} of {prof['wall']:.2f} ms = "
              f"{100 * busy / prof['wall']:.1f} % ({card})")

    # CUDA against the CPU on the 24 s world
    for with_earth in (False, True):
        imu_s, gnss_s, truth_s = gins_world(with_earth=with_earth, seed=SEED)
        cfg_s = gins_config(parse_config, truth_s, with_earth)
        runs, secs = {}, {}
        for device in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            m = gins_mod.GinsModel(cfg_s, device=device)
            tr = m.run(imu_s, gnss_s)
            runs[device], secs[device] = (m.state, tr), time.perf_counter() - t0
        (sg, tg), (sc, tc) = runs[DEVICE], runs["cpu"]
        assert sg == sc == "INITIALIZING_INS" and tg.shape == tc.shape, (sg, sc, tg.shape, tc.shape)
        assert np.array_equal(tg[:, 0], tc[:, 0]), "node times differ"
        dp = float(np.abs(tg[:, 1:4] - tc[:, 1:4]).max())
        print(f"[gins] 24 s world, earth {'on' if with_earth else 'off'}: CUDA and CPU {len(tg)} nodes, "
              f"same times, max position difference {dp:.3g} m ({secs[DEVICE]:.1f} s and "
              f"{secs['cpu']:.1f} s wall)")
        assert dp < GINS_CUDA_CPU_TOL, f"CUDA and CPU differ by {dp} m"
    odo_replay(torch, card)
    print(f"[gins] phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return model


def odo_replay(torch, card):
    """Phase 6's odometer run: tests/test_gins_e2e.py::test_earth_odo_replay
    on the card, its configuration written as a gvins.yaml text and read back
    with the port's load_config; that test's gates."""
    import tempfile

    from ic_gvins_tpu_torch.engine.config import load_config
    from ic_gvins_tpu_torch.models import gins as gins_mod

    imu, gnss, truth = gins_world(with_earth=True, with_odo=True, odo_scale_err=ODO_SCALE_ERR, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gvins.yaml")
        with open(path, "w") as f:
            f.write(yaml_text(dict(ODO_RAW, antlever=list(truth["lever"]))))
        cfg = load_config(path)
    assert cfg.isuseodo and cfg.iswithearth and cfg.odometer.std == [0.02, 0.5, 0.5]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = gins_mod.GinsModel(cfg, device=DEVICE)
    traj = model.run(imu, gnss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, err = node_errors(traj[2:], truth)
    k = model.est.n_nodes - 1
    sodo = float(model.est.mixes[k, 9])
    sim_s = float(imu["time"][-1] - imu["time"][0])
    print(f"[odo] EARTH_ODO replay, {sim_s:.0f} s simulated in {wall:.3f} s wall ({sim_s / wall:.2f} sim-s per "
          f"wall-s; {len(traj)} nodes, state {model.state}) ({card})")
    print(f"[odo] mix blocks {model.est.mixes.shape[1]} (limit == 10); node error mean {err.mean():.4f} m "
          f"(limit < 0.08); odometer scale {sodo:.5f} (limits {0.2 * ODO_SCALE_ERR:.4f} .. "
          f"{3.0 * ODO_SCALE_ERR:.4f}, injected {ODO_SCALE_ERR})")
    assert model.est.wcfg.with_odo and model.est.mixes.shape[1] == 10
    assert err.mean() < 0.08, f"odometer replay mean error {err.mean()}"
    assert 0.2 * ODO_SCALE_ERR < sodo < 3.0 * ODO_SCALE_ERR, f"odometer scale {sodo}"


# --------------------------------------------------------------------------
# phase 7: the GNSS-visual-inertial replay (GvinsModel) on a rendered world
# --------------------------------------------------------------------------

# The drive of phase 6's world, 4 s still, 2 s accelerating, then turning at
# 2.6 m/s; cut to 30 s because a keyframe episode costs a fraction of a
# second of host time on the card and the phase must stay near 120 s.
GVINS_SECONDS = 30.0
GVINS_BLOB = (2.5, 8)            # blob sigma and half-width (px) at 1278x1022
GVINS_DENSITY = 0.8              # blobs per m^2 of ground, 9-13 m below the body
GVINS_PROFILED = (30, 33)        # keyframe episodes [30, 33) run under torch.profiler
GVINS_CUDA_CPU_TOL = 1e-3        # m: node positions, CUDA against CPU on the small world
GVINS_TWIN_CORES = 4             # the CPU twin's cores and torch threads (a child process)
# production widths (the GvinsConfig defaults), extrinsic and td estimation
# off: the planar drive observes them weakly (tests/test_gvins_e2e.py:55-58)
GVINS_RAW = dict(GINS_RAW, optimize_windows_size=10, node_slots=24, landmark_slots=512, gnss_slots=24,
                 reproj_slots=2048, preint_samples=512, optimize_num_iterations=20, track_max_features=200,
                 optimize_estimate_extrinsic=False, optimize_estimate_td=False, track_min_parallax=20,
                 track_max_interval=0.5, reprojection_error_std=1.5, is_use_visualization=False)
# tests/test_gvins_e2e.py's world and configuration: 320x240, earth off
SMALL_CAMERA = ([250.0, 250.0, 160.0, 120.0], [-0.05, 0.01, 0.0, 0.0], [320, 240])
SMALL_BLOB = (1.8, 6)
SMALL_RAW = dict(GVINS_RAW, iswithearth=False, optimize_windows_size=8, node_slots=20, landmark_slots=256,
                 gnss_slots=20, reproj_slots=1024, track_max_features=120)


def gvins_raw(truth, raw, camera_cfg):
    """The configuration dict ``raw`` with the drive's lever arm and the
    camera ``camera_cfg`` (intrinsic, distortion, resolution) at the body,
    its clock believed in step (td_b_c 0)."""
    intrinsic, distortion, resolution = camera_cfg
    return dict(raw, antlever=list(truth["lever"]), cam0=dict(
        intrinsic=intrinsic, distortion=distortion, resolution=resolution,
        q_b_c=[0.0, 0.0, 0.0, 1.0], t_b_c=[0.0, 0.0, 0.0], td_b_c=0.0))   # camera = body (FRD, z down)


def gvins_config(parse_config, truth, raw, camera_cfg):
    return parse_config(gvins_raw(truth, raw, camera_cfg))


def ground_frame(cam_mod, camera, pts_w, Rcw, tcw, sigma, half):
    """A grayscale frame of ``pts_w`` seen from camera pose (Rcw, tcw):
    Gaussian blobs of alternating sign (+-80 gray, ``sigma`` px, cut at
    ``half`` px) at the DISTORTED projections of the points more than 1 m in
    front, over a flat background (90 gray). The renderer of
    tests/test_gvins_e2e.py (sigma 1.8, half 6 there). The background is flat:
    an image-fixed texture tracks as phantom zero-flow features that no 3D
    point explains, and corrupts the bundle adjustment."""
    width, height = camera.width, camera.height
    img = np.full((height, width), 90.0)
    pc = (pts_w - tcw) @ Rcw
    valid = pc[:, 2] > 1.0
    if valid.any():
        dis = cam_mod.distort_points(camera, cam_mod.cam2pixel(camera, pc[valid]))
        amps = 80.0 * np.where(np.arange(len(pts_w)) % 2 == 0, 1.0, -1.0)[valid]
        inb = (dis[:, 0] > -5) & (dis[:, 0] < width + 5) & (dis[:, 1] > -5) & (dis[:, 1] < height + 5)
        for (x, y), a in zip(dis[inb], amps[inb]):
            x0, x1 = max(int(x) - half, 0), min(int(x) + half + 1, width)
            y0, y1 = max(int(y) - half, 0), min(int(y) + half + 1, height)
            if x1 > x0 and y1 > y0:
                xs = np.arange(x0, x1, dtype=np.float64)[None, :]
                ys = np.arange(y0, y1, dtype=np.float64)[:, None]
                img[y0:y1, x0:x1] += a * np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * sigma**2))
    return np.clip(img, 0, 255)


def e2e_scene():
    """The ground scene of tests/test_gvins_e2e.py: 800 points 9-13 m below
    the drive of the 24 s world."""
    rng = np.random.default_rng(42)
    return np.stack([rng.uniform(-10, 55, 800), rng.uniform(-25, 25, 800), rng.uniform(9, 13, 800)], axis=1)


def ground_scene(truth, seed, density=GVINS_DENSITY, margin=12.0):
    """Points 9-13 m below the drive, ``density`` per m^2 over the drive's
    horizontal extent plus ``margin`` m (the camera sees ~16 x 13 m of
    ground at 10 m with the KAIST intrinsics)."""
    lo, hi = truth["p"][:, :2].min(axis=0) - margin, truth["p"][:, :2].max(axis=0) + margin
    n = int(density * np.prod(hi - lo))
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n), rng.uniform(9.0, 13.0, n)], axis=1)


def gvins_frames(cam_mod, rot_np, camera, truth, pts_w, blob, rate=200.0, dtype=np.float64):
    """Frames at 10 Hz from 0.05 s to 0.2 s before the drive's end, the
    camera at the true body pose (camera = body): (times, images)."""
    frame_times = np.arange(0.05, truth["time"][-1] - 0.2, 0.1)
    images = []
    for t in frame_times:
        i = min(int(round(t * rate)) - 1, len(truth["p"]) - 1)
        images.append(ground_frame(cam_mod, camera, pts_w, rot_np.to_matrix(truth["q"][i]), truth["p"][i],
                                   *blob).astype(dtype))
    return frame_times, images


class FrameLog:
    """Wraps ``GvinsModel._process_frame`` while installed as a context: per
    processed frame its host reads (``fetch.reads``), whether it ran a
    keyframe episode, its wall seconds, the model's state and node count
    after it, and the frame's stamp; optionally a torch.profiler session over keyframe episodes
    ``profiled`` = (first, end)."""

    def __init__(self, torch, gvins_mod, fetch, profiled=None):
        self.torch, self.cls, self.fetch, self.profiled = torch, gvins_mod.GvinsModel, fetch, profiled
        self.rows, self.prof, self.prof_wall_ms, self.prof_frames_s = [], None, None, 0.0

    def __enter__(self):
        torch, fetch, process = self.torch, self.fetch, self.cls._process_frame
        self._process = process

        def logged(model, *args):
            episodes = sum(model.tier_counts.values())
            if self.profiled and episodes == self.profiled[0] and self.prof is None:
                torch.cuda.synchronize()
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self._t_prof = time.perf_counter()
            r0, t0 = fetch.reads, time.perf_counter()
            out = process(model, *args)
            ran = sum(model.tier_counts.values()) - episodes
            self.rows.append((fetch.reads - r0, ran, time.perf_counter() - t0, model.state, model.est.n_nodes,
                              float(args[1])))
            if self.prof is not None and self.prof_wall_ms is None:
                self.prof_frames_s += self.rows[-1][2]
                if sum(model.tier_counts.values()) >= self.profiled[1]:
                    torch.cuda.synchronize()
                    self.prof_wall_ms = 1e3 * (time.perf_counter() - self._t_prof)
                    self.prof.__exit__(None, None, None)
            return out
        self.cls._process_frame = logged
        return self

    def __exit__(self, *exc):
        self.cls._process_frame = self._process
        if self.prof is not None and self.prof_wall_ms is None:   # the run ended inside the window
            self.prof.__exit__(None, None, None)
            self.prof = None

    def states(self):
        return [(r[3], r[4]) for r in self.rows]


def pct(a, q):
    return float(np.percentile(np.asarray(a, np.float64), q)) if len(a) else float("nan")


def gvins_small_run(device, cores=None):
    """The port's GvinsModel on tests/test_gvins_e2e.py's 320x240 world over
    the 24 s drive (earth off) on ``device``: (the state and node count after
    every processed frame, the trajectory, the tier counts, the final state,
    wall seconds). With ``cores``, it keeps to the host's last ``cores``
    cores with as many torch threads (the CPU twin, in a child process)."""
    import torch

    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.models import gvins as gvins_mod
    from ic_gvins_tpu_torch.vision import camera as cam

    if cores:
        allowed = sorted(os.sched_getaffinity(0))
        cores = min(cores, max(len(allowed) // 2, 1))
        os.sched_setaffinity(0, allowed[-cores:])
        torch.set_num_threads(cores)
    imu, gnss, truth = gins_world(with_earth=False, seed=SEED)
    small = cam.PinholeCamera.from_config(*SMALL_CAMERA)
    times, images = gvins_frames(cam, rotation_np, small, truth, e2e_scene(), SMALL_BLOB)
    cfg = gvins_config(parse_config, truth, SMALL_RAW, SMALL_CAMERA)
    t0 = time.perf_counter()
    with FrameLog(torch, gvins_mod, fetch) as log:
        model = gvins_mod.GvinsModel(cfg, device=device)
        traj = model.run(imu, gnss, times, lambda k: images[k])
    return log.states(), traj, model.tier_counts, model.state, time.perf_counter() - t0


def gvins_phase(torch, card, wrappers):
    """Phase 7: the port's GvinsModel on the card at the production widths
    on a 30 s rendered 1278x1022 drive (``gvins_replay``), then CUDA against
    the CPU on the small world of tests/test_gvins_e2e.py. The CPU twin is
    this script run again as a child process (``--gvins-cpu-twin``) from the
    phase's start, on cores of its own, so that it is done by the time the
    card's runs are; the child is killed however the phase ends. Returns the
    kernels' launches in the replay."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cpu_twin.pkl")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gvins-cpu-twin", out],
                                 stdout=sys.stderr)
        try:
            launches = gvins_replay(torch, card, wrappers)
            sg, tg, tiers_g, state_g, secs_g = gvins_small_run(DEVICE)
            t_wait = time.perf_counter()
            rc = child.wait(timeout=900)
            t_wait = time.perf_counter() - t_wait
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        assert rc == 0, f"the CPU twin exited with {rc}"
        with open(out, "rb") as f:
            sc, tc, tiers_c, state_c, secs_c = pickle.load(f)
    assert sg == sc, "state sequences differ"
    assert state_g == state_c == "TRACKING_NORMAL" and tiers_g == tiers_c, (state_g, state_c, tiers_g, tiers_c)
    assert tg.shape == tc.shape and np.array_equal(tg[:, 0], tc[:, 0]), "node times differ"
    dp = float(np.abs(tg[:, 1:4] - tc[:, 1:4]).max())
    print(f"[gvins] small world 320x240, 24 s: CUDA and CPU {len(sg)} frames with the same states, "
          f"{sum(tiers_g.values())} keyframe episodes, {len(tg)} nodes at the same times, max position "
          f"difference {dp:.3g} m ({secs_g:.1f} s wall on {DEVICE}; {secs_c:.1f} s on the CPU in the child "
          f"process with {GVINS_TWIN_CORES} threads, {t_wait:.1f} s of it waited for)")
    assert dp < GVINS_CUDA_CPU_TOL, f"CUDA and CPU differ by {dp} m"
    print(f"[gvins] phase 7 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def gvins_replay(torch, card, wrappers):
    """The port's GvinsModel on the card at the production widths on a 30 s
    rendered 1278x1022 drive: its gates (state, accuracy, landmarks, output
    schemas, the three kernels launched inside the replay, their counters
    zeroed just before it), wall time, per-episode LM iterations and host
    reads, stage medians, a profiler window. Returns the launches."""
    import tempfile

    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.models import gvins as gvins_mod
    from ic_gvins_tpu_torch.vision import camera as cam
    from ic_gvins_tpu_torch.vision import tracking as trk

    t0 = time.perf_counter()
    imu, gnss, truth = gins_world(turn_duration=GVINS_SECONDS - 6.0, with_earth=True, seed=SEED)
    camera = cam.PinholeCamera.from_config(KAIST_INTRINSIC, KAIST_DISTORTION, [W, H])
    pts_w = ground_scene(truth, SEED + 7)
    frame_times, images = gvins_frames(cam, rotation_np, camera, truth, pts_w, GVINS_BLOB, dtype=np.float32)
    cfg = gvins_config(parse_config, truth, GVINS_RAW, (KAIST_INTRINSIC, KAIST_DISTORTION, [W, H]))
    print(f"[gvins] world: {len(imu['time'])} IMU samples, {len(gnss['time'])} GNSS fixes, {len(frame_times)} "
          f"frames {W}x{H} of {len(pts_w)} ground blobs, made in {time.perf_counter() - t0:.2f} s on the CPU")

    track_ms, marg_ms = [], []
    track, marginalize = trk.Tracker.track, gvins_mod.GvinsModel._marginalize_visual

    def timed_track(self, *args):
        out = track(self, *args)
        track_ms.append(self.track_ms)
        return out

    def timed_marginalize(self):
        out = marginalize(self)
        marg_ms.append(self.timecosts[2])
        return out

    with tempfile.TemporaryDirectory() as outdir:
        model = gvins_mod.GvinsModel(cfg, outdir=outdir, device=DEVICE)
        assert model.device == torch.device(DEVICE) and model.tracker.device == torch.device(DEVICE)
        trk.Tracker.track, gvins_mod.GvinsModel._marginalize_visual = timed_track, timed_marginalize
        try:
            with FrameLog(torch, gvins_mod, fetch, GVINS_PROFILED) as log:
                for w in wrappers.values():
                    w.launches = 0
                reads0 = fetch.reads
                torch.cuda.synchronize()
                t_run = time.perf_counter()
                traj = model.run(imu, gnss, frame_times, lambda k: images[k])
                torch.cuda.synchronize()
                t_run = time.perf_counter() - t_run
                launches = {k: w.launches for k, w in wrappers.items()}
                reads = fetch.reads - reads0
        finally:
            trk.Tracker.track, gvins_mod.GvinsModel._marginalize_visual = track, marginalize
        load = lambda name: np.atleast_2d(np.loadtxt(f"{outdir}/{name}"))  # noqa: E731
        stats, tracking, nav = load("statistics.txt"), load("tracking.txt"), load("gvins.nav")
        n_mappoints = len(load("mappoint.txt")) if os.path.getsize(f"{outdir}/mappoint.txt") else 0

    sim_s = float(imu["time"][-1] - imu["time"][0])
    episodes = sum(model.tier_counts.values())
    ep_rows = [r for r in log.rows if r[1]]
    print(f"[gvins] replay {sim_s:.0f} s simulated in {t_run:.3f} s wall: {sim_s / t_run:.3f} sim-s per wall-s "
          f"({sim_s / (t_run - log.prof_frames_s):.3f} without the {log.prof_frames_s:.2f} s of the profiled "
          f"frames); images rendered beforehand; the small world's CPU twin ran alongside in a child process "
          f"on its own cores ({card})")
    print(f"[gvins] {len(log.rows)} frames tracked, {episodes} keyframe episodes, solver tiers "
          f"{model.tier_counts}, marginalization tiers {model.tier_counts_marg}, {len(marg_ms)} "
          f"marginalizations; {reads} host reads in the run")
    changes = [(i, s) for i, (s, _) in enumerate(log.states()) if i == 0 or s != log.states()[i - 1][0]]
    print(f"[gvins] state by processed frame: {changes}")
    print(f"[gvins] per episode (LM iterations pass 1, pass 2, host reads of its frame): "
          f"{[(int(a), int(b), r[0]) for (a, b), r in zip(stats[:, 8:10], ep_rows)]}")
    print(f"[gvins] host reads per frame: episode frames median {pct([r[0] for r in ep_rows], 50):.0f}, "
          f"other frames median {pct([r[0] for r in log.rows if not r[1]], 50):.0f}")
    for name, vals in (("track_ms", track_ms), ("pass-1 solve ms", stats[:, 10]),
                       ("pass-2 solve ms", stats[:, 11]), ("marginalization ms", marg_ms),
                       ("episode frame ms", [1e3 * r[2] for r in ep_rows]),
                       ("other frame ms", [1e3 * r[2] for r in log.rows if not r[1]])):
        print(f"[gvins] {name}: {len(vals)} values, median {pct(vals, 50):.3f}, p90 {pct(vals, 90):.3f} "
              f"({card})")
    if log.prof_wall_ms is None:
        print(f"[gvins] profiler: the run has {episodes} episodes, the window {GVINS_PROFILED} was not completed")
    else:
        kernels, busy = device_activity(torch, log.prof, log.prof_wall_ms)
        n_prof = GVINS_PROFILED[1] - GVINS_PROFILED[0]
        if kernels is None:
            print("[gvins] profiler: no device events in the trace; launches and busy share not measured")
        else:
            print(f"[gvins] profiler, episodes {GVINS_PROFILED[0]}-{GVINS_PROFILED[1] - 1} and the frames "
                  f"between: {kernels / n_prof:.0f} CUDA kernels per episode, device busy {busy:.2f} of "
                  f"{log.prof_wall_ms:.2f} ms = {100 * busy / log.prof_wall_ms:.1f} % ({card})")

    # gates
    times, err = node_errors(traj, truth)
    print(f"[gvins] state {model.state}; node position error vs truth over {len(err)} nodes: mean "
          f"{err.mean():.4f} m, max {err.max():.4f} m; {len(model.vmap.landmarks)} landmarks, "
          f"{len(model.vmap.keyframes)} keyframes in the map; launches in the replay {launches}")
    assert model.state == "TRACKING_NORMAL", model.state
    assert err.mean() < 0.12 and err.max() < 0.4, "GVINS accuracy"
    assert len(model.vmap.landmarks) >= 50, "fewer than 50 landmarks"
    assert all(n > 0 for n in launches.values()), f"a kernel was not launched in the replay: {launches}"
    assert stats.shape[1] == 15 and len(stats) >= 3 and np.median(stats[:, 6]) < 3.0, stats.shape
    assert tracking.shape[1] == 7 and nav.shape[1] == 11 and n_mappoints > 0
    print(f"[gvins] outputs: statistics.txt {stats.shape} (median mean reprojection error "
          f"{np.median(stats[:, 6]):.3f} px), tracking.txt {tracking.shape}, gvins.nav {nav.shape}, "
          f"mappoint.txt {n_mappoints} points")
    return launches


# --------------------------------------------------------------------------
# phase 8: the long fault world of tests/test_gvins_long_e2e.py, written to
# files and replayed through scripts/run_gvins_torch.py
# --------------------------------------------------------------------------

LONG_CAMERA = ([125.0, 125.0, 80.0, 60.0], [-0.05, 0.01, 0.0, 0.0], [160, 120])
LONG_BLOB = (1.6, 5)             # blob sigma and half-width (px) of that test's renderer
LONG_OUTAGE = (60.0, 75.0)       # GNSS fixes dropped
LONG_GLITCH = (45.0, 46.0)       # frames brightened x1.35 (the histogram gate)
LONG_BLACKOUT = (85.0, 86.5)     # featureless frames (TRACK_LOST and re-initialization)
# the configuration of tests/test_gvins_long_e2e.py: extrinsic and td
# estimation and the histogram gate on
LONG_RAW = dict(initlength=3, imudatarate=200, iswithearth=False,
                imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
                optimize_windows_size=8, optimize_num_iterations=20, optimize_estimate_extrinsic=True,
                optimize_estimate_td=True, track_check_histogram=True, track_min_parallax=20,
                track_max_interval=0.5, track_max_features=100, reprojection_error_std=1.5, node_slots=20,
                landmark_slots=256, gnss_slots=20, reproj_slots=1024)
# frames (previous, checked) whose kernels are held against the plain
# versions before the replay: a normal pair, a glitch frame, a blackout frame
LONG_CHECKED = {"normal": (299, 300), "glitch": (449, 450), "featureless": (849, 851)}
# the last frame the port on the CPU finishes on this world read back from
# the files before it refuses a window slide of more than marg_cap nodes, as
# the JAX package refuses such a slide (in memory both packages refuse after
# 41.55 s; tests/test_torch_long_e2e.py; ROADMAP R1)
LONG_REFUSED_AFTER = 40.25


def long_world(cam_mod, rot_np):
    """tests/test_gvins_long_e2e.py's world without jax: the 120 s drive of
    ``gins_world(turn_duration=114.0)`` (earth off, 200 Hz), its GNSS fixes
    in LONG_OUTAGE dropped, 6000 ground points 9-13 m below from
    default_rng(7), frames at 10 Hz of the 160x120 camera (FX 125, radtan
    [-0.05, 0.01, 0, 0]) at the true body pose, flat in LONG_BLACKOUT and
    brightened x1.35 in LONG_GLITCH. Returns (imu, gnss, truth, frame_times,
    frame) with frame(k) the (H, W) f64 image of frame k."""
    imu, gnss, truth = gins_world(turn_duration=114.0, seed=SEED)
    keep = ~((gnss["time"] >= LONG_OUTAGE[0]) & (gnss["time"] < LONG_OUTAGE[1]))
    gnss = {k: v[keep] for k, v in gnss.items()}
    rng = np.random.default_rng(7)
    pts_w = np.stack([rng.uniform(-80, 140, 6000), rng.uniform(-80, 140, 6000), rng.uniform(9, 13, 6000)], axis=1)
    camera = cam_mod.PinholeCamera.from_config(*LONG_CAMERA)
    frame_times = np.arange(0.05, imu["time"][-1] - 0.2, 0.1)

    def frame(k):
        t = frame_times[k]
        if LONG_BLACKOUT[0] <= t < LONG_BLACKOUT[1]:
            return np.full((camera.height, camera.width), 90.0)
        i = min(int(round(t * 200.0)) - 1, len(truth["p"]) - 1)
        img = ground_frame(cam_mod, camera, pts_w, rot_np.to_matrix(truth["q"][i]), truth["p"][i], *LONG_BLOB)
        if LONG_GLITCH[0] <= t < LONG_GLITCH[1]:
            img = np.clip(img * 1.35, 0, 255)
        return img
    return imu, gnss, truth, frame_times, frame


def write_world_files(root, imu, gnss, frame_times, frame, raw):
    """The world in the formats scripts/run_gvins.py documents: imu.txt
    (increment form, time dtheta dvel [odovel]), gnss.txt (time, lat and lon
    in degrees to 15 decimals, height, stds), frames.txt ('stamp relpath'
    lines, the form scripts/convert_kaist.py writes), 8-bit grayscale PNGs
    (rounded) under images/, and gvins.yaml. Returns the paths."""
    from PIL import Image

    paths = {k: os.path.join(root, f) for k, f in (("config", "gvins.yaml"), ("imu", "imu.txt"),
                                                    ("gnss", "gnss.txt"), ("frames", "frames.txt"))}
    paths["imagedir"] = root
    cols = [imu["time"][:, None], imu["dtheta"], imu["dvel"]]
    if np.any(imu["odovel"]):
        cols.append(imu["odovel"][:, None])
    np.savetxt(paths["imu"], np.concatenate(cols, axis=1), fmt="%.17g")
    deg = np.rad2deg(gnss["blh"][:, :2])
    np.savetxt(paths["gnss"], np.concatenate([gnss["time"][:, None], deg, gnss["blh"][:, 2:], gnss["std"]], axis=1),
               fmt=["%.3f", "%.15f", "%.15f", "%.9f", "%.6f", "%.6f", "%.6f"])
    os.makedirs(os.path.join(root, "images"))
    with open(paths["frames"], "w") as f:
        for k, t in enumerate(frame_times):
            rel = os.path.join("images", f"{k:06d}.png")
            Image.fromarray(np.clip(np.round(frame(k)), 0, 255).astype(np.uint8), "L").save(os.path.join(root, rel))
            f.write(f"{t:.9f} {rel}\n")
    with open(paths["config"], "w") as f:
        f.write(yaml_text(raw))
    return paths


def check_world_files(dataset, paths, imu, gnss, frame_times, frame):
    """The port's loaders give back the in-memory streams within the print
    precision; with the native parser in use, its tables equal the numpy
    path's; the PNGs read back as the rounded frames. Prints what read
    them."""
    import PIL

    got = dataset.load_imu(paths["imu"], 200.0)
    d_imu = {k: float(np.abs(got[k] - imu[k]).max()) for k in ("time", "dt", "dtheta", "dvel")}
    g = dataset.load_gnss(paths["gnss"])
    d_gnss = dict(lat_lon_rad=float(np.abs(g["blh"][:, :2] - gnss["blh"][:, :2]).max()),
                  height_m=float(np.abs(g["blh"][:, 2] - gnss["blh"][:, 2]).max()),
                  std=float(np.abs(g["std"] - gnss["std"]).max()))
    print(f"[long] inputs read by the {dataset.parser()} parser: {len(got['time'])} IMU samples, max difference "
          f"to the stream {d_imu}; {len(g['time'])} GNSS fixes, {d_gnss}")
    assert len(got["time"]) == len(imu["time"]) and np.array_equal(g["time"], gnss["time"])
    assert d_imu["time"] == 0.0 and d_imu["dtheta"] == 0.0 and d_imu["dvel"] == 0.0 and d_imu["dt"] < 1e-12
    assert d_gnss["lat_lon_rad"] < 1e-15 and d_gnss["height_m"] < 1e-9 and d_gnss["std"] == 0.0
    if dataset.parser() == "native":
        arr = dataset._numpy_imu(paths["imu"], 200.0, 0)
        same_imu = all(np.array_equal(got[k], arr[:, sl]) for k, sl in
                       (("time", 0), ("dt", 1), ("dtheta", slice(2, 5)), ("dvel", slice(5, 8))))
        raw = np.loadtxt(paths["gnss"])
        d_rad = float(np.abs(g["blh"][:, :2] - np.deg2rad(raw[:, 1:3])).max())   # deg->rad roundings differ
        same_gnss = d_rad < 1e-15 and np.array_equal(g["blh"][:, 2], raw[:, 3]) and \
            np.array_equal(g["std"], raw[:, 4:7])
        print(f"[long] native parse against the numpy parse: IMU equal {same_imu}; GNSS heights and stds "
              f"equal, lat/lon within {d_rad:.3g} rad: {same_gnss}")
        assert same_imu and same_gnss, "the native and numpy parsers differ"
    times, provider = dataset.load_frame_index(paths["frames"], paths["imagedir"])
    ks = (0, *(f for _, f in LONG_CHECKED.values()), len(frame_times) - 1)
    same_png = all(np.array_equal(provider(k), np.clip(np.round(frame(k)), 0, 255)) for k in ks)
    print(f"[long] frames.txt: {len(times)} 'stamp relpath' lines; PIL {PIL.__version__} read the PNGs, frames "
          f"{ks} equal to the rounded renders: {same_png}")
    assert np.abs(times - frame_times).max() < 1e-9 and same_png
    return provider


def long_kernel_checks(torch, modules, provider, cfg, camera, checked=LONG_CHECKED, min_joints=None,
                       label="long"):
    """Each kernel against its plain version on frames of a world as the
    replay reads them, at the tracker's statics for its camera, with phase 3's
    tolerances: by default three frames of the long world (a normal pair, a
    glitch frame, a blackout frame). ``checked`` maps a tag to (previous,
    checked) frame indices, ``min_joints`` a tag to the fewest slots LK must
    track both ways."""
    kclahe, klk, ksubpix, pyramid, feat, trk, vmap_mod = modules
    tracker = trk.Tracker(camera, vmap_mod.VisualMap(cfg.optimize_windows_size), cfg, device=DEVICE)
    br, bc, per, dist = tracker._detect_static
    img = lambda k: torch.tensor(provider(k), dtype=torch.float32, device=DEVICE)  # noqa: E731

    def detect(level0):
        c, _, v = feat.detect_blockwise(level0, torch.ones_like(level0),
                                        torch.zeros(br * bc, dtype=torch.int32, device=level0.device),
                                        block_rows=br, block_cols=bc, per_block=per, min_distance=dist)
        return c.contiguous(), v.contiguous()

    for tag, (kp, kf) in checked.items():
        ip, i_f = img(kp), img(kf)
        check_clahe(kclahe, f"{label} {tag} frame {kf}", pyramid.clahe_tables(i_f))
        pyr_p, pyr_f = pyramid.build_pyramid(pyramid.clahe(ip)), pyramid.build_pyramid(pyramid.clahe(i_f))
        c, v = detect(pyr_p[0])
        # ~16 blobs in view at 160x120; the glitch's step in brightness loses most tracks
        min_joint = (min_joints or {"normal": 5, "glitch": 0, "featureless": 0})[tag]
        for n in (1, 2):
            check_lk(torch, klk, f"{label} {tag} frames {kp}->{kf}", (pyr_p, pyr_f, c, c, v), n, min_joint)
        cf, vf = detect(pyr_f[0])
        src = kf
        if int(vf.sum()) < 8:        # nothing to detect: refine the previous frame's corners on it
            cf, vf, src = c, v, kp
        check_subpix(torch, ksubpix, f"{label} {tag} frame {kf} (corners of frame {src})", (pyr_f[0], cf, vf))


def long_phase(torch, card, wrappers):
    """Phase 8: tests/test_gvins_long_e2e.py's world written to files and
    replayed through ``scripts/run_gvins_torch.py`` (``main``, in process,
    ``--device cuda``): the input path checked, the kernels held against
    their plain versions on three of its frames, then the replay with that
    test's five gates against the truth and the evidence that its fault
    paths ran. The port refuses a window slide of more than ``marg_cap``
    nodes as the JAX package does (on the CPU, after the frame at
    LONG_REFUSED_AFTER s of these files): where the replay stops so, each
    gate whose window lies after the stop is printed NOT MET, and the phase
    holds only the gates of the span that ran. Returns the kernels' launches
    in the replay. The fault paths past the stop run to their end in phase 12
    (``fault_phase``)."""
    import importlib.util
    import tempfile

    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.engine.config import load_config
    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.io import dataset
    from ic_gvins_tpu_torch.models import gvins as gvins_mod
    from ic_gvins_tpu_torch.ops import clahe as kclahe
    from ic_gvins_tpu_torch.ops import lk as klk
    from ic_gvins_tpu_torch.ops import subpix as ksubpix
    from ic_gvins_tpu_torch.vision import camera as cam
    from ic_gvins_tpu_torch.vision import features as feat
    from ic_gvins_tpu_torch.vision import map as vmap_mod
    from ic_gvins_tpu_torch.vision import pyramid
    from ic_gvins_tpu_torch.vision import tracking as trk

    t_phase = t0 = time.perf_counter()
    imu, gnss, truth, frame_times, frame = long_world(cam, rotation_np)
    intrinsic, distortion, resolution = LONG_CAMERA
    raw = dict(LONG_RAW, is_make_outputdir=False, antlever=list(truth["lever"]), cam0=dict(
        intrinsic=intrinsic, distortion=distortion, resolution=resolution, q_b_c=[0.0, 0.0, 0.0, 1.0],
        t_b_c=[0.0, 0.0, 0.0], td_b_c=0.0))
    spec = importlib.util.spec_from_file_location(
        "run_gvins_torch", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "run_gvins_torch.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_world_files(tmp, imu, gnss, frame_times, frame, raw)
        print(f"[long] world: {len(imu['time'])} IMU samples, {len(gnss['time'])} GNSS fixes (outage "
              f"{LONG_OUTAGE}), {len(frame_times)} frames {resolution[0]}x{resolution[1]} (glitch {LONG_GLITCH}, "
              f"blackout {LONG_BLACKOUT}), written to files in {time.perf_counter() - t0:.2f} s on the CPU")
        provider = check_world_files(dataset, paths, imu, gnss, frame_times, frame)
        cfg = load_config(paths["config"])
        assert cfg.track_check_histogram and cfg.optimize_estimate_td and cfg.optimize_estimate_extrinsic
        long_kernel_checks(torch, (kclahe, klk, ksubpix, pyramid, feat, trk, vmap_mod), provider, cfg,
                           cam.PinholeCamera.from_config(*LONG_CAMERA))

        # the replay, with the model, the tracker's states, the parameter
        # updates and each episode's reprojection rows recorded by light wrappers
        G = gvins_mod.GvinsModel
        track, update, optimize, run = trk.Tracker.track, G._update_from_optimizer, G._optimize_visual, G.run
        models, tracked, visual_rows, adoptions = [], [], [], {"td": 0, "extrinsic": 0}

        def logged_run(self, *args):
            models.append(self)
            return run(self, *args)

        def logged_track(self, frame_, image):
            st = track(self, frame_, image)
            tracked.append((frame_.stamp - frame_.td, st))
            return st

        def logged_optimize(self):
            build, rows = self._build_reproj_table, []

            def counted(slots):
                table, n = build(slots)
                rows.append(n)
                return table, n
            self._build_reproj_table = counted
            try:
                return optimize(self)
            finally:
                del self._build_reproj_table
                visual_rows.append((float(self.est.times[self.est.n_nodes - 1]), sum(rows)))

        def logged_update(self, slots):
            td0, t0_ = self.td_b_c, self.pose_b_c_t.copy()
            out = update(self, slots)
            adoptions["td"] += self.td_b_c != td0
            adoptions["extrinsic"] += not np.array_equal(self.pose_b_c_t, t0_)
            return out

        outdir = os.path.join(tmp, "out")
        argv = ["--config", paths["config"], "--imu", paths["imu"], "--gnss", paths["gnss"], "--frames",
                paths["frames"], "--imagedir", paths["imagedir"], "--output", outdir, "--device", DEVICE]
        refused = None
        trk.Tracker.track = logged_track
        G._update_from_optimizer, G._optimize_visual, G.run = logged_update, logged_optimize, logged_run
        try:
            with FrameLog(torch, gvins_mod, fetch) as log:
                for w in wrappers.values():
                    w.launches = 0
                reads0 = fetch.reads
                torch.cuda.synchronize()
                t_run = time.perf_counter()
                try:
                    runner.main(argv)
                except ValueError as e:      # the JAX package's refusal, taken over unchanged
                    if "exceeds marg_cap" not in str(e):
                        raise
                    refused = e
                torch.cuda.synchronize()
                t_run = time.perf_counter() - t_run
                launches = {k: w.launches for k, w in wrappers.items()}
                reads = fetch.reads - reads0
        finally:
            trk.Tracker.track = track
            G._update_from_optimizer, G._optimize_visual, G.run = update, optimize, run
        model = models[0]
        traj = np.loadtxt(os.path.join(outdir, "trajectory.csv"), ndmin=2)
        stats = np.loadtxt(os.path.join(outdir, "statistics.txt"), ndmin=2)
        tracking = np.loadtxt(os.path.join(outdir, "tracking.txt"), ndmin=2)
        ext = np.loadtxt(os.path.join(outdir, "extrinsic.txt"), ndmin=2)
    nodes = np.asarray(model.trajectory)
    # the stamp of the last frame the replay finished: where a refusal stops
    # it, the frame after this one raised
    stop = log.rows[-1][5] if refused is not None else float(frame_times[-1])

    sim_s = float(min(stop, imu["time"][-1]) - imu["time"][0])
    ep_rows = [r for r in log.rows if r[1]]
    episodes = sum(model.tier_counts.values())
    print(f"[long] replay through run_gvins_torch.main: {sim_s:.2f} s simulated in {t_run:.3f} s wall, "
          f"{sim_s / t_run:.3f} sim-s per wall-s (the files read by the runner inside it) ({card})")
    if refused is not None:
        print(f"[long] the replay stopped after the frame at {stop:.2f} s: {refused} (the port on the CPU "
              f"stops after the frame at {LONG_REFUSED_AFTER} s; the JAX package refuses such a slide alike: "
              f"ROADMAP R1)")
    print(f"[long] {len(log.rows)} frames processed, {episodes} keyframe episodes, solver tiers "
          f"{model.tier_counts}, marginalization tiers {model.tier_counts_marg}; {reads} host reads; "
          f"launches in the replay {launches}")
    for name, vals in (("episode frame ms", [1e3 * r[2] for r in ep_rows]),
                       ("other frame ms", [1e3 * r[2] for r in log.rows if not r[1]]),
                       ("pass-1 solve ms", stats[:, 10]), ("pass-2 solve ms", stats[:, 11])):
        print(f"[long] {name}: {len(vals)} values, median {pct(vals, 50):.3f}, p90 {pct(vals, 90):.3f} ({card})")

    # the fault paths
    in_win = lambda t, w: w[0] <= t < w[1] + 1e-6  # noqa: E731
    passed = [t for t, st in tracked if st == trk.TRACK_PASSED and in_win(t, LONG_GLITCH)]
    lost_all = [round(t, 2) for t, st in tracked if st == trk.TRACK_LOST]
    lost = [t for t in lost_all if in_win(t, LONG_BLACKOUT)]
    normal_after = [r[5] for r in log.rows if lost and r[5] > max(lost) and r[3] == "TRACKING_NORMAL"]
    bridge_eps = [(round(t, 2), n) for t, n in visual_rows if in_win(t, LONG_OUTAGE)]
    bridge_visual = [e for e in bridge_eps if e[1] > 0]
    last_tracking = next((round(t, 2) for t, st in reversed(tracked) if st == trk.TRACK_TRACKING), None)
    print(f"[long] replay tracker states by frame (TRACK_*: count): "
          f"{dict(sorted(collections.Counter(int(st) for _, st in tracked).items()))}; TRACK_LOST at {lost_all}; "
          f"last TRACK_TRACKING frame {last_tracking}")
    print(f"[long] histogram gate (TRACK_PASSED) in {LONG_GLITCH} at {passed}; keyframe episodes in the GNSS "
          f"outage {LONG_OUTAGE} (newest node s, reprojection rows): {bridge_eps}; adopted updates {adoptions}; "
          f"final td {model.td_b_c:.5f} s, t_b_c {model.pose_b_c_t} m, "
          f"R_b_c {rotation_np.matrix_to_euler(model.pose_b_c_R) * 180 / np.pi} deg")

    # tests/test_gvins_long_e2e.py's gates, against the truth
    def errs(t_lo=0.0, t_hi=1e9, exclude=()):
        keep = [r for r in nodes if t_lo <= r[0] <= t_hi and not any(lo - 2.0 <= r[0] <= hi + 3.0
                                                                      for lo, hi in exclude)]
        return node_errors(np.asarray(keep), truth)[1] if keep else np.zeros(0)

    outside = errs(t_lo=8.0, exclude=(LONG_OUTAGE, LONG_BLACKOUT))
    bridge = errs(LONG_OUTAGE[0], LONG_OUTAGE[1] + 2.0)
    tail = errs(t_lo=100.0)
    post = errs(LONG_BLACKOUT[1] + 3.0, 100.0)
    top = lambda e, f: float(f(e)) if len(e) else float("nan")  # noqa: E731
    end = float(frame_times[-1])
    # (name, value, limit, met, the stamp the replay must pass for the gate to be judged)
    gates = [("state at the end", model.state, "TRACKING_NORMAL", model.state == "TRACKING_NORMAL", end),
             ("last node s", float(nodes[-1, 0]), "> 110", nodes[-1, 0] > 110.0, 110.0),
             ("nodes outside the faults", len(outside), "> 40", len(outside) > 40, 0.0),
             ("mean error outside the faults m", top(outside, np.mean), "< 0.3", top(outside, np.mean) < 0.3, 0.0),
             ("bridge nodes", len(bridge), "> 3", len(bridge) > 3, LONG_OUTAGE[1] + 2.0),
             ("bridge max error m", top(bridge, np.max), "< 3.0", top(bridge, np.max) < 3.0, LONG_OUTAGE[1] + 2.0),
             ("tail nodes", len(tail), "> 5", len(tail) > 5, end),
             ("tail mean error m", top(tail, np.mean), "< 0.25", top(tail, np.mean) < 0.25, end),
             ("post-blackout nodes", len(post), "> 3", len(post) > 3, 100.0),
             ("post-blackout mean error m", top(post, np.mean), "< 0.3", top(post, np.mean) < 0.3, 100.0),
             ("statistics.txt", stats.shape, "15 columns, > 30 rows", stats.shape[1] == 15 and len(stats) > 30,
              0.0),
             ("tracking.txt columns", tracking.shape[1], "== 7", tracking.shape[1] == 7, 0.0),
             ("extrinsic.txt rows", len(ext), ">= 1", len(ext) >= 1, 0.0),
             ("|t_b_c| m", float(np.linalg.norm(model.pose_b_c_t)), "< 1", np.linalg.norm(model.pose_b_c_t) < 1.0,
              0.0),
             ("|td| s", abs(model.td_b_c), "<= 0.081", abs(model.td_b_c) <= 0.081, 0.0),
             ("trajectory.csv columns", traj.shape[1], "== 8", traj.shape[1] == 8, 0.0),
             # the evidence that the fault paths ran
             (f"histogram gate frames in {LONG_GLITCH}", passed, ">= 1", len(passed) >= 1, LONG_GLITCH[1]),
             (f"TRACK_LOST frames in {LONG_BLACKOUT}", lost, ">= 1", len(lost) >= 1, LONG_BLACKOUT[1]),
             ("TRACKING_NORMAL after them, from s", normal_after[0] if normal_after else None, "a frame",
              bool(normal_after), LONG_BLACKOUT[1]),
             (f"keyframe episodes with reprojection rows in the GNSS outage {LONG_OUTAGE}", len(bridge_visual),
              ">= 1", len(bridge_visual) >= 1, LONG_OUTAGE[1]),
             ("adopted td / extrinsic updates", adoptions, ">= 1 together", sum(adoptions.values()) >= 1, 0.0),
             ("kernel launches in the replay", launches, "each >= 1", all(n > 0 for n in launches.values()), 0.0)]
    failed, not_reached = [], []
    for name, value, limit, ok, needs in gates:
        if ok:
            verdict = "ok"
        elif refused is not None and stop < needs:
            verdict = f"NOT MET (the replay stopped at {stop:.2f} s, before {needs:.1f} s)"
            not_reached.append(name)
        else:
            verdict = "FAILED"
            failed.append(name)
        print(f"[long] gate {name}: {value} (limit {limit}) {verdict}")
    if not_reached:
        print(f"[long] NOT MET, the failure left standing (the port refuses a slide of more than marg_cap nodes "
              f"as the JAX package does; ROADMAP R1): {not_reached}; the fault paths past the stop run to their "
              f"end in phase 12")
    print(f"[long] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    assert not failed, f"phase 8 gates failed: {failed}"
    return launches


# --------------------------------------------------------------------------
# phase 9: the batched forms of parallel/mesh.py, and the checkpoint
# --------------------------------------------------------------------------

def np_problem(cfg, seed=0):
    """A COPY of ``__graft_entry__._np_problem`` (that module imports the JAX
    package): one synthetic VIO-shaped window problem (GNSS +
    preintegration + reprojection factors) assembled in numpy, line for
    line, as the port's WindowParams / FactorTables NamedTuples with numpy
    leaves (``convert.window_params`` / ``factor_tables`` take them to the
    card). Problems differ per seed in node count, landmark count,
    trajectory and landmark geometry. tests/test_torch_parallel.py holds
    the copy against the original leaf for leaf."""
    from ic_gvins_tpu_torch.ins.preintegration import PreintSummary
    from ic_gvins_tpu_torch.ins.preintegration_odo import PreintOdoSummary
    from ic_gvins_tpu_torch.solver.problem import (
        FactorTables, GnssTable, MargPrior, PreintTable, PriorTable,
        ReprojTable, WindowParams,
    )

    rng = np.random.default_rng(seed)
    n_nodes = min(3 + (seed % 2), cfg.N)
    n_lm = min(24 + 4 * (seed % 3), cfg.L)
    heading = 0.15 * (seed % 5)

    poses = np.zeros((cfg.N, 7))
    poses[:, 6] = 1.0
    step = np.array([0.4 * np.cos(heading), 0.4 * np.sin(heading), 0.0])
    for k in range(n_nodes):
        poses[k, :3] = k * step + 0.02 * k * np.array([0.0, 1.0, 0.0])

    params = WindowParams(
        poses=poses,
        mixes=np.zeros((cfg.N, cfg.mix_dim)),
        ext=np.array([0.0, 0, 0, 0, 0, 0, 1.0]),
        td=np.zeros(()),
        invdepths=np.full(cfg.L, 0.1),
    )

    # ---- GNSS ----
    g_n = min(n_nodes, cfg.G)
    gnss = GnssTable(
        idx=np.zeros(cfg.G, np.int32),
        blh=np.zeros((cfg.G, 3)),
        std=np.ones((cfg.G, 3)),
        valid=np.zeros(cfg.G),
        robust=np.ones(()),
    )
    gnss.idx[:g_n] = np.arange(g_n)
    gnss.blh[:g_n] = poses[:g_n, :3] + rng.normal(0, 0.05, (g_n, 3))
    gnss.std[:g_n] = 0.1
    gnss.valid[:g_n] = 1.0

    # ---- preintegration (identity-delta summaries; gravity zero to match
    # the gravity-free synthetic trajectory under either earth variant) ----
    P = cfg.P
    z3 = np.zeros((P, 3))
    z33 = np.zeros((P, 3, 3))
    qid = np.tile(np.array([0.0, 0, 0, 1.0]), (P, 1))
    nres = cfg.preint_res
    common = dict(
        dt=np.ones(P), dp=z3.copy(), dv=z3.copy(), dq=qid.copy(),
        bg0=z3.copy(), ba0=z3.copy(),
        dp_dbg=z33.copy(), dp_dba=z33.copy(), dv_dbg=z33.copy(),
        dv_dba=z33.copy(), dq_dbg=z33.copy(),
        sqrt_info=np.tile(np.eye(nres), (P, 1, 1)),
        cov=np.tile(np.eye(nres), (P, 1, 1)),
        gravity=z3.copy(), iewn=z3.copy(), sum_dtpn=z3.copy(),
        end_p=z3.copy(), end_q=qid.copy(), end_v=z3.copy(),
        end_time=np.zeros(P),
    )
    # consecutive-node deltas consistent with the trajectory (dp in body
    # frame of node k = world frame here: identity orientations)
    for k in range(n_nodes - 1):
        common["dp"][k] = poses[k + 1, :3] - poses[k, :3]
    if cfg.with_odo:
        summ = PreintOdoSummary(
            ds=z3.copy(), sodo0=np.zeros(P), ds_dbg=z33.copy(),
            ds_dsodo=z3.copy(), **common)
    else:
        summ = PreintSummary(**common)
    preint = PreintTable(
        summ=summ,
        idx0=np.arange(P, dtype=np.int32),
        valid=(np.arange(P) < n_nodes - 1).astype(np.float64),
    )

    # ---- reprojection: landmarks ~8 m ahead observed from nodes 1.. ----
    reproj = ReprojTable(
        ref_idx=np.zeros(cfg.R, np.int32),
        obs_idx=np.ones(cfg.R, np.int32),
        lm_idx=np.zeros(cfg.R, np.int32),
        pts0=np.tile(np.array([0.0, 0, 1.0]), (cfg.R, 1)),
        pts1=np.tile(np.array([0.0, 0, 1.0]), (cfg.R, 1)),
        vel0=np.zeros((cfg.R, 3)), vel1=np.zeros((cfg.R, 3)),
        td0=np.zeros(cfg.R), td1=np.zeros(cfg.R),
        valid=np.zeros(cfg.R),
        sqrt_info=np.asarray(780.0 / 1.5),
        robust=np.ones(()),
    )
    pts_w = rng.uniform(-2, 2, (n_lm, 3)) + np.array([0.5, 0.0, 8.0])
    invd = np.full(cfg.L, 0.1)
    slot = 0
    for j in range(n_lm):
        pn0 = (pts_w[j] - poses[0, :3]) / (pts_w[j, 2] - poses[0, 2])
        invd[j] = 1.0 / (pts_w[j, 2] - poses[0, 2])
        for k in range(1, n_nodes):
            if slot >= cfg.R:
                break
            pn1 = (pts_w[j] - poses[k, :3]) / (pts_w[j, 2] - poses[k, 2])
            reproj.ref_idx[slot] = 0
            reproj.obs_idx[slot] = k
            reproj.lm_idx[slot] = j
            reproj.pts0[slot] = [pn0[0], pn0[1], 1.0]
            reproj.pts1[slot] = [pn1[0], pn1[1], 1.0]
            reproj.valid[slot] = 1.0
            slot += 1
    params = params._replace(invdepths=invd)

    prior = PriorTable(
        pose_prior=np.array([0.0, 0, 0, 0, 0, 0, 1.0]),
        pose_prior_std=np.ones(6),
        mix_prior=np.zeros(cfg.mix_dim),
        mix_prior_std=np.ones(cfg.mix_dim),
        valid=np.zeros(()),
        imuerr_idx=np.asarray(n_nodes - 1, np.int32),
        imuerr_valid=np.ones(()),
    )
    zero_params = WindowParams(
        poses=np.tile(np.array([0.0, 0, 0, 0, 0, 0, 1.0]), (cfg.N, 1)),
        mixes=np.zeros((cfg.N, cfg.mix_dim)),
        ext=np.array([0.0, 0, 0, 0, 0, 0, 1.0]),
        td=np.zeros(()),
        invdepths=np.full(cfg.L, 0.1),
    )
    NP = cfg.lm_off  # the prior lives on its node/ext/td support only
    margp = MargPrior(
        H0=np.zeros((NP, NP)), Jte0=np.zeros(NP), c0=np.zeros(()),
        x0=zero_params, valid=np.zeros(()),
    )

    tables = FactorTables(
        gnss=gnss, preint=preint, reproj=reproj, prior=prior, marg=margp,
        antlever=np.zeros(3),
        node_valid=(np.arange(cfg.N) < n_nodes).astype(np.float64),
        lm_valid=(np.arange(cfg.L) < n_lm).astype(np.float64),
        ext_active=np.zeros(()),
        td_active=np.zeros(()),
    )
    return params, tables


FLEET_WINDOW = dict(N=20, L=512, G=24, R=2048, with_earth=True)   # __graft_entry__.py:312
FLEET_ITERATIONS = 20
FLEET_BATCHES = (1, 8, 32)
FLEET_PROFILED = 8               # the batch size profiled for the device busy share
# A batch element against its single solve after 20 iterations: index_add's
# atomics and the batched cuBLAS / cuSOLVER calls sum f64 in other orders,
# and LM carries such differences along the flat directions of these 3-4
# node windows (measured on the H100: up to 2e-5 m and 9e-7 relative cost;
# the single solve against itself 6e-8-1.4e-7 m)
FLEET_POSE_TOL = 1e-4            # m
FLEET_COST_RTOL = 1e-5           # final cost, relative
FLEET_REPEATS = 4                # single solves run twice: the card's own run-to-run spread
FLEET_WORLDS = 4
FLEET_FEATURES = 200
FLEET_MARG_B = 8
FLEET_INS = (8, 512)             # worlds, IMU samples a world (a preintegration segment)
CKPT_TOL = 1e-9                  # m: the resumed estimator's positions after one more optimize


def fleet_solve(torch, card, mesh, problems):
    """Phase 9a: the two-pass solve of B distinct production-width windows
    through sharded_two_pass, each element against its own single solve;
    batched against looped wall time, host reads, device busy share."""
    from torch.profiler import ProfilerActivity, profile

    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.parallel import mesh as pmesh
    from ic_gvins_tpu_torch.solver import lm
    from ic_gvins_tpu_torch.solver.problem import WindowConfig, over_problems, total_cost

    cfg = WindowConfig(**FLEET_WINDOW)
    lm.solve_two_pass(*problems[0], cfg, FLEET_ITERATIONS)      # warm-up: solver handles, allocator
    singles, single_s = [], []
    for params, tables in problems:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.solve_two_pass(params, tables, cfg, FLEET_ITERATIONS)
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t0)
        singles.append((out[0], total_cost(out[0], out[1], cfg)))
    spread = max(float((lm.solve_two_pass(*problems[k], cfg, FLEET_ITERATIONS)[0].poses - singles[k][0].poses)
                       .abs().max()) for k in range(FLEET_REPEATS))
    print(f"[fleet] the single solve run twice on the card (index_add's atomics sum in either order): "
          f"poses within {spread:.3g} m over {FLEET_REPEATS} problems")
    fn, place = pmesh.sharded_two_pass(mesh, cfg, FLEET_ITERATIONS)
    fn(*(place(pmesh.stack(x)) for x in zip(*problems[:1])))   # warm-up of the batched path
    rows = {}
    for B in FLEET_BATCHES:
        args = [place(pmesh.stack(x)) for x in zip(*problems[:B])]
        torch.cuda.synchronize()
        reads0, t0 = fetch.reads, time.perf_counter()
        out_params, out_tables = pmesh.gather(fn(*args))
        torch.cuda.synchronize()
        wall, reads = time.perf_counter() - t0, fetch.reads - reads0
        costs = over_problems(total_cost, cfg)(out_params, out_tables)
        dp = max(float((out_params.poses[k] - singles[k][0].poses).abs().max()) for k in range(B))
        dc = max(abs(float(costs[k] - singles[k][1])) / max(float(singles[k][1]), 1e-12) for k in range(B))
        looped = sum(single_s[:B])
        rows[B] = dict(batched_ms=1e3 * wall, looped_ms=1e3 * looped, reads=reads, pose_diff=dp, cost_rel=dc)
        print(f"[fleet] two-pass solve, B={B}: batched {1e3 * wall:.1f} ms, the B single solves looped "
              f"{1e3 * looped:.1f} ms ({looped / wall:.2f}x); {reads} host reads; each element against its "
              f"single solve: poses within {dp:.3g} m, cost within {dc:.3g} relative ({card})")
        assert dp < FLEET_POSE_TOL and dc < FLEET_COST_RTOL, f"batched solve B={B} disagrees"
        if B == FLEET_PROFILED:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                prof_ms = 1e3 * (time.perf_counter() - t0)
            kernels, busy = device_activity(torch, prof, prof_ms)
            if kernels is None:
                print("[fleet] profiler: no device events in the trace; busy share not measured")
            else:
                rows[B]["busy_share"] = busy / prof_ms
                print(f"[fleet] profiled batched solve B={B}: {kernels} CUDA kernels, device busy {busy:.2f} of "
                      f"{prof_ms:.2f} ms = {100 * busy / prof_ms:.1f} % ({card})")
    return rows


def fleet_frontend(torch, card, mesh, wrappers, images):
    """Phase 9b: sharded_frontend on FLEET_WORLDS worlds at the slice's size
    (world b: frame b -> b+1, FLEET_FEATURES features): each kernel's
    batched launch against its batched plain version, each world against
    its unbatched frame, one launch per kernel per batched call (CLAHE one
    per image set), device-only ms per world. Returns the launch counts."""
    from ic_gvins_tpu_torch.ops import clahe as kclahe
    from ic_gvins_tpu_torch.ops import lk as klk
    from ic_gvins_tpu_torch.ops import subpix as ksubpix
    from ic_gvins_tpu_torch.parallel import mesh as pmesh
    from ic_gvins_tpu_torch.vision import features as feat
    from ic_gvins_tpu_torch.vision import pyramid

    B = FLEET_WORLDS
    dev = torch.device(DEVICE)
    frames = torch.tensor(np.stack(images[:B + 1]), dtype=torch.float32, device=dev)
    prev, cur = frames[:B].contiguous(), frames[1:].contiguous()
    pts, valid = [], []
    for b in range(B):
        _, _, c, v = lk_inputs(torch, pyramid, feat, prev[b], cur[b])
        pts.append(c)
        valid.append(v & (torch.cumsum(v.int(), 0) <= FLEET_FEATURES))
    pts, valid = torch.stack(pts), torch.stack(valid)
    assert int(valid.sum()) >= B * 150, int(valid.sum())
    F, br, bc, pb, md = SLICE_STATICS
    kw = dict(levels=4, block=(br, bc, pb), min_distance=md, ransac_thr=CFG["reprojection_error_std"])

    # each kernel's batched launch against its batched plain version (phase 3's checks)
    tables = pyramid.clahe_tables(prev)
    check_clahe(kclahe, f"{B} worlds", tables)
    pyr_p = pyramid.build_pyramid(pyramid.clahe(prev))
    pyr_c = pyramid.build_pyramid(pyramid.clahe(cur))
    lk_args = (pyr_p, pyr_c, pts, pts, valid)
    check_lk(torch, klk, f"{B} worlds", lk_args, 2, 50 * B)
    c, _, v = feat.detect_blockwise(pyr_c[0], torch.ones_like(pyr_c[0]),
                                    torch.zeros((B, br * bc), dtype=torch.int32, device=dev),
                                    block_rows=br, block_cols=bc, per_block=pb, min_distance=md)
    sp_args = (pyr_c[0], c.contiguous(), v.contiguous())
    check_subpix(torch, ksubpix, f"{B} worlds", sp_args)
    one = (tables[0][0].contiguous(), tables[1][0].contiguous(), *tables[2:])
    for name, batched, single in (
            ("clahe_apply", lambda: kclahe.clahe_apply(*tables), lambda: kclahe.clahe_apply(*one)),
            ("lk_pyr", lambda: klk.lk_pyr(*lk_args),
             lambda: klk.lk_pyr([lv[0] for lv in pyr_p], [lv[0] for lv in pyr_c], pts[0], pts[0], valid[0])),
            ("subpix", lambda: ksubpix.subpix(*sp_args),
             lambda: ksubpix.subpix(sp_args[0][0], sp_args[1][0], sp_args[2][0]))):
        b_ms, s_ms = cuda_ms(torch, batched, queued=True), cuda_ms(torch, single, queued=True)
        print(f"[fleet] {name}: device-only {b_ms / B:.4f} ms a world in one launch for {B} worlds, "
              f"{s_ms:.4f} ms for one world alone ({card})")

    # the main path: the batched frame, its launches counted
    fn, place = pmesh.sharded_frontend(mesh, (H, W), **kw)
    args = place((prev, cur, pts, valid))
    fn(*args)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt, ok, corners, cvalid = pmesh.gather(fn(*args))
    torch.cuda.synchronize()
    batched_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[fleet] frontend frame, {B} worlds {W}x{H} in one batched call: {batched_ms:.2f} ms wall, "
          f"launches {launches} ({card})")
    assert launches == {"clahe_apply": 2 * len(mesh), "lk_pyr": len(mesh), "subpix": len(mesh)}, launches

    frame1 = pmesh.frontend_frame_fn((H, W), **kw)
    single_ms = []
    for b in range(B):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rn, ro, rc, rv = frame1(prev[b], cur[b], pts[b], valid[b])
        torch.cuda.synchronize()
        single_ms.append(1e3 * (time.perf_counter() - t0))
        dn = float((nxt[b] - rn)[ro].abs().max()) if bool(ro.any()) else 0.0
        dc = float((corners[b] - rc)[rv].abs().max()) if bool(rv.any()) else 0.0
        print(f"[fleet] world {b}: {int(ro.sum())} of {int(valid[b].sum())} tracked, ok masks "
              f"{'equal' if torch.equal(ok[b], ro) else 'DIFFER'}, points within {dn:.3g} px, "
              f"{int(rv.sum())} corners within {dc:.3g} px of the unbatched frame")
        assert torch.equal(ok[b], ro) and torch.equal(cvalid[b], rv), f"world {b}: masks differ"
        assert dn < 1e-3 and dc < 1e-3, f"world {b}: points differ"
        assert int(ro.sum()) >= 100, f"world {b}: too few tracks"
    print(f"[fleet] frontend wall per world: batched {batched_ms / B:.2f} ms, unbatched median "
          f"{np.median(single_ms):.2f} ms (host clock, synchronized) ({card})")
    return launches


def fleet_marg_ins(torch, card, mesh, problems):
    """Phase 9c: sharded_marg_step and sharded_ins_step at the production
    widths, each element against its single call."""
    from ic_gvins_tpu_torch.core.types import ImuBatch, IntegrationParams, NavState
    from ic_gvins_tpu_torch.factors import marginalization as marg
    from ic_gvins_tpu_torch.ins import mechanization as mech
    from ic_gvins_tpu_torch.ins import preintegration as pre
    from ic_gvins_tpu_torch.parallel import mesh as pmesh
    from ic_gvins_tpu_torch.solver.problem import WindowConfig

    cfg = WindowConfig(**FLEET_WINDOW)
    B = FLEET_MARG_B
    fn, place = pmesh.sharded_marg_step(mesh, cfg)
    prior = pmesh.gather(fn(*[place(pmesh.stack(x)) for x in zip(*problems[:B])]))
    worst = 0.0
    for k in range(B):
        params, tables = problems[k]
        mt, mask, _ = marg.select_marg_factors(tables, cfg, 1, 0)
        ref = marg.shift_prior(marg.marginalize(params, mt, mask, cfg), cfg, 1)
        scale = max(float(ref.H0.abs().max()), 1.0)
        worst = max(worst, float((prior.H0[k] - ref.H0).abs().max()) / scale,
                    float((prior.Jte0[k] - ref.Jte0).abs().max()) / max(float(ref.Jte0.abs().max()), 1.0),
                    abs(float(prior.c0[k] - ref.c0)) / max(float(ref.c0), 1.0))
    print(f"[fleet] marginalization step, B={B}: each element's H0, Jte0, c0 within {worst:.3g} of its "
          f"single call's scale")
    assert worst < 1e-8, "batched marginalization disagrees"

    nw, ns = FLEET_INS
    rng = np.random.default_rng(SEED + 9)
    dev = torch.device(DEVICE)
    T = lambda a: torch.tensor(np.asarray(a, np.float64), device=dev)  # noqa: E731
    imu = ImuBatch(time=T(np.tile(np.arange(1, ns + 1) * 0.005, (nw, 1))), dt=T(np.full((nw, ns), 0.005)),
                   dtheta=T(rng.normal(0, 1e-4, (nw, ns, 3))), dvel=T(rng.normal(0.016, 1e-3, (nw, ns, 3))),
                   odovel=T(np.zeros((nw, ns))))
    st = NavState(*[a.expand((nw,) + a.shape).clone() for a in NavState.identity(device=dev)])
    st = st._replace(p=T(rng.normal(0, 1, (nw, 3))))
    gravity, iewn = T(np.tile([0.0, 0.0, 9.8], (nw, 1))), T(rng.normal(0, 1e-5, (nw, 3)))
    int_params = IntegrationParams.default(device=dev)
    fn, place = pmesh.sharded_ins_step(mesh, int_params, with_earth=True)
    summ, out = pmesh.gather(fn(*place((imu, st, gravity, iewn))))
    worst = 0.0
    for k in range(nw):
        imu_k, st_k = pmesh.tree_map(lambda a: a[k], imu), pmesh.tree_map(lambda a: a[k], st)
        ref_s = pre.preintegrate(int_params, imu_k, st_k, with_earth=True)
        ref_m, _ = mech.mechanize_scan(mech.MechConfig(gravity=gravity[k], iewn=iewn[k]), st_k, imu_k)
        for a, b in [(getattr(summ, f)[k], getattr(ref_s, f)) for f in pre.PreintSummary._fields] + [
                (getattr(out, f)[k], getattr(ref_m, f)) for f in ("p", "q", "v")]:
            worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1.0))
    print(f"[fleet] INS step, {nw} worlds x {ns} samples: each world's preintegration summary and "
          f"mechanized state within {worst:.3g} (relative to scale) of its single call")
    assert worst < 1e-9, "batched INS disagrees"


def fleet_checkpoint(torch, card, est):
    """Phase 9d: phase 6's estimator at the end of its replay, saved and
    loaded into a fresh estimator on the card; one more optimize on both."""
    import tempfile

    from ic_gvins_tpu_torch.engine import checkpoint as ckpt
    from ic_gvins_tpu_torch.engine.estimator import SlidingWindowEstimator

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "estimator.npz")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(path, est, extra=dict(phase=9))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        fresh = SlidingWindowEstimator(est.wcfg, est.int_params, preint_samples=est.S,
                                       antlever=est.antlever, origin=est.origin, device=est.device)
        t0 = time.perf_counter()
        extra = ckpt.load_checkpoint(path, fresh)
        load_s = time.perf_counter() - t0
    assert int(extra["phase"]) == 9 and fresh.marg_prior is not None and est.marg_prior is not None
    assert fresh.marg_prior.H0.device == est.marg_prior.H0.device
    _, _, s_a = est.optimize(num_iterations=50, wc=est.wcfg_small)
    _, _, s_b = fresh.optimize(num_iterations=50, wc=fresh.wcfg_small)
    n = est.n_nodes
    dp = float(np.abs(est.poses[:n, :3] - fresh.poses[:n, :3]).max())
    it_a, it_b = int(s_a.iterations), int(s_b.iterations)
    print(f"[fleet] checkpoint of the GINS estimator ({n} nodes, marginalization prior on the card): "
          f"{size} B, saved in {save_s:.3f} s, loaded in {load_s:.3f} s; one more optimize on both: "
          f"positions within {dp:.3g} m, {it_a} and {it_b} accepted LM steps ({card})")
    assert fresh.n_nodes == n and dp < CKPT_TOL and it_a == it_b, "the resumed estimator diverged"


def fleet_phase(torch, card, wrappers, images, est):
    """Phase 9: the batched forms of parallel/mesh.py on the card, and the
    checkpoint. Returns the frontend's launch counts."""
    from ic_gvins_tpu_torch import convert
    from ic_gvins_tpu_torch.parallel import mesh as pmesh
    from ic_gvins_tpu_torch.solver.problem import WindowConfig

    t_phase = time.perf_counter()
    mesh = pmesh.make_mesh()
    assert all(d.type == torch.device(DEVICE).type for d in mesh), mesh
    cfg = WindowConfig(**FLEET_WINDOW)
    problems = [(convert.window_params(p, DEVICE), convert.factor_tables(t, DEVICE))
                for p, t in (np_problem(cfg, seed) for seed in range(max(FLEET_BATCHES)))]
    marks = [time.perf_counter()]
    fleet_solve(torch, card, mesh, problems)
    marks.append(time.perf_counter())
    launches = fleet_frontend(torch, card, mesh, wrappers, images)
    marks.append(time.perf_counter())
    fleet_marg_ins(torch, card, mesh, problems)
    marks.append(time.perf_counter())
    fleet_checkpoint(torch, card, est)
    marks.append(time.perf_counter())
    print(f"[fleet] seconds: problems {marks[0] - t_phase:.1f}, solve {marks[1] - marks[0]:.1f}, frontend "
          f"{marks[2] - marks[1]:.1f}, marginalization and INS {marks[3] - marks[2]:.1f}, checkpoint "
          f"{marks[4] - marks[3]:.1f}; phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 10: the user functions of the last slice, and the four measurement
# scripts (scripts/*_torch.py)
# --------------------------------------------------------------------------

# CUDA against CPU: the remap's coordinates within 4 float32 spacings of
# the widest coordinate (1.2e-4 px each at 1024-2048 px; the card contracts
# its products into fused multiply-adds), the image within 1e-3 grey levels
# plus that shift times the image's steepest gradient; f64 transforms 1e-12
# of scale; the dense normal equations 1e-9 of H's scale
USERFN_TOL = dict(map_spacings=4, grey=1e-3, f64=1e-12, normal_rel=1e-9)
PROD_SMOKE_SECONDS = 20.0        # the production envelope's smoke run (its 300 s run is PERF.md's)


def userfn_checks(torch, card):
    """Phase 10a: the user functions on the card against the port's CPU run:
    the undistortion remap at 1278x1022 and the analytic dot test, the
    world/pixel transforms and state_to_camera_pose, and the dense normal
    equations at the production widths against the block assembly."""
    from ic_gvins_tpu_torch import convert
    from ic_gvins_tpu_torch.core import quaternion as quat
    from ic_gvins_tpu_torch.ins import mechanization as mech
    from ic_gvins_tpu_torch.solver import problem as prob
    from ic_gvins_tpu_torch.vision import camera as cam

    dev = torch.device(DEVICE)
    camera = cam.PinholeCamera.from_config(KAIST_INTRINSIC, KAIST_DISTORTION, [W, H])
    maps = {d: cam.undistort_rectify_map(camera, device=d) for d in (DEVICE, "cpu")}
    img = torch.tensor(render(cam, camera, make_scene(np.random.default_rng(SEED), 300, (-12, 12), (-9, 9), (7, 20)),
                              np.eye(3), np.zeros(3), H, W, 2.5, 10), dtype=torch.float32)
    outs = {d: cam.undistort_image(img.to(d), maps[d]) for d in (DEVICE, "cpu")}
    d_map = float((maps[DEVICE].cpu() - maps["cpu"]).abs().max())
    d_img = float((outs[DEVICE].cpu() - outs["cpu"]).abs().max())
    map_tol = USERFN_TOL["map_spacings"] * float(np.spacing(np.float32(W)))
    grad = max(float(np.abs(np.diff(img.numpy(), axis=a)).max()) for a in (0, 1))
    img_tol = USERFN_TOL["grey"] + map_tol * grad
    # tests/test_vision_kernels.py's dot test, on the card
    dot = cam.PinholeCamera.from_config([120.0, 120.0, 64.0, 48.0], [-0.25, 0.08, 0.0005, 0.0003], [128, 96])
    xd, yd = (int(round(v)) for v in cam.distort_points(dot, np.array([[40.0, 30.0]]))[0])
    dimg = torch.zeros((96, 128), dtype=torch.float32, device=dev)
    dimg[yd - 1: yd + 2, xd - 1: xd + 2] = 255.0
    und = cam.undistort_image(dimg, cam.undistort_rectify_map(dot, device=DEVICE)).cpu().numpy()
    peak = np.unravel_index(np.argmax(und), und.shape)
    print(f"[userfn] undistort 1278x1022: map CUDA - CPU {d_map:.3g} px (tolerance {map_tol:.3g}), image "
          f"{d_img:.3g} grey levels (tolerance {img_tol:.3g}); dot test peak at {tuple(int(v) for v in peak[::-1])} "
          f"(want (40, 30)), {und.max():.1f} ({card})")
    assert d_map <= map_tol and d_img <= img_tol, (d_map, d_img)
    assert abs(peak[1] - 40.0) <= 1.5 and abs(peak[0] - 30.0) <= 1.5 and und.max() > 50.0

    rng = np.random.default_rng(SEED + 10)
    n = 256
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = quat.to_matrix(torch.tensor(q)).numpy()
    t = rng.normal(0, 5, (n, 3))
    pw = t + np.einsum("nij,nj->ni", R, np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(5, 20, n)])
    px = rng.uniform([0, 0], [W, H], (n, 2))
    cases = {"world2cam": (R, t, pw), "cam2world": (R, t, pw), "world2pixel": (camera, R, t, pw),
             "reprojection_error": (camera, R, t, pw, px), "pixel2unitcam": (camera, px),
             "pixel2world": (camera, R, t, px)}
    worst = {}
    for name, args in cases.items():
        run = {d: getattr(cam, name)(*[a if isinstance(a, cam.PinholeCamera) else torch.tensor(a, device=d)
                                       for a in args]) for d in (DEVICE, "cpu")}
        worst[name] = float((run[DEVICE].cpu() - run["cpu"]).abs().max()) / max(float(run["cpu"].abs().max()), 1.0)
    tbc, Rbc = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64), torch.tensor(R[0])
    pose = {d: mech.state_to_camera_pose(torch.tensor(pw, device=d), torch.tensor(q, device=d), tbc.to(d),
                                         Rbc.to(d)) for d in (DEVICE, "cpu")}
    worst["state_to_camera_pose"] = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1.0)
                                        for a, b in zip(pose[DEVICE], pose["cpu"]))
    print(f"[userfn] transforms, {n} points, CUDA against CPU (relative to scale): "
          f"{ {k: float('%.3g' % v) for k, v in worst.items()} }")
    assert max(worst.values()) <= USERFN_TOL["f64"], worst

    cfg = prob.WindowConfig(**FLEET_WINDOW)
    params, tables = np_problem(cfg, SEED + 2)
    tables = tables._replace(ext_active=np.ones(()), td_active=np.ones(()))
    tp, tt = convert.window_params(params, DEVICE), convert.factor_tables(tables, DEVICE)
    Hd, bd, act = prob.build_normal_equations(tp, tt, cfg)
    Hss, Hsl, hll, b2, act2 = prob.build_normal_blocks(tp, tt, cfg)
    Ds = cfg.lm_off
    scale = max(float(Hd.abs().max()), 1.0)
    err = max(float((Hss - Hd[:Ds, :Ds]).abs().max()), float((Hsl - Hd[:Ds, Ds:]).abs().max()),
              float((hll - torch.diagonal(Hd)[Ds:]).abs().max())) / scale
    off_lm = float((Hd[Ds:, Ds:] - torch.diag(torch.diagonal(Hd)[Ds:])).abs().max())
    err_b = float((b2 - bd).abs().max()) / max(float(bd.abs().max()), 1.0)
    Hg, bg = prob.apply_gauge(Hd, bd, act)
    off = act == 0
    frozen = bool(torch.equal(Hg[off][:, off], torch.eye(int(off.sum()), dtype=Hg.dtype, device=dev))
                  and not Hg[off][:, ~off].any() and not bg[off].any())
    print(f"[userfn] dense normal equations, D = {cfg.D} (N {cfg.N}, L {cfg.L}, R {cfg.R}): blocks within "
          f"{err:.3g} of H's scale {scale:.3g}, b within {err_b:.3g}; landmark block off-diagonal {off_lm}; "
          f"apply_gauge freezes the {int(off.sum())} inactive columns: {frozen} ({card})")
    assert err <= USERFN_TOL["normal_rel"] and err_b <= USERFN_TOL["normal_rel"] and off_lm == 0.0 and frozen
    assert torch.equal(act, act2)


def load_script(name):
    """scripts/<name>.py as a module (its work runs under its __main__ check)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_phase(torch, card, wrappers):
    """Phase 10: the user functions (``userfn_checks``), then the measurement
    scripts on the card, each with the launch counters set to 0 just before
    it and read just after, its JSON record written to build/phase10_*.json:
    scripts/bench_frontend_stages_torch.py (every stage), one run of
    scripts/profile_replay_sections_torch.py (no warm replay: the earlier
    phases warmed the process) and a PROD_SMOKE_SECONDS run of
    scripts/bench_production_torch.py with its gates. Returns the launches
    by script."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    userfn_checks(torch, card)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)

    def run(name, *args, **kw):
        mod = load_script(name)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = mod.main(*args, **kw)
        launches = {k: w.launches for k, w in wrappers.items()}
        with open(os.path.join(out_dir, f"phase10_{name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[scripts] {name}: {time.perf_counter() - t0:.1f} s; launches {launches}")
        assert rec["launches"] == launches and all(n > 0 for n in launches.values()), launches
        assert rec["device"] == torch.cuda.get_device_name(0) and rec["power_limit_w"] > 0
        return rec, launches

    by_script = {}
    rec, by_script["frontend_stages"] = run("bench_frontend_stages_torch", ["--device", DEVICE])
    for name, st in rec["stages"].items():
        dv = st["device_ms"]
        print(f"[scripts] stage {name}: as issued median {st['as_issued_ms']['median']:.4f} ms, p90 "
              f"{st['as_issued_ms']['p90']:.4f}; device-only median {dv['median']:.4f} ms, p90 {dv['p90']:.4f} "
              f"({st['device_from']}) ({card})")
    fr = rec["frontend_frames"]
    print(f"[scripts] frontend frames: {fr['frames']} profiled, median {fr['frame_ms']['median']:.2f} ms, "
          f"{fr['kernels_per_frame']:.0f} kernels a frame, device busy {fr['busy_ms']:.2f} of {fr['wall_ms']:.2f} ms "
          f"= {100 * fr['busy_share']:.1f} % ({card})")
    assert all(st["device_ms"] is not None for st in rec["stages"].values())

    rec, by_script["replay_sections"] = run("profile_replay_sections_torch", ["--device", DEVICE], warm=False)
    print(f"[scripts] replay sections: {rec['frames']} frames ({rec['timed_frames']} timed, {rec['window_frames']} "
          f"profiled), {rec['episodes']} episodes, state {rec['state']}, wall {rec['wall_ms_per_frame']:.2f} ms a "
          f"frame; top sections, ms a frame ({card}):")
    for label, row in list(rec["sections_ms_per_frame"].items())[:10]:
        split = (f", device {row['device_ms']:.3f} + host {row['host_ms']:.3f}"
                 if row.get("device_ms") is not None else "")
        print(f"[scripts]   {label}: {row['excl_ms']:.3f} ms exclusive, {row['calls']:.2f} calls{split}")

    rec, by_script["production_replay"] = run("bench_production_torch", ["--device", DEVICE],
                                               duration=PROD_SMOKE_SECONDS)
    print(f"[scripts] production envelope {rec['duration_s']:.1f} s at {rec['resolution']}: wall {rec['wall_s']:.2f} s "
          f"(render {rec['render_s']:.2f} s apart), {rec['fps']:.3f} fps, {rec['sim_s_per_wall_s']:.3f} sim-s per "
          f"wall-s, ATE RMSE {rec['ate_rmse_m']:.4f} m, max {rec['ate_max_m']:.4f} m, state {rec['final_state']}, "
          f"{rec['episodes']} episodes, peak device {rec['peak_device_mb']:.0f} MB, peak RSS {rec['peak_rss_mb']:.0f} "
          f"MB; gates {rec['gates']} ({card})")
    assert rec["ok"], rec["gates"]
    print(f"[scripts] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return by_script


# --------------------------------------------------------------------------
# phase 11: GvinsModel with extrinsic and td estimation on: the drifted-clock
# world of tests/test_td_estimation.py and the hard-cadence stability world
# of tests/test_gvins_stability_e2e.py
# --------------------------------------------------------------------------

TD_TRUE = 0.03                   # s: the td world's images are exposed this long after their stamps
TD_TURN = 30.0                   # s: the td world's turn (a 36 s drive)
# tests/test_td_estimation.py:32-61 (its camera is SMALL_CAMERA, q_b_c identity,
# t_b_c 0, td_b_c 0: the estimator starts believing there is no delay)
TD_RAW = dict(initlength=3, imudatarate=200, iswithearth=False,
              imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
              optimize_windows_size=8, optimize_num_iterations=20, optimize_estimate_extrinsic=False,
              optimize_estimate_td=True, track_min_parallax=20, track_max_interval=0.5, track_max_features=120,
              reprojection_error_std=1.5, node_slots=20, landmark_slots=256, gnss_slots=20, reproj_slots=1024)
STAB_DURATION = 90.0             # s: the stability world's drive here (cut from the JAX test's 300 s)
STAB_CAMERA, STAB_BLOB = LONG_CAMERA, LONG_BLOB   # the same 160x120 camera and renderer as the long world's
# tests/test_gvins_stability_e2e.py:74-104 (its camera is STAB_CAMERA): both
# estimations on, a keyframe on most parallax-bearing frames
STAB_RAW = dict(initlength=3, imudatarate=200, iswithearth=False,
                imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
                optimize_windows_size=10, optimize_num_iterations=20, optimize_estimate_extrinsic=True,
                optimize_estimate_td=True, track_min_parallax=8, track_max_interval=0.5, track_max_features=80,
                reprojection_error_std=1.5, node_slots=20, landmark_slots=256, gnss_slots=20, reproj_slots=1024)
STAB_PROFILED = (100, 103)       # keyframe episodes run under torch.profiler (the busy share)
# gates of that test the JAX package's own replay of this world fails at the
# port's precision (its f64 solve, sync dispatch) at a drive of the test's own
# ICGVINS_STAB_DURATION (tests/test_torch_stability.py::test_jax_stability_spread,
# ROADMAP R5, R6): where the port's replay reaches the end and fails one of
# them, the failure is printed and left standing
STAB_JAX_F64_FAILS = {
    "marginalizations": "the JAX package's replay of this world at f64 with sync dispatch counts fewer than its "
                        "test asks at 120, 180 and 300 s (29 of 40, 32 of 60, 52 of 100) and, through its other "
                        "CPU level tracker (ICGVINS_LK=gather), stops at the marg_cap refusal after 59.13 s of 90 s "
                        "(ROADMAP R6)",
    "|t_b_c| m": "the extrinsic is not observable on this world and its gate lets it walk: the JAX package's replay "
                 "at f64 with sync dispatch ends at 1.026 m at 120 s and stands at 1.452 m at its refusal in the "
                 "150 s drive (0.371 m at 90 s, 0.372 m at 300 s; ROADMAP R5)",
}
TD_CUDA_CPU_TOL = 1e-5           # s: the td world's final td, CUDA against CPU (positions: GVINS_CUDA_CPU_TOL)
STAB_TWIN_UNTIL = 35.0           # s: the stability world's CPU twin replays the frames before this stamp
STAB_CUDA_CPU_TOL = 1e-3         # m: its episode positions, CUDA against CPU, before the replays part


def td_world(cam_mod, rot_np, turn_duration=TD_TURN):
    """A copy of tests/test_td_estimation.py's world without jax: the drive
    of ``gins_world(turn_duration=turn_duration)`` (earth off; 30 s there, a
    36 s drive), tests/test_gvins_e2e.py's 320x240 camera and 800 ground
    points (``e2e_scene``), frames at 10 Hz from 0.05 s to 0.25 s before the
    drive's end whose images show the true pose TD_TRUE after their stamps
    (the camera's clock 30 ms behind). Returns (imu, gnss, truth,
    frame_times, frame) with frame(k) the (H, W) f64 image of frame k."""
    imu, gnss, truth = gins_world(turn_duration=turn_duration, seed=SEED)
    camera = cam_mod.PinholeCamera.from_config(*SMALL_CAMERA)
    pts_w = e2e_scene()
    frame_times = np.arange(0.05, imu["time"][-1] - 0.25, 0.1)

    def frame(k):
        i = min(int(round((frame_times[k] + TD_TRUE) * 200.0)) - 1, len(truth["p"]) - 1)
        return ground_frame(cam_mod, camera, pts_w, rot_np.to_matrix(truth["q"][i]), truth["p"][i], *SMALL_BLOB)
    return imu, gnss, truth, frame_times, frame


def stab_outage(duration):
    """tests/test_gvins_stability_e2e.py's GNSS outage: 20 s from 0.45 of the drive."""
    return 0.45 * duration, 0.45 * duration + 20.0


def stability_world(cam_mod, rot_np, duration=STAB_DURATION):
    """A copy of tests/test_gvins_stability_e2e.py's world without jax: the
    drive of ``gins_world(turn_duration=duration - 6)`` (earth off) with its
    GNSS fixes in ``stab_outage(duration)`` removed, 9000 ground points 9-13
    m below from default_rng(11) over [-90, 150]^2 m, frames at 10 Hz of the
    160x120 camera (FX 125, radtan [-0.05, 0.01, 0, 0]) at the true body
    pose, rendered as that test's ``_render`` renders them (``ground_frame``
    with sigma 1.6 px cut at 5 px: +-80 gray blobs at the distorted
    projections over 90 gray). Returns (imu, gnss, truth, frame_times,
    frame)."""
    imu, gnss, truth = gins_world(turn_duration=duration - 6.0, seed=SEED)
    lo, hi = stab_outage(duration)
    keep = ~((gnss["time"] >= lo) & (gnss["time"] < hi))
    gnss = {k: v[keep] for k, v in gnss.items()}
    rng = np.random.default_rng(11)
    n_pts = 9000
    pts_w = np.stack([rng.uniform(-90, 150, n_pts), rng.uniform(-90, 150, n_pts), rng.uniform(9, 13, n_pts)], axis=1)
    camera = cam_mod.PinholeCamera.from_config(*STAB_CAMERA)
    frame_times = np.arange(0.05, imu["time"][-1] - 0.2, 0.1)

    def frame(k):
        i = min(int(round(frame_times[k] * 200.0)) - 1, len(truth["p"]) - 1)
        return ground_frame(cam_mod, camera, pts_w, rot_np.to_matrix(truth["q"][i]), truth["p"][i], *STAB_BLOB)
    return imu, gnss, truth, frame_times, frame


class EstimationLog:
    """The JAX tests' hooks on one model, wrapped on the instance so that
    the class runs unmodified (tests/test_gvins_stability_e2e.py:130-160,
    tests/test_td_estimation.py:83-89): frames, keyframe episodes and
    marginalizations counted (``counts``); the state and node count after
    every processed frame (``states``); for every episode the frames
    processed so far, the newest node's time, the GNSS fixes in the window
    and the reprojection rows packed (``episodes``);
    ``est.check_time_consistency`` after
    every ``_optimize_visual`` (``failures``: (episode, messages, whether
    ``snapped_only``) where it found a violation); after every
    ``_update_from_optimizer`` the adopted td (``tds``) and the gates'
    decisions (``decisions``: (td, extrinsic), each True for adopted, False
    for refused, None where the gate did not run), and where the extrinsic
    gate runs the size of the solved translation it judges
    (``ext_estimates``, m). Works on the port's
    ``GvinsModel`` and the JAX package's alike (their update methods take
    ``(slots)`` and ``(params, slots)``)."""

    def __init__(self, model):
        self.counts = dict(frames=0, episodes=0, margs=0)
        self.states, self.failures, self.tds, self.decisions, self.episodes = [], [], [], [], []
        self.ext_estimates = []
        frame, optimize, marg, update, build = (model._process_frame, model._optimize_visual,
                                                model._marginalize_visual_impl, model._update_from_optimizer,
                                                model._build_reproj_table)

        def counting_frame(stream, stamp, image):
            self.counts["frames"] += 1
            out = frame(stream, stamp, image)
            self.states.append((model.state, model.est.n_nodes if model.est else 0))
            return out

        def checking_opt():
            self.counts["episodes"] += 1
            rows = []

            def counted(slots):
                table, n = build(slots)
                rows.append(int(n))
                return table, n
            model._build_reproj_table = counted
            try:
                out = optimize()
            finally:
                model._build_reproj_table = build
            est = model.est
            self.episodes.append((self.counts["frames"], float(est.times[est.n_nodes - 1]), len(est.gnss_entries),
                                  sum(rows)))
            msgs = model.est.check_time_consistency(where=f"episode {self.counts['episodes']}")
            if msgs:
                self.failures.append((self.counts["episodes"], msgs, snapped_only(model.est)))
            return out

        def counting_marg():
            self.counts["margs"] += 1
            return marg()

        def recording_update(*args):
            cfg, normal = model.cfg, model.state == "TRACKING_NORMAL"
            td0, t0 = model.td_b_c, np.array(model.pose_b_c_t, copy=True)
            if cfg.optimize_estimate_extrinsic and normal:     # the solved extrinsic the gate judges
                ext = args[0].ext if len(args) == 2 else model.est.ext
                self.ext_estimates.append(float(np.linalg.norm(np.asarray(ext)[:3])))
            out = update(*args)
            self.tds.append(float(model.td_b_c))
            self.decisions.append((model.td_b_c != td0 if cfg.optimize_estimate_td and normal else None,
                                   not np.array_equal(model.pose_b_c_t, t0)
                                   if cfg.optimize_estimate_extrinsic and normal else None))
            return out

        model._process_frame, model._optimize_visual = counting_frame, checking_opt
        model._marginalize_visual_impl, model._update_from_optimizer = counting_marg, recording_update

    def adoptions(self):
        """(td, extrinsic) adoptions and refusals: {"td": (adopted, refused), ...}."""
        return {name: (sum(d[i] is True for d in self.decisions), sum(d[i] is False for d in self.decisions))
                for i, name in enumerate(("td", "extrinsic"))}


def snapped_only(est):
    """Whether every interval that ``est.check_time_consistency`` flags is
    valid, ends on its node and differs from its node gap by at most
    1e-4 s: the IMU sample that ``ImuStream.series`` takes whole when a node
    lies within MINIMUM_TIME_INTERVAL (1e-4 s) of it (engine/replay.py, as
    the reference's getImuSeriesFromTo, misc.cc:307-361, and the JAX
    package's ImuStream take it), while the check allows 1e-6 s. A node
    stamped frame time + td lands there once td is not a whole number of
    IMU periods (ROADMAP R4)."""
    dts, ends, valid = est.preint_table.summ.dt, est.preint_table.summ.end_time, est.preint_table.valid
    for k in range(est.n_nodes - 1):
        gap = est.times[k + 1] - est.times[k]
        if valid[k] != 1.0 or abs(ends[k] - est.times[k + 1]) > 1e-6 or abs(dts[k] - gap) > 1e-4 + 1e-9:
            return False
    return all(valid[k] == 0.0 for k in range(max(est.n_nodes - 1, 0), est.wcfg.P))


class PartingTrace:
    """One record a frame of a replay, for finding where two replays of one
    world part (``first_parting``): the frame's stamp, whether it was
    tracked, the model's state and node count after it, the keyframe
    decision and the parallax behind it, the tracked landmarks' ids and
    distorted pixels, td and t_b_c, the newest trajectory row where the
    frame ran an episode and the size of the extrinsic translation its solve
    returned, the window slides so far (``_marginalize_visual``
    and the node-capacity sheds), and for an episode each landmark's
    reprojection errors (px) over its keyframe observations as the outlier
    culling judges them and the landmarks it culled. Landmark ids count
    from the model's first, so that replays in one process compare. Install
    after the ``EstimationLog``. Works on the port's ``GvinsModel`` and the
    JAX package's alike (each with its own camera and map modules)."""

    def __init__(self, model):
        cam = sys.modules[type(model.camera).__module__]
        Landmark = sys.modules[type(model.vmap).__module__].Landmark

        self.rows, base = [], Landmark._next_id
        process, cull = model._process_frame, model._visual_outlier_culling
        episode = {}

        def judged(slots):
            errs = {}
            for lm_id in slots:
                lm = model.vmap.landmarks.get(lm_id)
                if lm is None or lm.outlier:
                    continue
                obs = [o for o in lm.observations
                       if not o.outlier and o.frame.is_keyframe and model.vmap.is_keyframe_in_map(o.frame)]
                pc = [o.frame.R.T @ (lm.pos - o.frame.t) for o in obs]
                errs[lm_id - base] = [float(np.linalg.norm(cam.cam2pixel(model.camera, p) - o.undis))
                                      for p, o in zip(pc, obs)]
            out = cull(slots)
            episode.update(errs=errs, culled=sorted(i for i in errs if base + i not in model.vmap.landmarks))
            return out
        model._visual_outlier_culling = judged

        def traced(stream, stamp, image):
            trk, cur, n_traj = model.tracker, model.tracker.frame_cur, len(model.trajectory)
            out = process(stream, stamp, image)
            tracked = trk.frame_cur is not cur
            feats = trk.frame_cur.features if tracked else {}
            ids = np.array(sorted(feats), np.int64)
            dis = np.array([feats[i].dis for i in ids], np.float64).reshape(-1, 2)
            kf = bool(tracked and trk.is_new_keyframe)
            self.rows.append(dict(
                stamp=float(stamp), tracked=tracked, state=model.state, n_nodes=model.est.n_nodes if model.est else 0,
                kf=kf,
                parallax=float(trk.logging_row[2]) if kf and trk.logging_row else float("nan"), ids=ids - base,
                dis=dis, td=float(model.td_b_c),
                t_b_c=np.array(model.pose_b_c_t, np.float64),
                traj=np.array(model.trajectory[-1], np.float64) if len(model.trajectory) > n_traj else None,
                ext_solved=float(np.linalg.norm(np.asarray(model.est.ext)[:3]))
                if len(model.trajectory) > n_traj else None,
                slides=sum(model.tier_counts_marg.values()), errs=episode.pop("errs", None),
                culled=episode.pop("culled", [])))
            return out
        model._process_frame = traced


def first_parting(a, b):
    """The first frame at which two ``PartingTrace`` records part: a frame
    tracked in one only, another state, node count, keyframe decision,
    set of tracked landmarks, episode, window slide or td/extrinsic
    adoption. Returns (frame index or None, what differs there, the largest
    differences before it (pixels of common landmarks, episode positions,
    td), the two rows there)."""
    before = dict(px=0.0, pos_m=0.0, td_s=0.0)
    for k, (ra, rb) in enumerate(zip(a, b)):
        diff = [name for name in ("stamp", "tracked", "state", "n_nodes", "kf", "slides") if ra[name] != rb[name]]
        if not np.array_equal(ra["ids"], rb["ids"]):
            diff.append("landmarks")
        if (ra["traj"] is None) != (rb["traj"] is None):
            diff.append("episode")
        if k and ((ra["td"] != a[k - 1]["td"]) != (rb["td"] != b[k - 1]["td"])):
            diff.append("td adoption")
        if k and (not np.array_equal(ra["t_b_c"], a[k - 1]["t_b_c"])) != (
                not np.array_equal(rb["t_b_c"], b[k - 1]["t_b_c"])):
            diff.append("extrinsic adoption")
        if diff:
            return k, diff, before, (ra, rb)
        if len(ra["ids"]):
            before["px"] = max(before["px"], float(np.abs(ra["dis"] - rb["dis"]).max()))
        if ra["traj"] is not None:
            before["pos_m"] = max(before["pos_m"], float(np.abs(ra["traj"][1:4] - rb["traj"][1:4]).max()))
        before["td_s"] = max(before["td_s"], abs(ra["td"] - rb["td"]))
    return None, [], before, None


def describe_parting(name_a, name_b, a, b, min_parallax):
    """``first_parting`` of two traces as one printable line."""
    k, diff, before, rows = first_parting(a, b)
    if k is None:
        return f"{name_a} / {name_b}: no parting over {min(len(a), len(b))} frames (before the end: {before})"
    ra, rb = rows
    what = []
    if "kf" in diff:
        what.append(f"keyframe {ra['kf']} / {rb['kf']} at parallax {ra['parallax']:.6f} / {rb['parallax']:.6f} px "
                    f"(threshold {min_parallax})")
    if "landmarks" in diff:
        only_a, only_b = np.setdiff1d(ra["ids"], rb["ids"]), np.setdiff1d(rb["ids"], ra["ids"])
        what.append(f"landmarks {len(ra['ids'])} / {len(rb['ids'])} (only in {name_a}: {only_a.tolist()[:6]}, "
                    f"only in {name_b}: {only_b.tolist()[:6]})")
        for i in [*only_a.tolist(), *only_b.tolist()][:4]:
            judged = [(r["errs"] or {}).get(i) for r in rows]
            if any(e is not None for e in judged):
                what.append(f"landmark {i}: culled {[i in r['culled'] for r in rows]}, reprojection errors "
                            f"{[np.round(e, 4).tolist() if e else e for e in judged]} px (culled above "
                            f"{STAB_RAW['reprojection_error_std'] * 3:g} px on one or a mean above "
                            f"{STAB_RAW['reprojection_error_std']:g} px)")
    if ra["ext_solved"] is not None and rb["ext_solved"] is not None:
        what.append(f"the episode's solved |t_b_c| {ra['ext_solved']:.4f} / {rb['ext_solved']:.4f} m (adopted "
                    f"{np.linalg.norm(ra['t_b_c']):.4f} / {np.linalg.norm(rb['t_b_c']):.4f} m)")
    if "td adoption" in diff:
        what.append(f"td {a[k - 1]['td']:.9f} -> {ra['td']:.9f} / {b[k - 1]['td']:.9f} -> {rb['td']:.9f} s")
    if "extrinsic adoption" in diff:
        what.append(f"|t_b_c| {np.linalg.norm(ra['t_b_c']):.6f} / {np.linalg.norm(rb['t_b_c']):.6f} m")
    if "slides" in diff:
        what.append(f"slides {ra['slides']} / {rb['slides']}")
    return (f"{name_a} / {name_b}: part at frame {k} ({ra['stamp']:.2f} s) on {diff}: {'; '.join(what)}; before "
            f"it at most {before['px']:.3g} px apart on common landmarks, episode positions {before['pos_m']:.3g} m, "
            f"td {before['td_s']:.3g} s")


def stab_errs(traj, truth, t_lo=0.0, t_hi=1e9, exclude=()):
    """tests/test_gvins_stability_e2e.py's ``_errs``: the position errors of
    the trajectory rows stamped in [t_lo, t_hi] and outside each excluded
    window widened by 2 s before and 3 s after."""
    offset = truth["gnss_local"][0]
    errs = []
    for row in traj:
        t, p = row[0], np.asarray(row[1:4])
        if not (t_lo <= t <= t_hi) or any(lo - 2.0 <= t <= hi + 3.0 for lo, hi in exclude):
            continue
        i = int(round(t * 200.0)) - 1
        if 0 <= i < len(truth["p"]):
            errs.append(np.linalg.norm(p + offset - truth["p"][i]))
    return np.asarray(errs)


def stability_gates(model, traj, truth, counts, failures, duration):
    """The seven tests of tests/test_gvins_stability_e2e.py as gates, their
    thresholds scaled to a drive of ``duration`` s as there: [(test, name,
    value, limit, met, needs)], ``needs`` the stamp a replay must pass
    before a gate that is not met can be judged (0 for a gate judged on any
    span)."""
    outage, scale, end = stab_outage(duration), duration / 300.0, duration - 5.0
    last = float(traj[-1][0]) if len(traj) else float("nan")
    outside = stab_errs(traj, truth, t_lo=8.0, exclude=(outage,))
    tail = stab_errs(traj, truth, t_lo=0.9 * duration)
    bridge = stab_errs(traj, truth, t_lo=outage[0], t_hi=outage[1] + 2.0)
    top = lambda e, f: float(f(e)) if len(e) else float("nan")  # noqa: E731
    rot = float(np.degrees(np.arccos(np.clip(0.5 * (np.trace(model.pose_b_c_R) - 1.0), -1, 1))))
    t_norm = float(np.linalg.norm(model.pose_b_c_t))
    frames = max(counts["frames"], 1)
    kf_ratio, marg_ratio = counts["episodes"] / frames, counts["margs"] / frames
    return [
        ("survives_full_horizon", "state at the end", model.state, "TRACKING_NORMAL",
         model.state == "TRACKING_NORMAL", end),
        ("survives_full_horizon", "last node s", last, f"> {end:g}", last > end, end),
        ("hundreds_of_window_slides", "keyframe episodes", counts["episodes"], f">= {400 * scale:g}",
         counts["episodes"] >= 400 * scale, end),
        ("hundreds_of_window_slides", "marginalizations", counts["margs"], f">= {100 * scale:g}",
         counts["margs"] >= 100 * scale, end),
        ("bounded_error_over_horizon", "nodes outside the outage", len(outside), "> 100", len(outside) > 100, end),
        ("bounded_error_over_horizon", "mean error outside the outage m", top(outside, np.mean), "< 0.3",
         top(outside, np.mean) < 0.3, 0.0),
        ("bounded_error_over_horizon", "mean error in the last tenth m", top(tail, np.mean), "< 0.3",
         top(tail, np.mean) < 0.3, end),
        ("outage_bridged", "bridge nodes", len(bridge), "> 3", len(bridge) > 3, outage[1] + 2.0),
        ("outage_bridged", "bridge max error m", top(bridge, np.max), "< 3.0", top(bridge, np.max) < 3.0,
         outage[1] + 2.0),
        ("td_extrinsic_drift_bounded", "|td| s", abs(model.td_b_c), "<= 0.081", abs(model.td_b_c) <= 0.081, 0.0),
        ("td_extrinsic_drift_bounded", "|t_b_c| m", t_norm, "< 0.5", t_norm < 0.5, 0.0),
        ("td_extrinsic_drift_bounded", "R_b_c angle deg", rot, "< 5", rot < 5.0, 0.0),
        ("time_consistency_every_episode", "episodes with violations", len(failures), "== 0", not failures, 0.0),
        ("cadence_floors_hold", "kf_ratio", kf_ratio, "<= 0.5", kf_ratio <= 0.5, 0.0),
        ("cadence_floors_hold", "marg_ratio", marg_ratio, "<= 0.5", marg_ratio <= 0.5, 0.0),
    ]


def judge(tag, gates, stop, standing=None):
    """Prints each gate as ok, FAILED or, where a replay stopped at ``stop``
    before the stamp a gate needs, NOT MET; a failed gate named in
    ``standing`` (name: reason) prints FAILED with its reason and is left
    standing. Returns (failed, not met or left standing)."""
    failed, not_reached = [], []
    for test, name, value, limit, ok, needs in gates:
        if ok:
            verdict = "ok"
        elif stop is not None and stop < needs:
            verdict = f"NOT MET (the replay stopped at {stop:.2f} s, before {needs:.1f} s)"
            not_reached.append(name)
        elif name in (standing or {}):
            verdict = f"FAILED, left standing: {standing[name]}"
            not_reached.append(name)
        else:
            verdict = "FAILED"
            failed.append(name)
        print(f"[{tag}] gate {test}: {name} {value} (limit {limit}) {verdict}")
    return failed, not_reached


def td_gates(model, traj, tds):
    """tests/test_td_estimation.py's gates: [(test, name, value, limit, met,
    needs)] as ``stability_gates``."""
    tds = np.asarray(tds, np.float64)
    peak = float(tds.max()) if len(tds) else float("nan")
    return [("td_converges_to_true_offset", "state at the end", model.state, "TRACKING_NORMAL",
             model.state == "TRACKING_NORMAL", 1e9),
            ("td_converges_to_true_offset", "|td - 0.03| s", abs(model.td_b_c - TD_TRUE), "< 0.012",
             abs(model.td_b_c - TD_TRUE) < 0.012, 1e9),
            ("td_converges_to_true_offset", "max td s", peak, "> 0.015", peak > 0.015, 1e9),
            ("td_trajectory_still_converges", "trajectory nodes", len(traj), "> 30", len(traj) > 30, 1e9),
            ("td_trajectory_still_converges", "all finite", bool(np.isfinite(traj).all()), "True",
             bool(np.isfinite(traj).all()), 0.0)]


def estimation_run(torch, device, cfg, imu, gnss, frame_times, images, profiled=None, trace=False, faults=False):
    """The port's GvinsModel on ``device`` over a world with an
    ``EstimationLog`` and a ``FrameLog`` (a torch.profiler window over the
    keyframe episodes ``profiled``), with ``trace`` a ``PartingTrace`` and
    with ``faults`` a ``FaultLog``; a refusal of a slide of more than
    marg_cap nodes (the JAX package's, taken over unchanged) stops the run
    and is returned. Returns a namespace: model, log, frames (the FrameLog),
    trace (the PartingTrace's rows or None), faults (the FaultLog or None),
    traj (the model's trajectory rows), wall seconds, refused (None or the
    error), stop (the stamp of the last frame finished where refused)."""
    import types

    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.models import gvins as gvins_mod

    refused = None
    with FrameLog(torch, gvins_mod, fetch, profiled) as frames:
        model = gvins_mod.GvinsModel(cfg, device=device)
        log = EstimationLog(model)
        traced = PartingTrace(model) if trace else None
        fault_log = FaultLog(model) if faults else None
        sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        try:
            model.run(imu, gnss, frame_times, lambda k: images[k])
        except ValueError as e:          # the JAX package's refusal, taken over unchanged
            if "exceeds marg_cap" not in str(e):
                raise
            refused = e
        sync()
        wall = time.perf_counter() - t0
    traj = np.asarray(model.trajectory) if model.trajectory else np.zeros((0, 8))
    stop = frames.rows[-1][5] if refused is not None and frames.rows else None
    return types.SimpleNamespace(model=model, log=log, frames=frames, trace=traced.rows if traced else None,
                                 faults=fault_log, traj=traj, wall=wall, refused=refused, stop=stop)


def world_inputs(world, length):
    """The td world at turn ``length`` (``world`` "td") or the stability
    world at ``length`` s ("stab") as a replay takes it: (imu, gnss, truth,
    frame_times, images, the parsed configuration, the camera, the camera
    module, seconds taken)."""
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.vision import camera as cam

    t0 = time.perf_counter()
    make, raw, camera = (td_world, TD_RAW, SMALL_CAMERA) if world == "td" else (stability_world, STAB_RAW, STAB_CAMERA)
    imu, gnss, truth, frame_times, frame = make(cam, rotation_np, length)
    images = [frame(k) for k in range(len(frame_times))]
    return (imu, gnss, truth, frame_times, images, gvins_config(parse_config, truth, raw, camera),
            cam.PinholeCamera.from_config(*camera), cam, time.perf_counter() - t0)


def td_replay(device, cores=None, turn_duration=TD_TURN):
    """The port's GvinsModel on the td world on ``device``: (the state and
    node count after every frame, the trajectory, the td after every update,
    the final state and td, wall seconds). With ``cores``, it keeps to the
    host's last ``cores`` cores with as many torch threads (the CPU twin of
    phase 11, in a child process)."""
    import torch

    keep_to_cores(torch, cores)
    imu, gnss, _, frame_times, images, cfg, *_ = world_inputs("td", turn_duration)
    run = estimation_run(torch, device, cfg, imu, gnss, frame_times, images)
    assert run.refused is None, run.refused
    return run.log.states, run.traj, run.log.tds, run.model.state, run.model.td_b_c, run.wall


def keep_to_cores(torch, cores):
    """With ``cores``, keeps this process to the host's last ``cores``
    cores (at most half of them) with as many torch threads."""
    if cores:
        allowed = sorted(os.sched_getaffinity(0))
        cores = min(cores, max(len(allowed) // 2, 1))
        os.sched_setaffinity(0, allowed[-cores:])
        torch.set_num_threads(cores)


def _kernel_modules():
    from ic_gvins_tpu_torch.ops import clahe as kclahe
    from ic_gvins_tpu_torch.ops import lk as klk
    from ic_gvins_tpu_torch.ops import subpix as ksubpix
    from ic_gvins_tpu_torch.vision import features as feat
    from ic_gvins_tpu_torch.vision import map as vmap_mod
    from ic_gvins_tpu_torch.vision import pyramid
    from ic_gvins_tpu_torch.vision import tracking as trk

    return kclahe, klk, ksubpix, pyramid, feat, trk, vmap_mod


def counted_run(wrappers, run_fn):
    """run_fn() with the kernels' launch counters set to 0 just before and
    read just after: (its result, the launches)."""
    for w in wrappers.values():
        w.launches = 0
    out = run_fn()
    return out, {k: w.launches for k, w in wrappers.items()}


def td_check(torch, card, wrappers):
    """The td world on the card at TD_TURN: each kernel against its plain
    version on frames 199-200, then the replay with the counters set to 0
    just before and read just after and tests/test_td_estimation.py's gates.
    Returns (launches, failed gates, gates not met, (state, td, trajectory,
    states after every frame))."""
    imu, gnss, _, frame_times, images, cfg, camera, _, secs = world_inputs("td", TD_TURN)
    print(f"[td] world: {len(imu['time'])} IMU samples, {len(gnss['time'])} GNSS fixes, {len(frame_times)} frames "
          f"320x240 exposed {TD_TRUE} s after their stamps, made in {secs:.2f} s on the CPU")
    long_kernel_checks(torch, _kernel_modules(), lambda k: images[k], cfg, camera, checked={"normal": (199, 200)},
                       min_joints={"normal": 15}, label="td world")
    run, launches = counted_run(wrappers, lambda: estimation_run(torch, DEVICE, cfg, imu, gnss, frame_times, images))
    m, log = run.model, run.log
    sim_s = float((run.stop if run.stop is not None else imu["time"][-1]) - imu["time"][0])
    print(f"[td] replay {sim_s:.2f} s simulated in {run.wall:.3f} s wall: {sim_s / run.wall:.3f} sim-s per wall-s; "
          f"{log.counts} (frames, keyframe episodes, marginalizations); solver tiers {m.tier_counts}; launches "
          f"{launches} ({card})")
    print(f"[td] td after each update (s): {[round(t, 5) for t in log.tds]}")
    print(f"[td] gate decisions (adopted, refused): {log.adoptions()}; final td {m.td_b_c:.6f} s (true {TD_TRUE}); "
          f"check_time_consistency found violations after {len(log.failures)} episodes")
    if run.refused is not None:
        print(f"[td] the replay stopped after the frame at {run.stop:.2f} s: {run.refused}")
    failed, not_met = judge("td", td_gates(m, run.traj, log.tds), run.stop)
    return launches, failed, not_met, (m.state, m.td_b_c, run.traj, log.states)


def stability_check(torch, card, wrappers, duration=STAB_DURATION):
    """The stability world on the card at ``duration`` s: each kernel against
    its plain version on frames 299-300, then the replay with the counters
    set to 0 just before and read just after, STAB_PROFILED's episodes under
    torch.profiler, and tests/test_gvins_stability_e2e.py's seven gates at
    their thresholds for ``duration``. Returns (launches, failed gates, gates
    not met or left standing, the replay's ``PartingTrace``)."""
    from ic_gvins_tpu_torch.core import rotation_np

    outage = stab_outage(duration)
    imu, gnss, truth, frame_times, images, cfg, camera, _, secs = world_inputs("stab", duration)
    print(f"[stab] world: {duration:g} s drive, {len(imu['time'])} IMU samples, {len(gnss['time'])} GNSS fixes "
          f"(outage {outage}), {len(frame_times)} frames 160x120, made in {secs:.2f} s on the CPU")
    long_kernel_checks(torch, _kernel_modules(), lambda k: images[k], cfg, camera, checked={"normal": (299, 300)},
                       min_joints={"normal": 5}, label="stability world")
    run, launches = counted_run(wrappers, lambda: estimation_run(torch, DEVICE, cfg, imu, gnss, frame_times, images,
                                                                 profiled=STAB_PROFILED, trace=True))
    m, log, c = run.model, run.log, run.log.counts
    sim_s = float((run.stop if run.stop is not None else imu["time"][-1]) - imu["time"][0])
    print(f"[stab] replay {sim_s:.2f} s simulated in {run.wall:.3f} s wall ({run.frames.prof_frames_s:.3f} s of it the "
          f"frames under torch.profiler, episodes {STAB_PROFILED[0]}-{STAB_PROFILED[1] - 1}; in phase 11 its CPU "
          f"twins run beside it with {GVINS_TWIN_CORES} threads): {sim_s / run.wall:.3f} sim-s per wall-s; "
          f"{c['frames']} frames, {c['episodes']} keyframe episodes, {c['margs']} marginalizations, kf_ratio "
          f"{c['episodes'] / max(c['frames'], 1):.4f}, marg_ratio {c['margs'] / max(c['frames'], 1):.4f}; solver "
          f"tiers {m.tier_counts}, marginalization tiers {m.tier_counts_marg}; launches {launches} ({card})")
    bridge = stab_errs(run.traj, truth, t_lo=outage[0], t_hi=outage[1] + 2.0)
    gnss_free = [(round(t, 2), rows) for _, t, n_gnss, rows in log.episodes if n_gnss == 0]
    print(f"[stab] episodes with no GNSS fix in the window (newest node s, reprojection rows): {len(gnss_free)}, "
          f"from {gnss_free[:1]} to {gnss_free[-1:]}; rows in each: min "
          f"{min((r for _, r in gnss_free), default=0)}")
    print(f"[stab] gate decisions (adopted, refused): {log.adoptions()}; final td {m.td_b_c:.6f} s, t_b_c "
          f"{m.pose_b_c_t} m, R_b_c {rotation_np.matrix_to_euler(m.pose_b_c_R) * 180 / np.pi} deg; bridge max error "
          f"{float(bridge.max()) if len(bridge) else float('nan'):.4f} m over {len(bridge)} nodes")
    frames = run.frames
    if frames.prof_wall_ms is None:
        print(f"[stab] profiler: the window {STAB_PROFILED} was not completed")
    else:
        kernels, busy = device_activity(torch, frames.prof, frames.prof_wall_ms)
        if kernels is None:
            print("[stab] profiler: no device events in the trace; busy share not measured")
        else:
            print(f"[stab] profiler, episodes {STAB_PROFILED[0]}-{STAB_PROFILED[1] - 1} and the frames between: "
                  f"{kernels / (STAB_PROFILED[1] - STAB_PROFILED[0]):.0f} CUDA kernels per episode, device busy "
                  f"{busy:.2f} of {frames.prof_wall_ms:.2f} ms = {100 * busy / frames.prof_wall_ms:.1f} % ({card})")
    if run.refused is not None:
        print(f"[stab] the replay stopped after the frame at {run.stop:.2f} s: {run.refused} (the JAX package "
              f"refuses such a slide alike: ROADMAP R1)")
    print(f"[stab] check_time_consistency found violations after {len(log.failures)} of {c['episodes']} episodes: "
          f"{[(e, msgs) for e, msgs, _ in log.failures[:5]]}{' ...' if len(log.failures) > 5 else ''}")
    scatter = float(np.median(log.ext_estimates)) if log.ext_estimates else float("nan")
    print(f"[stab] the extrinsic translations the solve returned to the gate: {len(log.ext_estimates)}, median "
          f"size {scatter:.3f} m, largest {max(log.ext_estimates, default=float('nan')):.3f} m")
    standing = dict(STAB_JAX_F64_FAILS) if run.refused is None else {}
    if log.failures and all(snapped for *_, snapped in log.failures):
        standing["episodes with violations"] = (
            "every one is an interval that ends on its node with a dt within 1e-4 s of its node gap, the IMU sample "
            "ImuStream.series takes whole when a td-shifted node lies within 1e-4 s of it; the JAX package makes "
            "the same violations on this world (ROADMAP R4)")
    bridged = [(t, rows) for t, rows in gnss_free if outage[0] <= t < outage[1] and rows > 0]
    evidence = [("outage_bridged", "GNSS-free episodes with reprojection rows in the outage", len(bridged), ">= 1",
                 len(bridged) >= 1, outage[1] + 2.0)]
    failed, not_met = judge("stab", stability_gates(m, run.traj, truth, c, log.failures, duration) + evidence,
                            run.stop, standing)
    return launches, failed, not_met, run.trace


STAB_VARIANTS = ("kernels", "deterministic", "plain kernels")


def stab_trace_run(torch, device, duration, variant="kernels", cores=None, until=None):
    """The stability world at ``duration`` s through the port on ``device``
    with a ``PartingTrace``. ``variant``: "kernels" as phase 11 runs it;
    "deterministic" under ``torch.use_deterministic_algorithms`` (torch's
    deterministic form of every op that has one); "plain
    kernels" with the frontend's three kernel wrappers swapped for their
    plain versions on the same device. With ``cores``, it keeps to the
    host's last ``cores`` cores with as many torch threads. With ``until``,
    the replay ends with the frames stamped before ``until`` s (the world
    is the same). Returns (a summary dict, the trace)."""
    from ic_gvins_tpu_torch.ops import clahe, lk, subpix
    from ic_gvins_tpu_torch.vision import features, pyramid
    from ic_gvins_tpu_torch.vision import lk as vlk

    keep_to_cores(torch, cores)
    imu, gnss, truth, frame_times, images, cfg, *_ = world_inputs("stab", duration)
    if until is not None:
        imu = {k: v[imu["time"] <= until + 1.0] for k, v in imu.items()}
        gnss = {k: v[gnss["time"] < until] for k, v in gnss.items()}
        frame_times = frame_times[frame_times < until]
    swaps = []
    if variant == "plain kernels":
        swaps = [(vlk, "lk_pyr", lambda *a, iters=None, **kw: lk.lk_pyr_plain(*a, **kw)),
                 (pyramid, "clahe_apply", clahe.clahe_apply_plain),
                 (features, "subpix", lambda img, c, v, iters=None: subpix.subpix_plain(img, c, v, steps=iters))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    torch.use_deterministic_algorithms(variant == "deterministic", warn_only=True)
    try:
        run = estimation_run(torch, device, cfg, imu, gnss, frame_times, images, trace=True)
    finally:
        torch.use_deterministic_algorithms(False)
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    m, c = run.model, run.log.counts
    gates = stability_gates(m, run.traj, truth, c, run.log.failures, duration)
    outage = stab_outage(duration)
    bridge = stab_errs(run.traj, truth, t_lo=outage[0], t_hi=outage[1] + 2.0)
    summary = dict(device=device, variant=variant, threads=torch.get_num_threads(), stop=run.stop,
                   wall_s=round(run.wall, 3), **c, capacity_sheds=sum(m.tier_counts_marg.values()) - c["margs"],
                   td=m.td_b_c, t_b_c_m=float(np.linalg.norm(m.pose_b_c_t)),
                   bridge_max_m=float(bridge.max()) if len(bridge) else None,
                   not_met=[name for _, name, _, _, ok, _ in gates if not ok])
    return summary, run.trace


def stability_parting(out_dir, duration=STAB_DURATION, variants=STAB_VARIANTS, repeats=2):
    """Where the stability world's replays part: on the card ``repeats``
    times as phase 11 runs it ("kernels"), once in each other of
    ``variants``, and on the CPU (this script run again as a child process
    with GVINS_TWIN_CORES threads, from the start). Prints each run's
    counts, slides and unmet gates, then the first frame at which two runs
    of the kernels part, each other variant parts from them and each
    card run parts from the CPU, and what differs there; writes the traces
    to ``out_dir``/stability_traces.pkl. Run it on the card as ``python3
    chip_smoke.py --stab-parting OUT_DIR [SECONDS [VARIANT,...]]``."""
    import torch

    card = the_card(torch)
    os.makedirs(out_dir, exist_ok=True)
    cpu_out = os.path.join(out_dir, "stability_cpu.pkl")
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--stab-trace", cpu_out, repr(duration)],
                             stdout=sys.stderr)
    traces = {}
    try:
        for variant in variants:
            for i in range(repeats if variant == "kernels" else 1):
                summary, traces[f"card {variant} {i + 1}"] = stab_trace_run(torch, DEVICE, duration, variant)
                print(f"[parting] card {variant} {i + 1}: {summary} ({card})", flush=True)
        rc = child.wait(timeout=1800)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert rc == 0, f"the CPU replay exited with {rc}"
    with open(cpu_out, "rb") as fh:
        summary, traces["cpu"] = pickle.load(fh)
    print(f"[parting] cpu: {summary}")
    firsts = [f"card {v} 1" for v in variants]
    pairs = [(a, a[:-1] + "2") for a in firsts if a[:-1] + "2" in traces]
    pairs += [(firsts[0], b) for b in firsts[1:]] + [(a, "cpu") for a in firsts]
    for a, b in pairs:
        print(f"[parting] {describe_parting(a, b, traces[a], traces[b], STAB_RAW['track_min_parallax'])}")
    with open(os.path.join(out_dir, "stability_traces.pkl"), "wb") as fh:
        pickle.dump(traces, fh)


SCATTER_ROWS = 1 << 20           # rows of scatter_check's repeatability set (64 targets)


def scatter_check(torch, card):
    """The backend's assembly scatter, ``solver/problem.py:scatter_sum``, on
    the card: SCATTER_ROWS float64 rows of 6 into 64 targets twice (equal
    bit for bit: the replay is repeatable only so) and within 1e-9 of the
    CPU's ``index_add``; ``index_add`` on the card (what the assembly used
    before, by atomics) twice beside it. Then both timed with CUDA events
    at the shapes the stability world's episode gives the assembly's two
    largest scatters: 4*R + 4*(N - 1) + G + 2 blocks of 15x15 into N*N, and
    2*R rows of 6 into N*L. Returns {shape: (scatter_sum ms, index_add ms)}."""
    from ic_gvins_tpu_torch.solver.problem import scatter_sum

    g = torch.Generator().manual_seed(SEED)
    idx = torch.randint(0, 64, (SCATTER_ROWS,), generator=g)
    vals = torch.randn(SCATTER_ROWS, 6, generator=g, dtype=torch.float64)
    cpu = torch.zeros(64, 6, dtype=torch.float64).index_add(0, idx, vals)
    i, v = idx.to(DEVICE), vals.to(DEVICE)
    ours = [scatter_sum(v.new_zeros((64, 6)), i, v).cpu() for _ in range(2)]
    atomics = [v.new_zeros((64, 6)).index_add(0, i, v).cpu() for _ in range(2)]
    err = float((ours[0] - cpu).abs().max())
    print(f"[scatter] {SCATTER_ROWS} rows into 64 targets on the card: scatter_sum twice equal bit for bit "
          f"{torch.equal(ours[0], ours[1])}, against the CPU's index_add max abs error {err:.3g} (bit for bit "
          f"{torch.equal(ours[0], cpu)}); index_add twice equal {torch.equal(atomics[0], atomics[1])} ({card})")
    assert torch.equal(ours[0], ours[1]), "scatter_sum is not repeatable on the card"
    assert err < 1e-9, err
    N, L, R, G = STAB_RAW["node_slots"], STAB_RAW["landmark_slots"], STAB_RAW["reproj_slots"], STAB_RAW["gnss_slots"]
    times = {}
    for label, n, m, shape in ((f"blocks {4 * R + 4 * (N - 1) + G + 2}x15x15 into {N * N}", N * N,
                                4 * R + 4 * (N - 1) + G + 2, (15, 15)),
                               (f"rows {2 * R}x6 into {N * L}", N * L, 2 * R, (6,))):
        i = torch.randint(0, n, (m,), generator=g).to(DEVICE)
        v = torch.randn(m, *shape, generator=g, dtype=torch.float64).to(DEVICE)
        fns = {"scatter_sum": lambda: scatter_sum(v.new_zeros((n, *shape)), i, v),
               "index_add": lambda: v.new_zeros((n, *shape)).index_add(0, i, v)}
        ms = {}
        for name, fn in fns.items():
            for _ in range(10):
                fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(200):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end) / 200
        times[label] = (ms["scatter_sum"], ms["index_add"])
        print(f"[scatter] {label}: scatter_sum {ms['scatter_sum']:.4f} ms, index_add {ms['index_add']:.4f} ms a "
              f"call, as issued (200 calls, CUDA events; {card})")
    return times


def scatter_ab():
    """The end-to-end cost of the repeatable scatter: phase 7's small GVINS
    replay (``gvins_small_run``: tests/test_gvins_e2e.py's 24 s world at
    320x240) on the card once to warm up, then with the assembly's
    ``scatter_sum`` and with ``index_add`` in its place (the atomics it
    replaced) in turns: scatter_sum, index_add, index_add, scatter_sum.
    Prints each run's wall. Run it on the card as ``python3 chip_smoke.py
    --scatter-ab``."""
    import torch

    from ic_gvins_tpu_torch.solver import problem

    card = the_card(torch)
    ours = problem.scatter_sum
    variants = {"scatter_sum": ours, "index_add": lambda out, idx, vals: out.index_add(0, idx, vals)}
    walls = collections.defaultdict(list)
    try:
        for name in ("scatter_sum", "scatter_sum", "index_add", "index_add", "scatter_sum"):
            problem.scatter_sum = variants[name]
            *_, state, wall = gvins_small_run(DEVICE)
            walls[name].append(wall)
            print(f"[scatter-ab] {name}: {wall:.3f} s wall, state {state} ({card})", flush=True)
    finally:
        problem.scatter_sum = ours
    print(f"[scatter-ab] in turns after a warm-up run: scatter_sum {[round(w, 3) for w in walls['scatter_sum'][1:]]} "
          f"s, index_add {[round(w, 3) for w in walls['index_add']]} s ({card})")


def estimation_phase(torch, card, wrappers):
    """Phase 11: GvinsModel with extrinsic and td estimation on: the td world
    at its full drive (``td_check``) and the stability world at
    STAB_DURATION s (``stability_check``) on the card, then both against
    the CPU (this script run again as a child process from the phase's
    start, ``--estimation-cpu-twins``): the td world's final state, and the
    stability world's frames before STAB_TWIN_UNTIL s up to the first frame
    at which the two replays part (``first_parting``), which is printed
    with what differs there. Every kernel must launch in both replays.
    Returns the kernels' launches in each replay."""
    import tempfile

    t_phase = time.perf_counter()
    launches = {}
    scatter_check(torch, card)
    with tempfile.TemporaryDirectory() as tmp:
        twin_out = os.path.join(tmp, "cpu_twins.pkl")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--estimation-cpu-twins", twin_out,
                                  repr(TD_TURN), repr(STAB_DURATION), repr(STAB_TWIN_UNTIL)], stdout=sys.stderr)
        try:
            launches["td_world"], failed, not_met, (state_g, td_g, tg, sg) = td_check(torch, card, wrappers)
            launches["stability_world"], f, n, trace_g = stability_check(torch, card, wrappers, STAB_DURATION)
            failed, not_met = failed + f, not_met + n
            t_wait = time.perf_counter()
            rc = child.wait(timeout=900)
            t_wait = time.perf_counter() - t_wait
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        assert rc == 0, f"phase 11's CPU twins exited with {rc}"
        with open(twin_out, "rb") as fh:
            (sc, tc, _, state_c, td_c, secs_c), (stab_c, trace_c) = pickle.load(fh)
    same = tg.shape == tc.shape
    dt_nodes = float(np.abs(tg[:, 0] - tc[:, 0]).max()) if same else float("inf")
    dp = float(np.abs(tg[:, 1:4] - tc[:, 1:4]).max()) if same else float("inf")
    print(f"[td] CUDA against CPU: states after every frame equal {sg == sc}, final {state_g} / {state_c}, td "
          f"{td_g:.9f} / {td_c:.9f} s (difference {abs(td_g - td_c):.3g}), {len(tg)} / {len(tc)} nodes, node times "
          f"within {dt_nodes:.3g} s, positions within {dp:.3g} m ({secs_c:.1f} s wall on the CPU in the child process "
          f"with {GVINS_TWIN_CORES} threads, {t_wait:.1f} s of it waited for)")
    assert sg == sc and state_g == state_c, "the td world's states differ between CUDA and the CPU"
    assert dp < GVINS_CUDA_CPU_TOL and abs(td_g - td_c) < TD_CUDA_CPU_TOL, (dp, td_g, td_c)
    k, _, before, _ = first_parting(trace_g, trace_c)
    print(f"[stab] CUDA against CPU over the frames before {STAB_TWIN_UNTIL:g} s ({len(trace_c)} frames; the CPU "
          f"in the child process, {stab_c['wall_s']:.1f} s wall): "
          f"{describe_parting('card', 'cpu', trace_g, trace_c, STAB_RAW['track_min_parallax'])}")
    assert k is None or k > 0, "the stability world's replays part at its first frame"
    assert before["pos_m"] < STAB_CUDA_CPU_TOL, f"episode positions {before['pos_m']} m apart before the parting"
    for path, n_launch in launches.items():
        print(f"[estimation] launches in the {path} replay {n_launch}")
        assert all(v > 0 for v in n_launch.values()), f"a kernel was not launched in the {path} replay"
    if not_met:
        print(f"[estimation] NOT MET or left standing, as the JAX package fails them alike (ROADMAP R1, R4, R6): "
              f"{not_met}")
    print(f"[estimation] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    assert not failed, f"phase 11 gates failed: {failed}"
    return launches


# --------------------------------------------------------------------------
# phase 12: the GVINS fault paths run to their end: an illumination step, a
# camera blackout, a GNSS outage and the GNSS ingest gates in one 40 s drive,
# at the long world's 160x120 and at the production envelope's 1278x1022
# --------------------------------------------------------------------------

FAULT_DURATION = 40.0            # s: the fault world's drive (a 34 s turn)
FAULT_GLITCH = (14.0, 15.0)      # frames brightened x1.35 (the histogram gate)
FAULT_OUTAGE = (18.0, 26.0)      # GNSS fixes removed
FAULT_BLACKOUT = (30.0, 31.5)    # flat, featureless frames (TRACK_LOST and re-initialization)
FAULT_DEGRADED = (10.0, 12.0)    # fixes given std (15, 15, 15) m: a norm of 26 m, above gnssthreshold 20
FAULT_DEGRADED_STD = 15.0
FAULT_ZERO_STD = 28.0            # the fix nearest this stamp gets std 0
# LONG_RAW with extrinsic and td estimation off, the tier-1 twin's
# configuration (tests/test_torch_faults.py): with estimation on, whether
# the two packages' replays agree moves with the world and the thread count
# (ROADMAP R5, R6)
FAULT_RAW = dict(LONG_RAW, optimize_estimate_extrinsic=False, optimize_estimate_td=False)
FAULT_OUTAGE_AFTER = 36.0        # s: gnssoutagetime of the full-width run (isusegnssoutage on)
# frames (previous, checked) whose kernels are held against the plain
# versions before each replay: a normal pair, a glitch frame, a blackout frame
FAULT_CHECKED = {"normal": (99, 100), "glitch": (139, 140), "featureless": (299, 301)}
FAULT_WIDE_MIN_JOINTS = {"normal": 50, "glitch": 0, "featureless": 0}
FAULT_TWIN_UNTIL = 40.0          # s: the 160x120 world's CPU twin replays the frames before this stamp
FAULT_PROFILED = (40, 43)        # keyframe episodes of the full-width run under torch.profiler


def fault_world(cam_mod, rot_np, duration=FAULT_DURATION, camera=LONG_CAMERA, blob=LONG_BLOB, scene=None,
                with_earth=False):
    """The long world's recipe (``long_world``) with the faults of FAULT_*
    over a ``duration`` s drive: ``gins_world(turn_duration=duration - 6)``
    (200 Hz; the earth rate with ``with_earth``), its GNSS fixes in
    FAULT_OUTAGE removed, those in FAULT_DEGRADED given std
    FAULT_DEGRADED_STD m on each axis and the one nearest FAULT_ZERO_STD
    std 0; frames at 10 Hz of ``camera`` (intrinsic, distortion,
    resolution) at the true body pose, rendered by ``ground_frame`` with
    ``blob`` (sigma, half-width) over ``scene`` (None: the long world's 6000
    points 9-13 m below from default_rng(7); else a function of the truth
    that gives the points), flat 90 gray in FAULT_BLACKOUT and brightened
    x1.35 in FAULT_GLITCH. Returns (imu, gnss, truth, frame_times, frame)
    with frame(k) the (H, W) f64 image of frame k."""
    imu, gnss, truth = gins_world(turn_duration=duration - 6.0, seed=SEED, with_earth=with_earth)
    keep = ~((gnss["time"] >= FAULT_OUTAGE[0]) & (gnss["time"] < FAULT_OUTAGE[1]))
    gnss = {k: v[keep].copy() for k, v in gnss.items()}
    gnss["std"][(gnss["time"] >= FAULT_DEGRADED[0]) & (gnss["time"] < FAULT_DEGRADED[1])] = FAULT_DEGRADED_STD
    gnss["std"][np.argmin(np.abs(gnss["time"] - FAULT_ZERO_STD))] = 0.0
    if scene is None:
        rng = np.random.default_rng(7)
        pts_w = np.stack([rng.uniform(-80, 140, 6000), rng.uniform(-80, 140, 6000), rng.uniform(9, 13, 6000)], axis=1)
    else:
        pts_w = scene(truth)
    cam = cam_mod.PinholeCamera.from_config(*camera)
    frame_times = np.arange(0.05, imu["time"][-1] - 0.2, 0.1)

    def frame(k):
        t = frame_times[k]
        if FAULT_BLACKOUT[0] <= t < FAULT_BLACKOUT[1]:
            return np.full((cam.height, cam.width), 90.0)
        i = min(int(round(t * 200.0)) - 1, len(truth["p"]) - 1)
        img = ground_frame(cam_mod, cam, pts_w, rot_np.to_matrix(truth["q"][i]), truth["p"][i], *blob)
        if FAULT_GLITCH[0] <= t < FAULT_GLITCH[1]:
            img = np.clip(img * 1.35, 0, 255)
        return img
    return imu, gnss, truth, frame_times, frame


def fault_config(raw, truth, camera, outage_after=None):
    """The configuration dict ``raw`` with the drive's lever arm and
    ``camera`` (``gvins_raw``); with ``outage_after``, the reference's
    gvins.yaml keys ``isusegnssoutage: true`` and ``gnssoutagetime:
    outage_after`` (every fix from that stamp on is dropped at ingest)."""
    out = gvins_raw(truth, raw, camera)
    if outage_after is not None:
        out.update(isusegnssoutage=True, gnssoutagetime=float(outage_after))
    return out


def ingest_dropped(gnss, threshold):
    """The stamps of the fixes that the reference's std gates drop at
    ingest (fusion_ros.cc:178-198): std zero on every axis, or a std norm
    above ``threshold``."""
    std = np.asarray(gnss["std"], np.float64)
    drop = (std == 0).all(axis=1) | (np.linalg.norm(std, axis=1) > threshold)
    return {round(float(t), 3) for t in gnss["time"][drop]}


class FaultLog:
    """Hooks on one model's own methods for the fault paths, wrapped on the
    instance so that the class runs unmodified; they work on the GinsModel
    and GvinsModel of the port and of the JAX package alike. ``tracked``:
    the tracker's state on every tracked frame, by the frame's stamp
    (rounded to 0.01 s); ``kept``: the stamps of the GNSS fixes the model
    took, that is the fixes that passed its ingest gates (the
    initialization's pairs, the GNSS/INS stage's fixes and the fixes offered
    for node insertion); ``sheds``: the nodes that ``_ensure_node_capacity``
    marginalized for capacity; ``chained``: the stamps of the time nodes
    that ``_chain_time_nodes`` inserted."""

    def __init__(self, model):
        self.tracked, self.kept, self.sheds, self.chained = [], set(), 0, []
        take = lambda g: self.kept.add(round(float(g["time"]), 3))  # noqa: E731

        def wrap(name, hook):
            if hasattr(model, name):
                setattr(model, name, hook(getattr(model, name)))

        def initializing(fn):
            def hooked(stream, *args, **kw):
                for g in (*args, *kw.values()):
                    take(g)
                return fn(stream, *args, **kw)
            return hooked

        def taking(fn):
            def hooked(stream, gnss):
                take(gnss)
                return fn(stream, gnss)
            return hooked

        def shedding(fn):
            def hooked():
                n = model.est.n_nodes
                out = fn()
                self.sheds += n - model.est.n_nodes
                return out
            return hooked

        def chaining(fn):
            def hooked(stream, t_target, shed_capacity=None):
                est = model.est
                add = est.add_time_node

                def added(t, series):
                    self.chained.append(round(float(t), 4))
                    return add(t, series)
                est.add_time_node = added
                try:
                    return fn(stream, t_target, shed_capacity=shed_capacity)
                finally:
                    del est.add_time_node
            return hooked

        wrap("_try_initialize", initializing)
        for name in ("_process_gnss", "_process_gnss_ins", "_insert_gnss_node"):
            wrap(name, taking)
        wrap("_ensure_node_capacity", shedding)
        wrap("_chain_time_nodes", chaining)
        tracker = getattr(model, "tracker", None)
        if tracker is not None:
            track = tracker.track

            def tracking(frame, image):
                st = track(frame, image)
                self.tracked.append((round(float(frame.stamp - frame.td), 2), int(st)))
                return st
            tracker.track = tracking

    def record(self):
        """What it saw, as a plain dict (picklable)."""
        return dict(tracked=list(self.tracked), kept=sorted(self.kept), sheds=self.sheds, chained=list(self.chained))


def fault_states(tracked, state, window=None, outside=()):
    """The stamps of the frames ``tracked`` = [(stamp, state)] left in
    ``state``: inside ``window`` if given, and outside every window of
    ``outside``."""
    def inside(t, w):
        return w[0] <= t < w[1]
    return [t for t, st in tracked if st == state and (window is None or inside(t, window))
            and not any(inside(t, w) for w in outside)]


def fault_gates(model, traj, truth, faults, gnss, end, outage_after=None):
    """tests/test_gvins_long_e2e.py's gates with its windows moved to the
    fault world's, and the evidence that each fault path ran: [(test, name,
    value, limit, met, needs)] as ``stability_gates``. ``faults`` is a
    ``FaultLog.record()``, ``gnss`` the world's fixes, ``end`` the stamp of
    the world's last frame."""
    from ic_gvins_tpu_torch.vision.tracking import TRACK_LOST, TRACK_PASSED

    outside = stab_errs(traj, truth, t_lo=8.0, exclude=(FAULT_OUTAGE, FAULT_BLACKOUT))
    bridge = stab_errs(traj, truth, t_lo=FAULT_OUTAGE[0], t_hi=FAULT_OUTAGE[1] + 2.0)
    post = stab_errs(traj, truth, t_lo=FAULT_BLACKOUT[1] + 3.0)
    top = lambda e, f: float(f(e)) if len(e) else float("nan")  # noqa: E731
    passed = fault_states(faults["tracked"], TRACK_PASSED, FAULT_GLITCH)
    lost = fault_states(faults["tracked"], TRACK_LOST, FAULT_BLACKOUT)
    kept, stamps = set(faults["kept"]), {round(float(t), 3) for t in gnss["time"]}
    degraded = ingest_dropped(gnss, model.cfg.gnssthreshold)
    late = {t for t in stamps if outage_after is not None and t >= outage_after}
    expected = stamps - degraded - late
    return [
        ("survives", "state at the end", model.state, "TRACKING_NORMAL", model.state == "TRACKING_NORMAL", end),
        # > 40 over the JAX test's 120 s; this world has ~13 s outside the faults
        ("accuracy_outside_faults", "nodes outside the faults", len(outside), "> 5", len(outside) > 5, end),
        ("accuracy_outside_faults", "mean error outside the faults m", top(outside, np.mean), "< 0.3",
         top(outside, np.mean) < 0.3, 0.0),
        ("outage_bridged", "bridge nodes", len(bridge), "> 3", len(bridge) > 3, FAULT_OUTAGE[1] + 2.0),
        ("outage_bridged", "bridge max error m", top(bridge, np.max), "< 3.0", top(bridge, np.max) < 3.0,
         FAULT_OUTAGE[1] + 2.0),
        ("blackout_recovery", "post-blackout nodes", len(post), "> 3", len(post) > 3, end),
        ("blackout_recovery", "post-blackout mean error m", top(post, np.mean), "< 0.3", top(post, np.mean) < 0.3,
         end),
        ("histogram_gate", f"TRACK_PASSED frames in {FAULT_GLITCH}", passed, ">= 1", len(passed) >= 1,
         FAULT_GLITCH[1]),
        ("blackout", f"TRACK_LOST frames in {FAULT_BLACKOUT}", lost, ">= 1", len(lost) >= 1, FAULT_BLACKOUT[1]),
        ("ingest_gates", "degraded and zero-std fixes taken", sorted(kept & degraded), f"none of {sorted(degraded)}",
         len(degraded) == 3 and not kept & degraded, 0.0),
        ("ingest_gates", f"fixes from gnssoutagetime {outage_after} s taken", sorted(kept & late), "none",
         not kept & late, 0.0),
        ("ingest_gates", "fixes that pass the gates never taken", sorted(expected - kept), "none",
         not expected - kept, end),
    ]


def fault_inputs(raw=LONG_RAW, outage_after=None, until=None, parse_config=None):
    """The 160x120 fault world as a replay takes it, with the frames stamped
    before ``until`` s (the IMU to 1 s past it, the fixes before it):
    (imu, gnss, truth, frame_times, images, the configuration of
    ``fault_config(raw, ...)`` as ``parse_config`` reads it (by default the
    port's), the camera, seconds taken)."""
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.vision import camera as cam

    if parse_config is None:
        from ic_gvins_tpu_torch.engine.config import parse_config

    t0 = time.perf_counter()
    imu, gnss, truth, frame_times, frame = fault_world(cam, rotation_np)
    if until is not None:
        imu = {k: v[imu["time"] <= until + 1.0] for k, v in imu.items()}
        gnss = {k: v[gnss["time"] < until] for k, v in gnss.items()}
        frame_times = frame_times[frame_times < until]
    images = [frame(k) for k in range(len(frame_times))]
    cfg = parse_config(fault_config(raw, truth, LONG_CAMERA, outage_after))
    return (imu, gnss, truth, frame_times, images, cfg, cam.PinholeCamera.from_config(*LONG_CAMERA),
            time.perf_counter() - t0)


def fault_trace_run(torch, device, until=None, cores=None):
    """The 160x120 fault world with LONG_RAW through the port on ``device``
    with a ``PartingTrace`` and a ``FaultLog`` (the CPU twin of phase 12, in
    a child process). With ``cores``, it keeps to the host's last ``cores``
    cores with as many torch threads. Returns (a summary dict, the trace,
    the ``FaultLog`` record)."""
    keep_to_cores(torch, cores)
    imu, gnss, truth, frame_times, images, cfg, *_ = fault_inputs(until=until)
    run = estimation_run(torch, device, cfg, imu, gnss, frame_times, images, trace=True, faults=True)
    summary = dict(device=device, threads=torch.get_num_threads(), stop=run.stop, wall_s=round(run.wall, 3),
                   **run.log.counts, state=run.model.state)
    return summary, run.trace, run.faults.record()


def print_faults(tag, rec, gnss, outage_after=None):
    """One run's fault paths as lines: the tracker's states, TRACK_LOST
    outside the faults, the fixes dropped at ingest, sheds and chained
    nodes."""
    from ic_gvins_tpu_torch.vision.tracking import TRACK_LOST, TRACK_PASSED

    counts = dict(sorted(collections.Counter(st for _, st in rec["tracked"]).items()))
    stray = fault_states(rec["tracked"], TRACK_LOST, outside=(FAULT_GLITCH, FAULT_BLACKOUT))
    dropped = sorted({round(float(t), 3) for t in gnss["time"]} - set(rec["kept"]))
    print(f"[{tag}] tracker states by frame (TRACK_*: count) {counts}; TRACK_PASSED at "
          f"{fault_states(rec['tracked'], TRACK_PASSED)}; TRACK_LOST at {fault_states(rec['tracked'], TRACK_LOST)} "
          f"({len(stray)} outside the glitch and the blackout)")
    print(f"[{tag}] GNSS: {len(gnss['time'])} fixes in the world, {len(rec['kept'])} taken; not taken {dropped} "
          f"(gnssoutagetime {outage_after}); node sheds for capacity {rec['sheds']}, chained time nodes "
          f"{rec['chained']}")


def fault_check(torch, card, wrappers):
    """Phase 12 (a): the 160x120 fault world with LONG_RAW (extrinsic, td
    estimation and the histogram gate on) on the card: each kernel against
    its plain version on FAULT_CHECKED's frames, then the replay with the
    counters set to 0 just before and read just after, and
    ``fault_gates``. Returns (launches, failed gates, gates not met, the
    replay's ``PartingTrace``, its ``FaultLog`` record, the world's GNSS
    fixes)."""
    imu, gnss, truth, frame_times, images, cfg, camera, secs = fault_inputs()
    print(f"[fault] world: {FAULT_DURATION:g} s drive, {len(imu['time'])} IMU samples, {len(gnss['time'])} GNSS "
          f"fixes (outage {FAULT_OUTAGE}, std {FAULT_DEGRADED_STD:g} m in {FAULT_DEGRADED}, std 0 at "
          f"{FAULT_ZERO_STD:g} s), {len(frame_times)} frames 160x120 (glitch {FAULT_GLITCH}, blackout "
          f"{FAULT_BLACKOUT}), made in {secs:.2f} s on the CPU")
    assert cfg.track_check_histogram and cfg.optimize_estimate_td and cfg.optimize_estimate_extrinsic
    long_kernel_checks(torch, _kernel_modules(), lambda k: images[k], cfg, camera, checked=FAULT_CHECKED,
                       label="fault world")
    run, launches = counted_run(wrappers, lambda: estimation_run(torch, DEVICE, cfg, imu, gnss, frame_times, images,
                                                                 trace=True, faults=True))
    m, c, rec = run.model, run.log.counts, run.faults.record()
    sim_s = float((run.stop if run.stop is not None else imu["time"][-1]) - imu["time"][0])
    print(f"[fault] replay {sim_s:.2f} s simulated in {run.wall:.3f} s wall (its CPU twin beside it with "
          f"{GVINS_TWIN_CORES} threads): {sim_s / run.wall:.3f} sim-s per wall-s; {c['frames']} frames, "
          f"{c['episodes']} keyframe episodes, {c['margs']} marginalizations; solver tiers {m.tier_counts}, "
          f"marginalization tiers {m.tier_counts_marg}; launches {launches} ({card})")
    print(f"[fault] gate decisions (adopted, refused): {run.log.adoptions()}; final td {m.td_b_c:.6f} s, |t_b_c| "
          f"{np.linalg.norm(m.pose_b_c_t):.4f} m")
    print_faults("fault", rec, gnss)
    if run.refused is not None:
        print(f"[fault] the replay stopped after the frame at {run.stop:.2f} s: {run.refused} (the JAX package "
              f"refuses such a slide alike: ROADMAP R1)")
    failed, not_met = judge("fault", fault_gates(m, run.traj, truth, rec, gnss, float(frame_times[-1])), run.stop)
    return launches, failed, not_met, run.trace, rec, gnss


def fault_wide_check(torch, card, wrappers):
    """Phase 12 (b): the same faults at full width, on the card: the
    production envelope's scene and configuration
    (scripts/bench_production_torch.py: 1278x1022, the corridor, earth rate
    on, estimation off, 200 features) with the histogram gate on, as the
    KAIST gvins.yaml has it, and ``isusegnssoutage`` from
    FAULT_OUTAGE_AFTER s, over the fault world's 40 s drive. No twin: the
    gates of (a), each kernel against its plain version on FAULT_CHECKED's
    frames, sim-s per wall-s, frames per second, the device busy share over
    FAULT_PROFILED's episodes and the launches. Returns (launches, failed
    gates, gates not met)."""
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.vision import camera as cam

    bp = load_script("bench_production_torch")
    t0 = time.perf_counter()
    imu, gnss, truth, frame_times, frame = fault_world(cam, rotation_np, camera=bp.CAMERA, blob=bp.BLOB,
                                                       scene=bp.corridor, with_earth=True)
    cfg = parse_config(fault_config(dict(bp.PROD_RAW, track_check_histogram=True), truth, bp.CAMERA,
                                    FAULT_OUTAGE_AFTER))
    t_render = time.perf_counter()
    images = [frame(k).astype(np.float32) for k in range(len(frame_times))]   # rendered up front, apart from the replay
    print(f"[fault wide] world: {FAULT_DURATION:g} s drive (earth rate on), {len(gnss['time'])} GNSS fixes, "
          f"{len(frame_times)} frames {bp.W}x{bp.H} over the production corridor, rendered in "
          f"{time.perf_counter() - t_render:.2f} s ({time.perf_counter() - t0:.2f} s with the drive) on the CPU; "
          f"gnssoutagetime {cfg.gnssoutagetime} s")
    assert cfg.track_check_histogram and cfg.isusegnssoutage and not cfg.optimize_estimate_td
    long_kernel_checks(torch, _kernel_modules(), lambda k: images[k], cfg, cam.PinholeCamera.from_config(*bp.CAMERA),
                       checked=FAULT_CHECKED, min_joints=FAULT_WIDE_MIN_JOINTS, label="fault world 1278x1022")
    run, launches = counted_run(wrappers, lambda: estimation_run(torch, DEVICE, cfg, imu, gnss, frame_times, images,
                                                                 profiled=FAULT_PROFILED, faults=True))
    m, c, rec = run.model, run.log.counts, run.faults.record()
    sim_s = float((run.stop if run.stop is not None else imu["time"][-1]) - imu["time"][0])
    print(f"[fault wide] replay {sim_s:.2f} s simulated in {run.wall:.3f} s wall ({run.frames.prof_frames_s:.3f} s "
          f"of it the frames under torch.profiler): {sim_s / run.wall:.3f} sim-s per wall-s, "
          f"{len(frame_times) / run.wall:.3f} frames per second (the envelope's count: {len(frame_times)} frames, "
          f"{len(run.frames.rows)} of them processed after the initialization); {c['episodes']} keyframe "
          f"episodes, {c['margs']} marginalizations; solver tiers {m.tier_counts}, marginalization tiers "
          f"{m.tier_counts_marg}; launches {launches} ({card})")
    frames = run.frames
    if frames.prof_wall_ms is None:
        print(f"[fault wide] profiler: the window {FAULT_PROFILED} was not completed")
    else:
        kernels, busy = device_activity(torch, frames.prof, frames.prof_wall_ms)
        if kernels is None:
            print("[fault wide] profiler: no device events in the trace; busy share not measured")
        else:
            print(f"[fault wide] profiler, episodes {FAULT_PROFILED[0]}-{FAULT_PROFILED[1] - 1} and the frames "
                  f"between: {kernels / (FAULT_PROFILED[1] - FAULT_PROFILED[0]):.0f} CUDA kernels per episode, "
                  f"device busy {busy:.2f} of {frames.prof_wall_ms:.2f} ms = "
                  f"{100 * busy / frames.prof_wall_ms:.1f} % ({card})")
    print_faults("fault wide", rec, gnss, FAULT_OUTAGE_AFTER)
    if run.refused is not None:
        print(f"[fault wide] the replay stopped after the frame at {run.stop:.2f} s: {run.refused} (the JAX package "
              f"refuses such a slide alike: ROADMAP R1)")
    failed, not_met = judge("fault wide", fault_gates(m, run.traj, truth, rec, gnss, float(frame_times[-1]),
                                                      FAULT_OUTAGE_AFTER), run.stop)
    return launches, failed, not_met


def fault_phase(torch, card, wrappers):
    """Phase 12: the GVINS fault paths to their end. (a) ``fault_check`` on
    the card, then against the CPU (this script run again as a child
    process from the phase's start, ``--fault-cpu-twin``) over the frames
    before FAULT_TWIN_UNTIL s, up to the first frame at which the two
    replays part (``first_parting``), which is printed with what differs
    there; positions within GVINS_CUDA_CPU_TOL before it. (b)
    ``fault_wide_check``. Every kernel must launch in both replays. Returns
    the kernels' launches in each replay."""
    import tempfile

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        twin_out = os.path.join(tmp, "fault_cpu_twin.pkl")
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--fault-cpu-twin", twin_out,
                                  repr(FAULT_TWIN_UNTIL)], stdout=sys.stderr)
        try:
            launches["fault_world_160x120"], failed, not_met, trace_g, rec_g, gnss = fault_check(torch, card,
                                                                                                 wrappers)
            launches["fault_world_1278x1022"], f, n = fault_wide_check(torch, card, wrappers)
            failed, not_met = failed + f, not_met + n
            t_wait = time.perf_counter()
            rc = child.wait(timeout=900)
            t_wait = time.perf_counter() - t_wait
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        assert rc == 0, f"phase 12's CPU twin exited with {rc}"
        with open(twin_out, "rb") as fh:
            summary_c, trace_c, rec_c = pickle.load(fh)
    k, _, before, _ = first_parting(trace_g, trace_c)
    n = len(trace_c) if k is None else k
    until = trace_c[n - 1]["stamp"] + 0.005 if n else 0.0
    same_states = [x for x in rec_g["tracked"] if x[0] < until] == [x for x in rec_c["tracked"] if x[0] < until]
    print(f"[fault] CUDA against CPU over the frames before {FAULT_TWIN_UNTIL:g} s ({len(trace_c)} frames; the CPU "
          f"in the child process, {summary_c['wall_s']:.1f} s wall, {t_wait:.1f} s of it waited for, "
          f"{summary_c['episodes']} episodes, state {summary_c['state']}): "
          f"{describe_parting('card', 'cpu', trace_g, trace_c, LONG_RAW['track_min_parallax'])}; the tracker's "
          f"states equal before it: {same_states}")
    print_faults("fault cpu", rec_c, {k: v[gnss["time"] < FAULT_TWIN_UNTIL] for k, v in gnss.items()})
    assert k is None or k > 0, "the fault world's replays part at its first frame"
    assert before["pos_m"] < GVINS_CUDA_CPU_TOL, f"episode positions {before['pos_m']} m apart before the parting"
    for path, n_launch in launches.items():
        print(f"[fault] launches in the {path} replay {n_launch}")
        assert all(v > 0 for v in n_launch.values()), f"a kernel was not launched in the {path} replay"
    if not_met:
        print(f"[fault] NOT MET, the replay stopped by the refusal the JAX package makes alike (ROADMAP R1): "
              f"{not_met}")
    print(f"[fault] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    assert not failed, f"phase 12 gates failed: {failed}"
    return launches


def main():
    t_start = time.perf_counter()
    import torch

    # ---- phase 1: the card ------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    dev = torch.device(DEVICE)
    card = the_card(torch)
    phase_s = {1: time.perf_counter() - t_start}

    # ---- phase 2: build ------------------------------------------------
    t0 = t_mark = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'not run: cached .so'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    phase_s[2] = time.perf_counter() - t_mark

    # ---- phase 3: kernels against their plain versions ---------------------
    t_mark = time.perf_counter()
    camera, pts_w, poses, images = slice_world(cam)
    img0 = torch.tensor(images[0], dtype=torch.float32, device=dev)
    img1 = torch.tensor(images[1], dtype=torch.float32, device=dev)
    records = {}

    def record(name, source, replaces, err, fn, plain_fn, n_bytes, n_ops):
        ms, plain_ms = cuda_ms(torch, fn), cuda_ms(torch, plain_fn)
        device_ms = cuda_ms(torch, fn, queued=True)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        records[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                             max_abs_err=float(err), ms=float(ms), plain_ms=float(plain_ms),
                             bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                             device_ms=float(device_ms))
        print(f"[kernel] {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms per call "
              f"(device-only {device_ms:.4f} ms)  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
              f"by {bound_by} ({n_bytes} B, {n_ops} float32 ops)  ({card})")

    # K3 CLAHE apply, on the frame's own tables; then at an odd width (frame 0
    # cut to W - 1 columns, its own tables), which takes the one-column path
    tables = pyramid.clahe_tables(img0)
    err, out_k = check_clahe(kclahe, "frame 0", tables)
    err_odd, _ = check_clahe(kclahe, "odd width", pyramid.clahe_tables(img0[:, : W - 1].contiguous()))
    v_img, lut = tables[0], tables[1]
    # per pixel: 4 weight products, 4 weighted taps, 3 sums (the blend)
    record("clahe_apply", "ic_gvins_tpu_torch/csrc/clahe_apply.cu",
           "ic_gvins_tpu/ops/pallas_clahe.py:64", max(err, err_odd),
           lambda: kclahe.clahe_apply(*tables), lambda: kclahe.clahe_apply_plain(*tables),
           nbytes(v_img, lut, out_k), 11 * v_img.numel())

    # K1 fused LK: the main path's call (256 slots, 4 levels, both directions)
    pyr0, pyr1, pts, valid = lk_inputs(torch, pyramid, feat, img0, img1)
    assert pts.shape == (256, 2) and int(valid.sum()) > 150, int(valid.sum())
    lk_args = (pyr0, pyr1, pts, pts, valid)

    errs = [check_lk(torch, klk, "frame 0->1", lk_args, n, 50)[0] for n in (1, 2)]
    for sign in (1.0, -1.0):
        args = near_border_pair(torch, pyramid, pyr0[0], sign)
        for n, min_joint in ((1, 20), (2, 8)):
            err, fp = check_lk(torch, klk, f"near-border {sign:+.0f}", args, n, min_joint)
            errs.append(err)
        outside = ((fp[:, 0] < 0) | (fp[:, 0] > W - 1) | (fp[:, 1] < 0) | (fp[:, 1] > H - 1))
        print(f"[kernel] lk_pyr near-border {sign:+.0f}: {int(outside.sum())} slots tracked past "
              f"the image edge (clip-shifted windows)")
        assert bool(outside.any()), "near-border pair never reached the clip-shift path"
    iters = torch.zeros(256, dtype=torch.int32, device=dev)
    _, st_f = klk.lk_pyr(*lk_args, directions=1)
    klk.lk_pyr(*lk_args, iters=iters)
    levels_run = 4 * (int(valid.sum()) + int(st_f.sum()))
    lk_bytes = lk_pyr_bytes(torch, klk, lk_args)
    print(f"[kernel] lk_pyr frame 0->1: {int(iters.sum())} LK steps over {levels_run} slot-levels; "
          f"longest slot chain {int(iters.max())} steps; {lk_bytes} B under the windows "
          f"(both pyramids: {nbytes(*pyr0, *pyr1)} B)")
    # a slot-level: 529 bilinear samples (7 ops) + 441 x (4 gradient + 6 G) ops;
    # a step: 441 x (7 sample + 1 diff + 4 b) ops
    record("lk_pyr", "ic_gvins_tpu_torch/csrc/lk_pyr.cu", "ic_gvins_tpu/ops/pallas_lk.py:309",
           max(errs), lambda: klk.lk_pyr(*lk_args), lambda: klk.lk_pyr_plain(*lk_args),
           lk_bytes, levels_run * (529 * 7 + 441 * 10) + int(iters.sum()) * 441 * 12)
    print("[kernel] lk_pyr times are one frame's call: 4 levels, both directions")

    # K2 subpix: the slice's detection, then the border/guard set; steps
    # compared with the plain version's count
    sp_args = subpix_inputs(torch, feat, pyr0[0])
    _, c, v = sp_args
    assert c.shape == (210, 2) and int(v.sum()) > 150
    sp_err, out_p, sp_steps = check_subpix(torch, ksubpix, "slice detection", sp_args)
    e_img, e_c, e_v, e_kind = subpix_edge_set(H, W, SEED + 3)
    e_args = (torch.tensor(e_img, device=dev), torch.tensor(e_c, device=dev),
              torch.tensor(e_v, device=dev))
    e_err, e_out, e_steps = check_subpix(torch, ksubpix, "border/guard set", e_args)
    clipped, rejected = subpix_paths(torch, e_args[1], e_args[2], e_out, e_steps, W, H)
    for kind in SUBPIX_CASES:
        m = torch.tensor(e_kind == kind, device=dev)
        print(f"[kernel] subpix border/guard set, {kind}: {int(m.sum())} slots, "
              f"{int(clipped[m].sum())} clip-shifted slices, {int(rejected[m].sum())} sent back "
              f"by the divergence guard")
    assert int(clipped.sum()) >= 20 and int(rejected.sum()) >= 20, \
        "the border/guard set never reached the clip-shifted slice or the divergence guard"
    # bytes: the 14x14 slices at the corners (the first step's; later steps
    # move < 1 px a step and are not counted), the corners and flags, the
    # output; operations: the plain version's steps, whatever implements them
    sp_px = torch.unique(slice_pixels(torch, pyr0[0], c[v], ksubpix.HALF + 1, 0)).numel()
    sp_bytes = 4 * int(sp_px) + nbytes(*sp_args[1:], out_p)
    print(f"[kernel] subpix slice detection: {sp_bytes} B under the windows")
    # a step: 169 patch samples x 7 + 121 window pixels x ~20 ops
    record("subpix", "ic_gvins_tpu_torch/csrc/subpix.cu", "ic_gvins_tpu/ops/pallas_subpix.py:204",
           max(sp_err, e_err), lambda: ksubpix.subpix(*sp_args),
           lambda: ksubpix.subpix_plain(*sp_args), sp_bytes,
           int(sp_steps.sum()) * (169 * 7 + 121 * 20))

    # argmax tie-breaks: detection on the card equals the CPU on the same frame
    _, cc, vc = subpix_inputs(torch, feat, pyr0[0].cpu())
    assert torch.equal(c.cpu(), cc) and torch.equal(v.cpu(), vc), "detect_blockwise CUDA != CPU"
    print("[detect] corner tables on the card equal the CPU's on the same frame")

    phase_s[3] = time.perf_counter() - t_mark

    # ---- phase 4: the slice at full width ----------------------------------
    t_mark = time.perf_counter()
    cfg = parse_config(CFG)
    vmap = vmap_mod.VisualMap(cfg.optimize_windows_size)
    tracker = trk.Tracker(camera, vmap, cfg, device=DEVICE)
    assert (tracker.F_MAX, tracker.block_rows, tracker.block_cols, tracker.per_block,
            tracker.min_pixel_distance) == SLICE_STATICS
    wrappers = {"clahe_apply": kclahe.clahe_apply, "lk_pyr": klk.lk_pyr,
                "subpix": ksubpix.subpix}
    lk_stage, lk_calls = trk._lk_stage, []

    def counted_lk_stage(*args):
        lk_calls.append(1)
        return lk_stage(*args)

    trk._lk_stage = counted_lk_stage
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t_slice = time.perf_counter()
    try:
        rows = run_tracker(trk, vmap_mod, tracker, vmap, images, poses)
        torch.cuda.synchronize()
    finally:
        trk._lk_stage = lk_stage
    t_slice = time.perf_counter() - t_slice
    launches = {k: w.launches for k, w in wrappers.items()}
    states = [r[0] for r in rows]
    errs = np.array([np.linalg.norm(pts_w - lm.pos, axis=1).min() for lm in vmap.landmarks.values()])
    stats = frame_stats([r[4] for r in rows])
    print(f"[slice] {len(rows)} frames {W}x{H} in {t_slice:.2f} s; states {states}")
    print(f"[slice] features per frame {[r[2] for r in rows]}")
    print(f"[slice] keyframes {len(vmap.keyframes)}, landmarks {len(vmap.landmarks)}, "
          f"landmark error median {np.median(errs) if len(errs) else float('nan'):.3f} m, "
          f"p25 {np.percentile(errs, 25) if len(errs) else float('nan'):.3f} m")
    print(f"[slice] track_ms median {stats['frame_ms_median']:.2f} (frames 2+: "
          f"{stats['frame_ms_median_2plus']:.2f}, p90 {stats['frame_ms_p90_2plus']:.2f}) ({card})")
    print(f"[slice] launches {launches}; LK stage calls {len(lk_calls)}")
    assert trk.TRACK_TRACKING in states, "tracker never reached TRACK_TRACKING"
    assert len(vmap.keyframes) >= 2, "fewer than 2 keyframes"
    assert len(vmap.landmarks) >= 50, "fewer than 50 landmarks"
    assert np.median(errs) < 0.6 and np.percentile(errs, 25) < 0.3, "landmarks far from truth"
    assert all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}"
    assert launches["lk_pyr"] == len(lk_calls), "LK is not one launch per tracked frame"
    for k, n in launches.items():
        records[k]["launches"] = int(n)

    vmap = vmap_mod.VisualMap(cfg.optimize_windows_size)
    stages, timed_ms = timed_stages(torch, trk, vmap_mod, trk.Tracker(camera, vmap, cfg, device=DEVICE),
                                    vmap, images, poses)
    for name, st in stages.items():
        print(f"[stages] {name}: {st['calls']} calls, median {st['median_ms']:.3f} ms per call "
              f"(synchronized on both sides) ({card})")
    print(f"[stages] frame median in that pass {np.median(timed_ms):.2f} ms")

    phase_s[4] = time.perf_counter() - t_mark

    # ---- phase 5: the CPU plain path agrees with the CUDA run --------------
    t_mark = time.perf_counter()
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

    phase_s[5] = time.perf_counter() - t_mark
    print(f"[phases] phases 1-5 took {phase_s[1]:.1f}, {phase_s[2]:.1f}, {phase_s[3]:.1f}, {phase_s[4]:.1f}, "
          f"{phase_s[5]:.1f} s")

    # ---- phase 6: the GNSS/INS replay, and its odometer run -----------------
    t_mark = time.perf_counter()
    gins_model = gins_phase(torch, card)
    phase_s[6] = time.perf_counter() - t_mark

    # ---- phase 7: the GNSS-visual-inertial replay --------------------------
    t_mark = time.perf_counter()
    replay_launches = gvins_phase(torch, card, wrappers)
    phase_s[7] = time.perf_counter() - t_mark

    # ---- phase 8: the long fault world from files, through the runner ------
    t_mark = time.perf_counter()
    long_launches = long_phase(torch, card, wrappers)
    phase_s[8] = time.perf_counter() - t_mark

    # ---- phase 9: the batched forms of parallel/mesh.py, the checkpoint ----
    t_mark = time.perf_counter()
    fleet_launches = fleet_phase(torch, card, wrappers, images, gins_model.est)
    phase_s[9] = time.perf_counter() - t_mark

    # ---- phase 10: the user functions, and the measurement scripts --------
    t_mark = time.perf_counter()
    script_launches = script_phase(torch, card, wrappers)
    phase_s[10] = time.perf_counter() - t_mark

    # ---- phase 11: extrinsic and td estimation on: two worlds --------------
    t_mark = time.perf_counter()
    estimation_launches = estimation_phase(torch, card, wrappers)
    phase_s[11] = time.perf_counter() - t_mark

    # ---- phase 12: the fault paths to their end, at 160x120 and 1278x1022 --
    t_mark = time.perf_counter()
    fault_launches = fault_phase(torch, card, wrappers)
    phase_s[12] = time.perf_counter() - t_mark
    for k in records:
        records[k]["launches_by_path"] = {"frontend_slice": records[k]["launches"],
                                          "gvins_replay": int(replay_launches[k]),
                                          "long_fault_replay": int(long_launches[k]),
                                          "fleet_frontend": int(fleet_launches[k]),
                                          **{path: int(n[k]) for path, n in script_launches.items()},
                                          **{f"{path}_replay": int(n[k]) for path, n in estimation_launches.items()},
                                          **{f"{path}_replay": int(n[k]) for path, n in fault_launches.items()}}
        records[k]["launches"] = int(long_launches[k])
    print(f"[phases] seconds by phase {json.dumps({str(k): round(v, 1) for k, v in sorted(phase_s.items())})}, "
          f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [records[k] for k in ("clahe_apply", "lk_pyr", "subpix")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gvins-cpu-twin"]:    # phase 7's child process
        with open(sys.argv[2], "wb") as f:
            pickle.dump(gvins_small_run("cpu", GVINS_TWIN_CORES), f)
        sys.exit(0)
    if sys.argv[1:2] == ["--estimation-cpu-twins"]:   # phase 11's child process
        with open(sys.argv[2], "wb") as f:
            pickle.dump((td_replay("cpu", GVINS_TWIN_CORES, float(sys.argv[3])),
                         stab_trace_run(__import__("torch"), "cpu", float(sys.argv[4]), cores=GVINS_TWIN_CORES,
                                        until=float(sys.argv[5]))), f)
        sys.exit(0)
    if sys.argv[1:2] == ["--fault-cpu-twin"]:    # phase 12's child process
        with open(sys.argv[2], "wb") as f:
            pickle.dump(fault_trace_run(__import__("torch"), "cpu", float(sys.argv[3]), cores=GVINS_TWIN_CORES), f)
        sys.exit(0)
    if sys.argv[1:2] == ["--stab-trace"]:        # stability_parting's child process
        with open(sys.argv[2], "wb") as f:
            pickle.dump(stab_trace_run(__import__("torch"), "cpu", float(sys.argv[3]),
                                       cores=int(sys.argv[4]) if len(sys.argv) > 4 else GVINS_TWIN_CORES), f)
        sys.exit(0)
    if sys.argv[1:2] == ["--scatter-ab"]:
        scatter_ab()
        sys.exit(0)
    if sys.argv[1:2] == ["--stab-parting"]:
        stability_parting(sys.argv[2], *(float(a) for a in sys.argv[3:4]),
                          *(tuple(a.split(",")) for a in sys.argv[4:5]))
        sys.exit(0)
    sys.exit(main())
