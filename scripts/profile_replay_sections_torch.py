#!/usr/bin/env python3
"""Attribute the port's GVINS replay time to pipeline sections, on the card
(the port of scripts/profile_replay_sections.py, which measures the JAX
package).

    python3 scripts/profile_replay_sections_torch.py [--device cuda|cpu]

The world and configuration of scripts/bench_replay_host.py: the 24 s drive
of tests/gins_data.py with earth rate on (``chip_smoke.gins_world``, its
jax-free copy) cut to 15.2 s and 14 GNSS fixes; tests/test_gvins_e2e.py's
320x240 camera over its 800 ground points (frames rendered beforehand, so
rendering is outside every section); production slots (20 nodes, 512
landmarks, 24 GNSS, 2048 reprojection rows), 20 LM iterations, 200
features.

Every method of the JAX script's list that the port has (``gvins.*`` on the
model, ``trk.*`` on the tracker, ``est.*`` and ``prop.*`` once the
estimator and propagator exist) is wrapped with an EXCLUSIVE-time section
timer: a section's time less its children's. The leaf ``dev:`` sections are
the port's device-work calls: the tracker's stages (``_pyr_body``,
``_lk_stage``, ``_detect_stage``, ``_detect_nomask_stage``, RANSAC and
triangulation), the LM solve and chi2 surgery of ``est.optimize``, the
marginalization calls, ``est._preintegrate`` and ``prop.propagate_to``.
Each is timed with ``torch.cuda.synchronize()`` on both sides, so its time
is its host dispatch plus its wait for the device (the wait for work queued
before it falls to the section that queued it).

One replay (after a warm replay that pays the cuBLAS / cuSOLVER handles and
the caching allocator, unless ``warm=False``): its frames outside the
profiled window feed the section times; the frames inside it
(``window``, frames [a, b) of the replay's processed frames) run under ``torch.profiler`` with each dev:
call in a ``record_function`` span, which gives each dev: section's device
busy time a call. A dev: section's ``device_ms`` is that a call times its
calls a frame, and ``host_ms`` its exclusive time less that: the split of
host and device that the synchronized timers cannot see.

Prints one JSON line: the card, wall ms a frame, and {section: {excl_ms,
calls}} a frame (dev: sections also device_ms, host_ms), sorted by
exclusive time, and the kernels' launches. ``main(argv)`` returns it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

GVINS = ["_process_frame", "_add_keyframe_nodes", "_drain_pending_gnss", "_optimize_visual",
         "_build_reproj_table", "_assign_landmark_slots", "_update_from_optimizer", "_visual_outlier_culling",
         "_remove_second_new_frames", "_marginalize_visual", "_write_statistics", "_merge_unused_nodes",
         "_fresh_tables_and_params"]
TRACKER = ["_track_impl", "_lk_fused", "features_detection", "triangulation", "_prepare_mappoint_tracking",
           "_finish_mappoint_tracking", "_prepare_reference_tracking", "_finish_reference_tracking",
           "check_keyframe_state", "_keypoint_parallax", "_undis", "_dis", "_pixel2cam"]
ESTIMATOR = ["build_tables", "build_params", "optimize", "add_time_node", "marginalize",
             "reintegrate_if_needed", "merge_node", "node_state", "_pad_segment"]
PROPAGATOR = ["pose_interpolated"]
_MISSING = object()


def replay_world(seconds=15.2):
    """(imu, gnss, truth, frame_times, images, cfg) of the replay benches:
    bench_replay_host.py's world through the port's jax-free copies."""
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.engine.config import parse_config
    from ic_gvins_tpu_torch.vision import camera as cam

    imu, gnss, truth = cs.gins_world(with_earth=True)
    n = int(seconds * 200)
    imu = {k: np.asarray(v)[:n] for k, v in imu.items()}
    gnss = {k: np.asarray(v)[:int(seconds) - 1] for k, v in gnss.items()}
    intrinsic, distortion, resolution = cs.SMALL_CAMERA
    cfg = parse_config(dict(
        initlength=3, imudatarate=200, iswithearth=True, antlever=list(truth["lever"]),
        imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
        optimize_windows_size=10, optimize_num_iterations=20, optimize_estimate_extrinsic=False,
        optimize_estimate_td=False, track_min_parallax=20, track_max_interval=0.5, track_max_features=200,
        reprojection_error_std=1.5, node_slots=20, landmark_slots=512, gnss_slots=24, reproj_slots=2048,
        cam0=dict(intrinsic=intrinsic, distortion=distortion, resolution=resolution, q_b_c=[0.0, 0.0, 0.0, 1.0],
                  t_b_c=[0.0, 0.0, 0.0], td_b_c=0.0)))
    camera = cam.PinholeCamera.from_config(intrinsic, distortion, resolution)
    times, images = cs.gvins_frames(cam, rotation_np, camera, dict(truth, time=imu["time"]), cs.e2e_scene(),
                                    cs.SMALL_BLOB)
    return imu, gnss, truth, times, images, cfg


class SectionProf:
    """Exclusive-time section timers. ``mode``: "time" accumulates, "annotate"
    only puts each dev: call in a torch.profiler ``record_function`` span,
    None passes calls through."""

    def __init__(self, torch, device):
        self.torch, self.mode = torch, None
        self.sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        self.stack, self.excl, self.calls = [], {}, {}
        self._saved = []

    def wrap_fn(self, fn, label):
        dev = label.startswith("dev:")

        def timed(*a, **k):
            if self.mode is None or (self.mode == "annotate" and not dev):
                return fn(*a, **k)
            if self.mode == "annotate":
                self.sync()
                with self.torch.profiler.record_function(label):
                    out = fn(*a, **k)
                    self.sync()
                return out
            if dev:
                self.sync()
            t0 = time.perf_counter()
            self.stack.append([label, 0.0])
            try:
                out = fn(*a, **k)
                if dev:
                    self.sync()
                return out
            finally:
                dt = time.perf_counter() - t0
                _, child = self.stack.pop()
                self.excl[label] = self.excl.get(label, 0.0) + dt - child
                self.calls[label] = self.calls.get(label, 0) + 1
                if self.stack:
                    self.stack[-1][1] += dt
        return timed

    def wrap(self, owner, name, label):
        """Wrap ``owner.name`` if the port has it; returns whether it did."""
        if not hasattr(owner, name):
            return False
        self._saved.append((owner, name, vars(owner).get(name, _MISSING)))
        setattr(owner, name, self.wrap_fn(getattr(owner, name), label))
        return True

    def restore(self):
        for owner, name, old in reversed(self._saved):
            if old is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._saved.clear()


def module_leaves():
    """(module, function name, dev: label) of the port's device-work calls
    that live at module level (looked up through the module when called)."""
    from ic_gvins_tpu_torch.factors import marginalization as marg
    from ic_gvins_tpu_torch.solver import lm
    from ic_gvins_tpu_torch.vision import ransac
    from ic_gvins_tpu_torch.vision import tracking as trk

    return ([(trk, n, f"dev:{n}") for n in ("_pyr_body", "_lk_stage", "_detect_stage", "_detect_nomask_stage")]
            + [(ransac, n, f"dev:ransac.{n}") for n in ("fundamental_ransac", "triangulate_batch")]
            + [(lm, n, f"dev:lm.{n}") for n in ("solve", "outlier_surgery")]
            + [(marg, n, f"dev:marg.{n}") for n in ("select_marg_factors", "marginalize", "shift_prior",
                                                    "drop_node_from_prior", "insert_node_slot_into_prior")])


def profile_sections(torch, device, world, warm=True, window=(50, 70)):
    """Run the replay with the section timers (and the profiled window);
    returns (result dict, model)."""
    from ic_gvins_tpu_torch.models.gvins import GvinsModel

    imu, gnss, _, times, images, cfg = world
    if warm:
        GvinsModel(cfg, device=device).run(imu, gnss, times, lambda k: images[k])
    prof = SectionProf(torch, device)
    for mod, name, label in module_leaves():
        prof.wrap(mod, name, label)
    model = GvinsModel(cfg, device=device)
    missing = [f"gvins.{n}" for n in GVINS if not prof.wrap(model, n, f"gvins.{n}")]
    missing += [f"trk.{n}" for n in TRACKER if not prof.wrap(model.tracker, n, f"trk.{n}")]
    state = dict(frame=0, late=False, timed_frames=0, window_frames=0, wall_timed=0.0, session=None)
    process = model._process_frame

    def frame_hook(stream, stamp, image):
        if not state["late"] and model.prop is not None and model.est is not None:
            missing.extend(f"est.{n}" for n in ESTIMATOR if not prof.wrap(model.est, n, f"est.{n}"))
            prof.wrap(model.est, "_preintegrate", "dev:est._preintegrate")
            prof.wrap(model.prop, "propagate_to", "dev:prop.propagate_to")
            missing.extend(f"prop.{n}" for n in PROPAGATOR if not prof.wrap(model.prop, n, f"prop.{n}"))
            state["late"] = True
        k = state["frame"]
        in_window = window[0] <= k < window[1]
        if k == window[0]:
            from torch.profiler import ProfilerActivity, profile

            cuda = torch.device(device).type == "cuda"
            prof.sync()
            state["session"] = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda)
            state["session"].__enter__()
        prof.mode = "annotate" if in_window else "time"
        t0 = time.perf_counter()
        try:
            return process(stream, stamp, image)
        finally:
            if in_window:
                state["window_frames"] += 1
            else:
                state["wall_timed"] += time.perf_counter() - t0
                state["timed_frames"] += 1
            state["frame"] += 1
            if k == window[1] - 1:
                prof.sync()
                state["session"].__exit__(None, None, None)
                prof.mode = "time"

    model._process_frame = frame_hook
    launches0 = cs.kernel_launches()
    prof.sync()
    t_run = time.perf_counter()
    try:
        model.run(imu, gnss, times, lambda k: images[k])
        prof.sync()
    finally:
        t_run = time.perf_counter() - t_run
        prof.mode = None
        if state["session"] is not None and state["frame"] < window[1]:
            state["session"].__exit__(None, None, None)
        prof.restore()
    launches = {k: v - launches0[k] for k, v in cs.kernel_launches().items()}

    nf = max(state["timed_frames"], 1)
    busy = {}
    if state["session"] is not None:
        spans = cs.annotated_device_ms(torch, state["session"], "dev:")
        for name, b, _ in spans or []:
            n, total = busy.get(name, (0, 0.0))
            busy[name] = (n + 1, total + b)
    sections = {}
    for label, secs in sorted(prof.excl.items(), key=lambda kv: -kv[1]):
        row = dict(excl_ms=1e3 * secs / nf, calls=prof.calls[label] / nf)
        if label.startswith("dev:"):
            if label in busy:
                n, total = busy[label]
                row["device_ms"] = total / n * row["calls"]
                row["host_ms"] = row["excl_ms"] - row["device_ms"]
            else:
                row["device_ms"] = row["host_ms"] = None
        sections[label] = row
    out = dict(frames=state["timed_frames"] + state["window_frames"], timed_frames=state["timed_frames"],
               window=list(window), window_frames=state["window_frames"],
               wall_ms_per_frame=1e3 * state["wall_timed"] / nf, replay_s=t_run, not_in_port=missing,
               state=model.state, episodes=sum(model.tier_counts.values()),
               sections_ms_per_frame=sections, launches=launches)
    return out, model


def main(argv=None, seconds=15.2, warm=True, window=(50, 70)):
    """Profile the replay; print and return the JSON record. ``seconds``
    (the drive), ``warm`` (the warm replay first) and ``window`` (the
    profiled frames) shrink the run for a CPU check or a smoke."""
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = cs.card_record(torch, dev)
    world = replay_world(seconds)
    out, _ = profile_sections(torch, dev, world, warm=warm, window=window)
    rec.update(seconds=seconds, **out)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
