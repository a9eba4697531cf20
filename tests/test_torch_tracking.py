"""The port's frontend slice at small size: test_tracking.py's rendered
14-frame sequence through both Trackers, with the port's RANSAC draw
replaced by the reference's table. Also: the port imports neither jax nor
yaml, and the kernel wrappers route CPU tensors to their plain versions and
refuse tensors on any other non-CUDA device."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_tracking import make_scene, render, small_camera
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.vision import map as jmap
from ic_gvins_tpu.vision import tracking as jtrk
import ic_gvins_tpu_torch.engine.config as tconfig
from ic_gvins_tpu_torch.ops import clahe as kclahe
from ic_gvins_tpu_torch.ops import lk as klk
from ic_gvins_tpu_torch.ops import subpix as ksubpix
from ic_gvins_tpu_torch.vision import camera as tcam
from ic_gvins_tpu_torch.vision import map as tmap
from ic_gvins_tpu_torch.vision import pyramid as tpyr
from ic_gvins_tpu_torch.vision import ransac as transac
from ic_gvins_tpu_torch.vision import tracking as ttrk

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CFG = dict(track_check_histogram=False, track_min_parallax=20, track_max_interval=0.5,
           track_max_features=120, reprojection_error_std=1.5, optimize_windows_size=8)


@jax.jit
def _jax_table(valid):
    """The reference's hypothesis draw (ransac.py:149-153)."""
    probs = valid / jnp.maximum(jnp.sum(valid), 1.0)
    return jax.random.choice(jax.random.PRNGKey(0), valid.shape[0], shape=(256, 8), p=probs)


def _run(tracker, vmap, frame_cls, images, poses):
    rows = []
    for k, (img, (R, t)) in enumerate(zip(images, poses)):
        frame = frame_cls(stamp=0.1 * k)
        frame.R, frame.t = R, t.copy()
        st = tracker.track(frame, img)
        # the engine layer inserts tracker keyframes into the map
        if tracker.is_new_keyframe or st == jtrk.TRACK_FIRST_FRAME:
            if frame.kf_id is None:
                frame.set_keyframe(2)
            vmap.insert_keyframe(frame)
        rows.append((st, tracker.is_new_keyframe, len(frame.features), len(tracker.pts_new)))
    return rows


@pytest.fixture(scope="module")
def both_runs():
    camera = small_camera()
    pts = make_scene()
    poses = [(np.eye(3), np.array([0.15 * k, 0.0, 0.0])) for k in range(14)]
    images = [render(camera, pts, R, t) for R, t in poses]

    jcfg = jparse(CFG)
    jvmap = jmap.VisualMap(jcfg.optimize_windows_size)
    ref = _run(jtrk.Tracker(camera, jvmap, jcfg, F_MAX=256), jvmap, jmap.VFrame, images, poses)

    tcfg = tconfig.parse_config(CFG)
    tvmap = tmap.VisualMap(tcfg.optimize_windows_size)
    tracker = ttrk.Tracker(tcam.PinholeCamera(*camera), tvmap, tcfg, F_MAX=256, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator:
               torch.tensor(np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
    try:
        port = _run(tracker, tvmap, tmap.VFrame, images, poses)
    finally:
        mp.undo()
    return ref, port, tvmap, pts


def test_states_and_keyframes_identical(both_runs):
    ref, port, _, _ = both_runs
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    assert ttrk.TRACK_TRACKING in [r[0] for r in port]


def test_tracked_counts_close(both_runs):
    """Landmark observations and reference tracks per frame within 2: the
    JAX CPU path culls LK tracks at its 48x128 gather block, the port does
    not."""
    ref, port, _, _ = both_runs
    for k, (r, p) in enumerate(zip(ref, port)):
        assert abs(r[2] - p[2]) <= 2 and abs(r[3] - p[3]) <= 2, f"frame {k}: {r} vs {p}"


def test_port_landmarks_near_truth(both_runs):
    _, _, vmap, pts = both_runs
    assert len(vmap.keyframes) >= 2 and len(vmap.landmarks) >= 20
    errs = [np.linalg.norm(pts - lm.pos, axis=1).min() for lm in vmap.landmarks.values()]
    assert np.median(errs) < 0.6, f"median landmark error {np.median(errs):.3f} m"


def test_port_imports_no_jax_or_yaml():
    mods = ["ic_gvins_tpu_torch", "ic_gvins_tpu_torch.convert", "ic_gvins_tpu_torch.ops._build"] + [
        f"ic_gvins_tpu_torch.{p}.{m}" for p, ms in
        (("core", ("rotation_np", "quaternion", "earth", "earth_np", "types", "gpstime")),
         ("engine", ("config", "host", "replay", "estimator", "output", "checkpoint")),
         ("parallel", ("mesh",)),
         ("ins", ("parallel_scan", "mechanization", "preintegration", "preintegration_odo")),
         ("factors", ("robust", "basic", "preint_factor", "preint_odo_factor", "reprojection",
                      "marginalization")),
         ("solver", ("problem", "lm")),
         ("models", ("gins", "gvins")),
         ("vision", ("map", "camera", "pyramid", "lk", "features", "ransac", "tracking", "drawer")),
         ("ops", ("clahe", "lk", "subpix")),
         ("io", ("dataset",)),
         ("utils", ("logger", "timecost"))) for m in ms]
    # the runner, the four measurement scripts and chip_smoke.py too
    # (imported as modules: their work runs under their __main__ checks)
    scripts = [str(REPO / "scripts" / f"{name}.py") for name in (
        "run_gvins_torch", "bench_frontend_stages_torch", "profile_replay_sections_torch",
        "bench_replay_host_torch", "bench_production_torch")] + [str(REPO / "chip_smoke.py")]
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"for i, path in enumerate({scripts!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'script{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in ('jax', 'yaml', 'ic_gvins_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def _wrapper_cases(device):
    g = torch.Generator().manual_seed(0)
    img_cpu = torch.rand((48, 64), generator=g) * 255
    img = img_cpu.to(device)
    pts = (torch.rand((8, 2), generator=g) * 30 + 15).to(device)
    valid = torch.ones(8, dtype=torch.bool, device=device)
    v = img.to(torch.int32)
    lut = (torch.rand((4 * 4, 256), generator=g) * 255).to(torch.bfloat16).to(device)
    pyr = [lv.to(device) for lv in tpyr.build_pyramid(img_cpu)]
    return [
        (kclahe.clahe_apply, kclahe.clahe_apply_plain, (v, lut, (4, 4), (12, 16))),
        (klk.lk_pyr, klk.lk_pyr_plain, (pyr, pyr, pts, pts + 0.5, valid)),
        (ksubpix.subpix, ksubpix.subpix_plain, (img, pts, valid)),
    ]


def test_wrappers_route_cpu_to_plain_without_launches():
    for wrapper, plain, args in _wrapper_cases("cpu"):
        out, want = wrapper(*args), plain(*args)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
        assert wrapper.launches == 0


def test_wrappers_refuse_non_cuda_devices():
    """No hidden fallback: a tensor that is not on the CPU goes to the kernel
    or raises; the launch counters do not move."""
    for wrapper, _, args in _wrapper_cases("meta"):
        with pytest.raises(ValueError):
            wrapper(*args)
        assert wrapper.launches == 0


def test_step_counts_subpix_also_on_cpu_lk_on_the_card_only():
    """``iters`` (steps a slot took): a CPU subpix call fills it from the
    plain version's count without a launch; the plain LK does not count, so
    a CPU LK call that asks for it raises."""
    for wrapper, plain, args in _wrapper_cases("cpu"):
        iters = torch.zeros(8, dtype=torch.int32)
        if wrapper is klk.lk_pyr:
            with pytest.raises(ValueError, match="iters"):
                wrapper(*args, iters=iters)
        elif wrapper is ksubpix.subpix:
            steps = torch.zeros(8, dtype=torch.int32)
            assert torch.equal(wrapper(*args, iters=iters), plain(*args, steps=steps))
            assert torch.equal(iters, steps) and bool(((iters >= 1) & (iters <= 20)).all())
        assert wrapper.launches == 0


def test_entry_points_default_to_cuda():
    """Tracker and pyramid_from_numpy run on the card unless the caller asks
    for the CPU; without CUDA the first device op raises, nothing falls back."""
    from ic_gvins_tpu_torch.convert import pyramid_from_numpy

    cfg = tconfig.parse_config(CFG)
    tracker = ttrk.Tracker(tcam.PinholeCamera(*small_camera()), tmap.VisualMap(8), cfg)
    assert tracker.device.type == "cuda"
    levels = [np.ones((4, 6), np.float32)]
    if torch.cuda.is_available():
        assert pyramid_from_numpy(levels)[0].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            pyramid_from_numpy(levels)
        with pytest.raises((RuntimeError, AssertionError)):
            tracker.track(tmap.VFrame(stamp=0.0), np.zeros((240, 320)))
    assert pyramid_from_numpy(levels, device="cpu")[0].device.type == "cpu"


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A failing nvcc raises with its output; nothing is loaded."""
    from ic_gvins_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.library()
    assert _build._lib is None and not list((tmp_path / "build").glob("*.so"))


def test_chip_smoke_fails_without_a_gpu():
    """chip_smoke.py exits nonzero and prints no result where CUDA is absent."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "import runpy\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
