"""The long fault world of tests/test_gvins_long_e2e.py through the port.

``chip_smoke.py`` phase 8 builds that world without jax (``long_world``),
writes it to files (``write_world_files``) and replays them through
``scripts/run_gvins_torch.py``. The first test holds the jax-free world
equal to the test's own: the IMU stream, the GNSS fixes left after the
outage mask and frames of the drive (a normal one, glitch frames, blackout
frames) within 1e-9.

The slow tests (``-m slow -s``, they print what ROADMAP R1 records):
- the same files through the runner on the CPU (``--device cpu``) with the
  five gates of that test, at 1 and at 4 torch threads, the two runs held
  within 1e-4 m of each other up to where they end. The port refuses a
  window slide of more than ``marg_cap`` nodes after the frame at 40.25 s,
  as the JAX package refuses such a slide, so the gates fail: the failure
  is left standing (ROADMAP R1);
- the JAX replay (its solve in f64, as tests/test_torch_gvins_twin.py patches
  it; in that file's child process with async dispatch off) and the port's (the JAX
  RANSAC table), on the in-memory world and on the world as the port's
  loaders read it back from the files. In memory they agree on every frame
  (state, keyframe episodes, node count, positions within 1e-3 m) until
  both refuse the same slide. From the files they agree over the first
  20 s and more, then part: the frame where they part and both outcomes
  are printed;
- both frontends alone at the true poses across the blackout: the same
  states on every frame, TRACK_LOST at its first frame.

The fault paths that this world reaches only after the refusal (the
histogram gate, the GNSS outage, TRACK_LOST over the blackout, the GNSS
ingest gates) run to their end in ``chip_smoke.fault_world``, a 40 s drive
with the faults inside it: tests/test_torch_faults.py holds both packages'
replays of it, and ``chip_smoke.py`` phase 12 runs it on the card."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_gvins_long_e2e as ref
from gins_data import make_gins_dataset
from test_torch_harness import jax_child, jax_result
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu_torch.core import rotation_np
from ic_gvins_tpu_torch.vision import camera as tcam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames: the first, a normal one, glitch frames (45.05, 45.95), blackout
# frames (85.05, 86.45), the first after the blackout, the last
FRAMES = (0, 300, 450, 459, 850, 864, 865, 1197)


def _ref_frame(camera, pts_w, truth, t):
    """tests/test_gvins_long_e2e.py's image_provider at stamp ``t``."""
    if ref.BLACKOUT[0] <= t < ref.BLACKOUT[1]:
        return np.full((ref.H, ref.W), 90.0)
    i = min(int(round(t * 200.0)) - 1, len(truth["p"]) - 1)
    img = ref._render(camera, pts_w, np.asarray(jquat.to_matrix(jnp.asarray(truth["q"][i]))), truth["p"][i])
    if ref.GLITCH[0] <= t < ref.GLITCH[1]:
        img = np.clip(img * 1.35, 0, 255)
    return img


def test_chip_smoke_long_world_matches_the_test():
    imu, gnss, truth, frame_times, frame = chip_smoke.long_world(tcam, rotation_np)
    rimu, rgnss, rtruth = make_gins_dataset(turn_duration=114.0)
    keep = ~((rgnss["time"] >= ref.OUTAGE[0]) & (rgnss["time"] < ref.OUTAGE[1]))
    assert (chip_smoke.LONG_OUTAGE, chip_smoke.LONG_GLITCH, chip_smoke.LONG_BLACKOUT) == \
        (ref.OUTAGE, ref.GLITCH, ref.BLACKOUT)
    np.testing.assert_array_equal(gnss["time"], rgnss["time"][keep])
    assert not np.any((gnss["time"] >= 60.0) & (gnss["time"] < 75.0)) and len(gnss["time"]) == 104
    for k in ("dtheta", "dvel", "dt", "time"):
        np.testing.assert_allclose(imu[k], rimu[k], atol=1e-9, rtol=0, err_msg=k)
    np.testing.assert_allclose(gnss["blh"][:, :2], np.asarray(rgnss["blh"])[keep, :2], atol=1e-9, rtol=0)
    np.testing.assert_allclose(truth["p"], rtruth["p"], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(frame_times, np.arange(0.05, rimu["time"][-1] - 0.2, 0.1))

    rng = np.random.default_rng(7)
    pts_w = np.stack([rng.uniform(-80, 140, 6000), rng.uniform(-80, 140, 6000), rng.uniform(9, 13, 6000)], axis=1)
    camera = jcam.PinholeCamera.from_config([ref.FX, ref.FX, 80.0, 60.0], [-0.05, 0.01, 0.0, 0.0], [ref.W, ref.H])
    assert tuple(chip_smoke.LONG_CAMERA[2]) == (ref.W, ref.H) and chip_smoke.LONG_CAMERA[0][0] == ref.FX
    kinds = set()
    for k in FRAMES:
        t = frame_times[k]
        kinds.add("glitch" if ref.GLITCH[0] <= t < ref.GLITCH[1] else
                  "blackout" if ref.BLACKOUT[0] <= t < ref.BLACKOUT[1] else "normal")
        np.testing.assert_allclose(frame(k), _ref_frame(camera, pts_w, rtruth, t), atol=1e-9, rtol=0,
                                   err_msg=f"frame {k}")
    assert kinds == {"glitch", "blackout", "normal"}


def _gates(model, nodes, truth, outdir):
    """tests/test_gvins_long_e2e.py's five tests on the port's run."""
    def errs(t_lo=0.0, t_hi=1e9, exclude=()):
        keep = [r for r in nodes if t_lo <= r[0] <= t_hi and not any(lo - 2.0 <= r[0] <= hi + 3.0
                                                                      for lo, hi in exclude)]
        return chip_smoke.node_errors(np.asarray(keep), truth)[1] if keep else np.zeros(0)

    assert model.state == "TRACKING_NORMAL", model.state
    assert nodes[-1][0] > 110.0, "replay died early"
    outside = errs(t_lo=8.0, exclude=(ref.OUTAGE, ref.BLACKOUT))
    assert len(outside) > 40 and outside.mean() < 0.3, outside
    bridge = errs(ref.OUTAGE[0], ref.OUTAGE[1] + 2.0)
    assert len(bridge) > 3 and bridge.max() < 3.0, bridge
    tail = errs(t_lo=100.0)
    assert len(tail) > 5 and tail.mean() < 0.25, tail
    post = errs(ref.BLACKOUT[1] + 3.0, 100.0)
    assert len(post) > 3 and post.mean() < 0.3, post
    stats = np.loadtxt(os.path.join(outdir, "statistics.txt"), ndmin=2)
    assert stats.shape[1] == 15 and len(stats) > 30
    assert np.loadtxt(os.path.join(outdir, "tracking.txt"), ndmin=2).shape[1] == 7
    assert len(np.loadtxt(os.path.join(outdir, "extrinsic.txt"), ndmin=2)) >= 1
    assert np.linalg.norm(model.pose_b_c_t) < 1.0 and abs(model.td_b_c) <= 0.081
    return dict(outside=outside.mean(), bridge_max=bridge.max(), tail=tail.mean(), post=post.mean())


@pytest.fixture(scope="module")
def world_files(tmp_path_factory):
    imu, gnss, truth, frame_times, frame = chip_smoke.long_world(tcam, rotation_np)
    intrinsic, distortion, resolution = chip_smoke.LONG_CAMERA
    raw = dict(chip_smoke.LONG_RAW, is_make_outputdir=False, antlever=list(truth["lever"]), cam0=dict(
        intrinsic=intrinsic, distortion=distortion, resolution=resolution, q_b_c=[0.0, 0.0, 0.0, 1.0],
        t_b_c=[0.0, 0.0, 0.0], td_b_c=0.0))
    root = str(tmp_path_factory.mktemp("long_world"))
    return chip_smoke.write_world_files(root, imu, gnss, frame_times, frame, raw), truth


def _runner():
    import importlib.util

    spec = importlib.util.spec_from_file_location("run_gvins_torch", os.path.join(REPO, "scripts",
                                                                                  "run_gvins_torch.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    return runner


_RUNS = {}


@pytest.mark.slow
@pytest.mark.parametrize("threads", [1, 4])
def test_long_world_through_the_runner(world_files, threads, tmp_path):
    from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins

    paths, truth = world_files
    models, run = [], TGvins.run

    def kept(self, *args):
        models.append(self)
        return run(self, *args)

    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    mp = pytest.MonkeyPatch()
    mp.setattr(TGvins, "run", kept)
    try:
        outdir = str(tmp_path / "out")
        _runner().main(["--config", paths["config"], "--imu", paths["imu"], "--gnss", paths["gnss"],
                        "--frames", paths["frames"], "--imagedir", paths["imagedir"], "--output", outdir,
                        "--device", "cpu"])
        err = None
    except ValueError as e:
        err = e
    finally:
        mp.undo()
        torch.set_num_threads(saved)
    model = models[0]
    nodes = np.asarray(model.trajectory)
    print(f"\n{threads} thread(s): {len(nodes)} nodes to {nodes[-1, 0]:.2f} s; {err or 'ran to the end'}")
    _RUNS[threads] = nodes
    if len(_RUNS) == 2:
        a, b = _RUNS[1], _RUNS[4]
        assert a.shape == b.shape
        diff = float(np.abs(a - b).max())
        print(f"1 and 4 threads: {len(a)} nodes, bit-identical {np.array_equal(a, b)}, max difference {diff:.3g}")
        assert diff < 1e-4
    assert err is None, f"the replay stopped: {err}"
    print(f"the five gates: {_gates(model, nodes, truth, outdir)}")


def _paths(root):
    paths = {k: os.path.join(root, f) for k, f in (("config", "gvins.yaml"), ("imu", "imu.txt"),
                                                    ("gnss", "gnss.txt"), ("frames", "frames.txt"))}
    return dict(paths, imagedir=root)


def _twin_world(source, root):
    """The long world in memory, or as the port's loaders read it back from
    the files under root; with the configuration of the test."""
    from ic_gvins_tpu_torch.io import dataset

    imu, gnss, truth, frame_times, frame = chip_smoke.long_world(tcam, rotation_np)
    intrinsic, distortion, resolution = chip_smoke.LONG_CAMERA
    raw = dict(chip_smoke.LONG_RAW, antlever=list(truth["lever"]), cam0=dict(
        intrinsic=intrinsic, distortion=distortion, resolution=resolution, q_b_c=[0.0, 0.0, 0.0, 1.0],
        t_b_c=[0.0, 0.0, 0.0], td_b_c=0.0))
    if source == "memory":
        return imu, gnss, frame_times, [frame(k) for k in range(len(frame_times))], raw
    paths = _paths(root)
    times, provider = dataset.load_frame_index(paths["frames"], paths["imagedir"])
    return (dataset.load_imu(paths["imu"], 200.0), dataset.load_gnss(paths["gnss"]), times,
            [provider(k) for k in range(len(times))], raw)


def _logged_run(model, imu, gnss, frame_times, images):
    """The replay with (stamp, state, episodes run, node times, positions,
    the last episode's accepted LM steps of both passes) after every
    processed frame; stops at a ValueError, returned."""
    log, cls = [], type(model)
    process = cls._process_frame

    def logged(self, stream, stamp, image):
        n0 = sum(self.tier_counts.values())
        out = process(self, stream, stamp, image)
        n = self.est.n_nodes
        log.append((round(float(stamp), 2), self.state, sum(self.tier_counts.values()) - n0,
                    self.est.times[:n].copy(), self.est.poses[:n, :3].copy(), tuple(int(i) for i in self.iterations)))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(cls, "_process_frame", logged)
    try:
        model.run(imu, gnss, frame_times, lambda k: images[k])
        err = None
    except ValueError as e:
        err = e
    finally:
        mp.undo()
    return log, err


def jax_twin_run(source, root, out_path):
    """The JAX replay of ``_twin_world`` (its solve in f64) with output
    files, pickled to out_path as (log, error message or None, the five
    gates' values or the gate that failed, where it ran to the end)."""
    from test_torch_gins import _precise_solve_jit
    from ic_gvins_tpu.engine import estimator as jest
    from ic_gvins_tpu.engine.config import parse_config as jparse
    from ic_gvins_tpu.models.gvins import GvinsModel as JGvins

    imu, gnss, frame_times, images, raw = _twin_world(source, root)
    outdir = os.path.join(os.path.dirname(out_path), f"jax_{source}")
    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        model = JGvins(jparse(raw), outdir=outdir)
        log, err = _logged_run(model, imu, gnss, frame_times, images)
    finally:
        mp.undo()
    gates = None
    if err is None:
        truth = chip_smoke.long_world(tcam, rotation_np)[2]
        try:
            gates = {k: float(v) for k, v in _gates(model, np.asarray(model.trajectory), truth, outdir).items()}
        except AssertionError as e:
            gates = f"failed: {e}"
    with open(out_path, "wb") as f:
        pickle.dump((log, None if err is None else str(err), gates), f)


@pytest.mark.slow
@pytest.mark.parametrize("source", ["memory", "files"])
def test_long_world_jax_twin_until_the_marg_cap(source, world_files, tmp_path):
    from test_torch_tracking import _jax_table
    from ic_gvins_tpu_torch.engine.config import parse_config as tparse
    from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins
    from ic_gvins_tpu_torch.vision import ransac as transac

    paths, _ = world_files
    out_path = str(tmp_path / "jax_twin.pkl")
    child = jax_child("test_torch_long_e2e:jax_twin_run", source, paths["imagedir"], out_path)
    mp = pytest.MonkeyPatch()
    try:
        imu, gnss, frame_times, images, raw = _twin_world(source, paths["imagedir"])
        mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator: torch.tensor(
            np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
        tlog, terr = _logged_run(TGvins(tparse(raw), device="cpu"), imu, gnss, frame_times, images)
    finally:
        mp.undo()
        jlog, jerr, jgates = jax_result(child, out_path, timeout=3000)

    # the frames on which the two agree: state, episodes and node count
    # equal, positions within 1e-3 m
    part = next((i for i, (a, b) in enumerate(zip(jlog, tlog)) if a[:3] != b[:3] or len(a[3]) != len(b[3])
                 or np.abs(a[4] - b[4]).max() > 1e-3), None)
    n = min(len(jlog), len(tlog)) if part is None else part
    dt = max(float(np.abs(a[3] - b[3]).max()) for a, b in zip(jlog[:n], tlog[:n]))
    dp = max(float(np.abs(a[4] - b[4]).max()) for a, b in zip(jlog[:n], tlog[:n]))
    print(f"\n{source}: JAX (f64 solve) and port agree on {n} frames to {jlog[n - 1][0]} s (node times within "
          f"{dt:.3g} s, positions within {dp:.3g} m); the JAX replay "
          f"{'stops after ' + str(jlog[-1][0]) + ' s: ' + jerr if jerr else 'runs to ' + str(jlog[-1][0]) + ' s'}, "
          f"the port {'stops after ' + str(tlog[-1][0]) + ' s: ' + str(terr) if terr else 'runs to the end'}")
    if part is not None:
        print(f"they part at the frame at {jlog[part][0]} s: accepted LM steps (pass 1, pass 2) JAX "
              f"{jlog[part][5]}, port {tlog[part][5]}")
    if jgates is not None:
        print(f"the JAX replay's five gates: {jgates}")
    assert terr is not None and "exceeds marg_cap" in str(terr), terr
    if source == "memory":
        assert part is None and len(tlog) == len(jlog) and str(terr) == jerr
    else:
        assert tlog[-1][0] == chip_smoke.LONG_REFUSED_AFTER and jlog[n - 1][0] >= 20.0


@pytest.mark.slow
def test_long_world_frontends_at_true_poses():
    from test_torch_tracking import _jax_table
    from ic_gvins_tpu.engine.config import parse_config as jparse
    from ic_gvins_tpu.vision import map as jmap
    from ic_gvins_tpu.vision import tracking as jtrk
    from ic_gvins_tpu_torch.engine.config import parse_config as tparse
    from ic_gvins_tpu_torch.vision import map as tmap
    from ic_gvins_tpu_torch.vision import ransac as transac
    from ic_gvins_tpu_torch.vision import tracking as ttrk

    imu, gnss, truth, frame_times, frame = chip_smoke.long_world(tcam, rotation_np)
    ks = range(560, 900)       # 56.05-89.95 s
    images = [np.clip(np.round(frame(k)), 0, 255) for k in ks]
    poses = []
    for k in ks:
        i = min(int(round(frame_times[k] * 200.0)) - 1, len(truth["p"]) - 1)
        poses.append((rotation_np.to_matrix(truth["q"][i]), truth["p"][i].copy()))
    jcfg, tcfg = jparse(chip_smoke.LONG_RAW), tparse(chip_smoke.LONG_RAW)
    jv, tv = jmap.VisualMap(jcfg.optimize_windows_size), tmap.VisualMap(tcfg.optimize_windows_size)
    jt = jtrk.Tracker(jcam.PinholeCamera.from_config(*chip_smoke.LONG_CAMERA), jv, jcfg)
    ref_rows = chip_smoke.run_tracker(jtrk, jmap, jt, jv, images, poses)
    mp = pytest.MonkeyPatch()
    mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator: torch.tensor(
        np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
    try:
        tt = ttrk.Tracker(tcam.PinholeCamera.from_config(*chip_smoke.LONG_CAMERA), tv, tcfg, device="cpu")
        port_rows = chip_smoke.run_tracker(ttrk, tmap, tt, tv, images, poses)
    finally:
        mp.undo()
    states = [int(r[0]) for r in port_rows]
    assert states == [int(r[0]) for r in ref_rows]
    lost = [round(float(frame_times[k]), 2) for k, st in zip(ks, states) if st == ttrk.TRACK_LOST]
    print(f"\nfrontends at the true poses, {len(states)} frames: equal states; TRACK_LOST at {lost}")
    assert 85.05 in lost
