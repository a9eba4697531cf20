"""The GVINS fault paths run to their end through both packages.

``chip_smoke.fault_world`` follows tests/test_gvins_long_e2e.py's recipe (its
renderer, 6000 ground points from default_rng(7), 160x120 at FX 125 with
radtan distortion, ``chip_smoke.LONG_RAW``) over a 40 s drive
(``gins_world(turn_duration=34.0)``) with the faults inside it: frames
brightened x1.35 in [14, 15) s (the histogram gate), GNSS fixes removed over
[18, 26) s, flat featureless frames in [30, 31.5) s (TRACK_LOST and
re-initialization), the fixes in [10, 12) s given std (15, 15, 15) m, a norm
above gnssthreshold 20, and the fix at 28 s std 0 (the ingest gates).
``chip_smoke.py`` phase 12 replays it on the card.

Tier-1:
- the world equals the JAX test's recipe: frames within 1e-9 of
  ``test_gvins_long_e2e._render`` through the JAX camera on a normal, a
  glitch, a blackout frame and the first frame after the blackout; the IMU
  stream and the GNSS table equal ``make_gins_dataset``'s under the same
  masks;
- the fault replay with ``FAULT_RAW`` (LONG_RAW with extrinsic and td
  estimation off) through the JAX package (its solve in f64, in
  tests/test_torch_harness.py's child process with sync dispatch) and the port
  (the JAX RANSAC table) at the same time, cut at the frames before 35 s: on
  every frame through the blackout's end + 3 s the model state, keyframe
  episodes, node count and the tracker's state are equal and positions
  within 1e-3 m; both show TRACK_PASSED in the glitch and TRACK_LOST in the
  blackout on the same frames, take the same GNSS fixes (the degraded two
  and the zero-std one dropped), and shed and chain as many nodes;
- the ingest gates in ``GinsModel`` on tests/test_torch_gins.py's drive
  (``make_gins_dataset()``'s 24 s, from ``chip_smoke.gins_world``, the JAX
  solve in f64): a zero-std fix,
  two fixes above gnssthreshold that leave a gap of 600 samples (a chained
  time node) and ``isusegnssoutage`` from 18 s; both packages take the same
  fixes and chain the same node, and the replays agree at that file's
  tolerances.

Slow (``-m slow -s``): the whole 40 s world with LONG_RAW (estimation on),
and with LONG_RAW and ``gnssoutagetime`` 36 s, through both packages to the
end: each package's gates (``chip_smoke.fault_gates``), where the two part
and what differs there (``chip_smoke.describe_parting``), and how many
TRACK_LOST frames fall outside the faults in each."""

import collections
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_gvins_long_e2e as ref
from gins_data import make_gins_dataset
from test_torch_gins import PRECISE, _precise_solve_jit, assert_twins, raw_cfg
from test_torch_harness import jax_child, jax_result, kill_if_running
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_torch_long_e2e import _logged_run
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu_torch.core import rotation_np
from ic_gvins_tpu_torch.vision import camera as tcam
from ic_gvins_tpu_torch.vision.tracking import TRACK_LOST, TRACK_PASSED

UNTIL = 35.0                      # s: the tier-1 twin replays the frames before this stamp
HELD_UNTIL = chip_smoke.FAULT_BLACKOUT[1] + 3.0   # s: the twins agree on every frame through this stamp
POS_TOL = 1e-3                    # m: positions, JAX against the port (tests/test_torch_long_e2e.py's)
FAULTS_CHILD_LIMIT = 420          # s: ~3x the tier-1 JAX child's wall alone on an 8-core CPU (139.5 s)
# frames: a normal one (10.05 s), a glitch frame (14.05 s), a blackout frame
# (30.05 s) and the first frame after the blackout (31.55 s)
FRAMES = (100, 140, 300, 315)


def _ref_frame(camera, pts_w, truth, t):
    """tests/test_gvins_long_e2e.py's image_provider at stamp ``t`` with the
    fault world's windows."""
    if chip_smoke.FAULT_BLACKOUT[0] <= t < chip_smoke.FAULT_BLACKOUT[1]:
        return np.full((ref.H, ref.W), 90.0)
    i = min(int(round(t * 200.0)) - 1, len(truth["p"]) - 1)
    img = ref._render(camera, pts_w, np.asarray(jquat.to_matrix(jnp.asarray(truth["q"][i]))), truth["p"][i])
    if chip_smoke.FAULT_GLITCH[0] <= t < chip_smoke.FAULT_GLITCH[1]:
        img = np.clip(img * 1.35, 0, 255)
    return img


@pytest.mark.usefixtures("jax_fault_twin")
def test_fault_world_matches_the_test_recipe():
    imu, gnss, truth, frame_times, frame = chip_smoke.fault_world(tcam, rotation_np)
    rimu, rgnss, rtruth = make_gins_dataset(turn_duration=34.0)
    t = np.asarray(rgnss["time"])
    keep = ~((t >= chip_smoke.FAULT_OUTAGE[0]) & (t < chip_smoke.FAULT_OUTAGE[1]))
    rgnss = {k: np.array(v, np.float64)[keep] for k, v in rgnss.items()}
    t = rgnss["time"]
    rgnss["std"][(t >= chip_smoke.FAULT_DEGRADED[0]) & (t < chip_smoke.FAULT_DEGRADED[1])] = 15.0
    rgnss["std"][np.argmin(np.abs(t - chip_smoke.FAULT_ZERO_STD))] = 0.0
    assert chip_smoke.FAULT_RAW == dict(chip_smoke.LONG_RAW, optimize_estimate_extrinsic=False,
                                        optimize_estimate_td=False)

    np.testing.assert_array_equal(gnss["time"], rgnss["time"])
    assert len(gnss["time"]) == 31 and not np.any((t >= 18.0) & (t < 26.0))
    np.testing.assert_array_equal(gnss["std"], rgnss["std"])
    assert sorted(chip_smoke.ingest_dropped(gnss, 20)) == [10.0, 11.0, 28.0]
    np.testing.assert_allclose(gnss["blh"][:, :2], rgnss["blh"][:, :2], atol=1e-9, rtol=0)
    np.testing.assert_allclose(gnss["blh"][:, 2], rgnss["blh"][:, 2], atol=1e-8, rtol=0)   # via ECEF
    for k in ("dtheta", "dvel", "dt", "time"):
        np.testing.assert_allclose(imu[k], rimu[k], atol=1e-9, rtol=0, err_msg=k)
    np.testing.assert_allclose(truth["p"], rtruth["p"], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(frame_times, np.arange(0.05, rimu["time"][-1] - 0.2, 0.1))

    rng = np.random.default_rng(7)
    pts_w = np.stack([rng.uniform(-80, 140, 6000), rng.uniform(-80, 140, 6000), rng.uniform(9, 13, 6000)], axis=1)
    camera = jcam.PinholeCamera.from_config([ref.FX, ref.FX, 80.0, 60.0], [-0.05, 0.01, 0.0, 0.0], [ref.W, ref.H])
    kinds = []
    for k in FRAMES:
        t = frame_times[k]
        kinds.append("glitch" if chip_smoke.FAULT_GLITCH[0] <= t < chip_smoke.FAULT_GLITCH[1] else
                     "blackout" if chip_smoke.FAULT_BLACKOUT[0] <= t < chip_smoke.FAULT_BLACKOUT[1] else "normal")
        np.testing.assert_allclose(frame(k), _ref_frame(camera, pts_w, rtruth, t), atol=1e-9, rtol=0,
                                   err_msg=f"frame {k}")
    assert kinds == ["normal", "glitch", "blackout", "normal"]
    assert frame_times[FRAMES[3] - 1] < chip_smoke.FAULT_BLACKOUT[1] <= frame_times[FRAMES[3]]


def _num(arg):
    return None if arg == "none" else float(arg)


def _fault_run(model, imu, gnss, frame_times, images, traced):
    """One package's replay of the fault world with a ``FaultLog``: with
    ``traced`` a ``PartingTrace`` (returns its rows), else
    tests/test_torch_long_e2e.py's ``_logged_run`` with the tracker's state
    on the frame added to each tuple (None where the frame was not
    tracked). A refusal of a slide past marg_cap stops it. Returns (the
    rows, the error message or None, the FaultLog record)."""
    faults = chip_smoke.FaultLog(model)
    if not traced:
        log, err = _logged_run(model, imu, gnss, frame_times, images)
        states = dict(faults.tracked)
        return [(*row, states.get(row[0])) for row in log], None if err is None else str(err), faults.record()
    trace = chip_smoke.PartingTrace(model)
    try:
        model.run(imu, gnss, frame_times, lambda k: images[k])
        err = None
    except ValueError as e:
        if "exceeds marg_cap" not in str(e):
            raise
        err = str(e)
    return trace.rows, err, faults.record()


def _summary(model, truth, gnss, rec, frame_times, outage_after):
    traj = np.asarray(model.trajectory) if model.trajectory else np.zeros((0, 8))
    gates = chip_smoke.fault_gates(model, traj, truth, rec, gnss, float(frame_times[-1]), outage_after)
    return dict(state=model.state, nodes=len(traj), gates=gates)


def jax_fault_run(config, outage_after, until, traced, out_path):
    """The JAX replay (its solve in f64) of the fault world with
    ``chip_smoke.<config>``, pickled to out_path as (the rows of
    ``_fault_run``, the error message or None, its FaultLog record, a
    summary with the gates)."""
    from ic_gvins_tpu.engine import estimator as jest
    from ic_gvins_tpu.engine.config import parse_config as jparse
    from ic_gvins_tpu.models.gvins import GvinsModel as JGvins

    imu, gnss, truth, frame_times, images, cfg, *_ = chip_smoke.fault_inputs(
        getattr(chip_smoke, config), _num(outage_after), _num(until), parse_config=jparse)
    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        model = JGvins(cfg)
        rows, err, rec = _fault_run(model, imu, gnss, frame_times, images, traced == "traced")
    finally:
        mp.undo()
    with open(out_path, "wb") as f:
        pickle.dump((rows, err, rec, _summary(model, truth, gnss, rec, frame_times, _num(outage_after))), f)


def _start_jax(out_dir, config, outage_after=None, until=None, traced=False):
    """``jax_fault_run`` in tests/test_torch_harness.py's child process (sync
    dispatch): (the child, the path it pickles to)."""
    out_path = os.path.join(out_dir, f"jax_{config}_{outage_after}_{until}.pkl")
    child = jax_child("test_torch_faults:jax_fault_run", config, str(outage_after).lower(), str(until).lower(),
                      "traced" if traced else "logged", out_path)
    return child, out_path


def _port_then_jax(jax, config, outage_after=None, until=None, traced=False, threads=None, limit=3000):
    """The port's replay here (the JAX RANSAC table; with ``threads`` torch
    threads) while the JAX one started by ``_start_jax`` runs, then the
    JAX one's result, waited for at most ``limit`` seconds: ((rows, error,
    record, summary) of the JAX replay, the same of the port's, the world's
    GNSS fixes)."""
    from test_torch_tracking import _jax_table
    from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins
    from ic_gvins_tpu_torch.vision import ransac as transac

    mp = pytest.MonkeyPatch()
    saved = torch.get_num_threads()
    try:
        if threads:
            torch.set_num_threads(threads)
        imu, gnss, truth, frame_times, images, cfg, *_ = chip_smoke.fault_inputs(
            getattr(chip_smoke, config), outage_after, until)
        mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator: torch.tensor(
            np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
        model = TGvins(cfg, device="cpu")
        rows, err, rec = _fault_run(model, imu, gnss, frame_times, images, traced)
        port = (rows, err, rec, _summary(model, truth, gnss, rec, frame_times, outage_after))
    finally:
        mp.undo()
        torch.set_num_threads(saved)
        jax_out = jax_result(*jax, timeout=limit)
    return jax_out, port, gnss


@pytest.fixture(scope="module")
def jax_fault_twin(jax_compile_cache, tmp_path_factory):
    """The JAX replay of the tier-1 twin (FAULT_RAW, the frames before
    UNTIL) in a child process. The file's first test starts it, so that it
    runs beside the cheaper tests."""
    child, out_path = _start_jax(str(tmp_path_factory.mktemp("jax_faults")), "FAULT_RAW", until=UNTIL)
    yield child, out_path
    kill_if_running(child)


@pytest.mark.usefixtures("jax_fault_twin")
def test_ingest_gates_in_gins_model():
    from ic_gvins_tpu.engine import estimator as jest
    from ic_gvins_tpu.engine.config import parse_config as jparse
    from ic_gvins_tpu.models.gins import GinsModel as JGins
    from ic_gvins_tpu_torch.engine.config import parse_config as tparse
    from ic_gvins_tpu_torch.models.gins import GinsModel as TGins

    # make_gins_dataset()'s 24 s drive, from its jax-free copy (equal within
    # 1e-9: tests/test_torch_gins.py::test_chip_smoke_world_matches_gins_data)
    imu, gnss, truth = chip_smoke.gins_world()
    gnss = {k: np.array(v, np.float64) for k, v in gnss.items()}
    t = gnss["time"]
    gnss["std"][t == 9.0] = 0.0                             # the zero-std gate
    gnss["std"][(t == 14.0) | (t == 15.0)] = 15.0           # norm 26 m > gnssthreshold 20: a 3 s gap
    raw = raw_cfg(truth, False, isusegnssoutage=True, gnssoutagetime=18.0)
    jm, tm = JGins(jparse(raw)), TGins(tparse(raw), device="cpu")
    jlog, tlog = chip_smoke.FaultLog(jm), chip_smoke.FaultLog(tm)
    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        jt = jm.run(imu, gnss)
    finally:
        mp.undo()
    tt = tm.run(imu, gnss)
    kept = [float(x) for x in t if x not in (9.0, 14.0, 15.0) and x < 18.0]
    assert jlog.record()["kept"] == tlog.record()["kept"] == kept
    assert jlog.chained == tlog.chained == [15.55]          # 13 s + (512 - 2) / 200 s
    assert tt[-1, 0] == 17.0
    assert_twins(jm, jt, tm, tt, PRECISE)


def test_fault_replay_matches_jax_through_the_faults(jax_fault_twin):
    (jlog, jerr, jrec, _), (tlog, terr, trec, _), gnss = _port_then_jax(jax_fault_twin, "FAULT_RAW", until=UNTIL,
                                                                        threads=1, limit=FAULTS_CHILD_LIMIT)
    assert jerr is None and terr is None, (jerr, terr)
    assert len(jlog) == len(tlog) and jlog[-1][0] < UNTIL
    held = [i for i, row in enumerate(jlog) if row[0] <= HELD_UNTIL]
    assert jlog[held[-1]][0] >= HELD_UNTIL - 0.1
    for i in held:
        a, b = jlog[i], tlog[i]
        assert (a[0], a[1], a[2], len(a[3]), a[6]) == (b[0], b[1], b[2], len(b[3]), b[6]), (i, a[:3], b[:3])
        np.testing.assert_allclose(b[4], a[4], atol=POS_TOL, rtol=0, err_msg=f"frame at {a[0]} s")
    dp = max(float(np.abs(jlog[i][4] - tlog[i][4]).max()) for i in held)
    print(f"\nJAX (f64 solve) and port agree on {len(held)} frames to {jlog[held[-1]][0]} s, positions within "
          f"{dp:.3g} m; model states by frame {dict(collections.Counter(row[1] for row in tlog))}")

    # the fault paths ran, on the same frames in both packages
    for state, window in ((TRACK_PASSED, chip_smoke.FAULT_GLITCH), (TRACK_LOST, chip_smoke.FAULT_BLACKOUT)):
        j, t = (chip_smoke.fault_states(r["tracked"], state, window) for r in (jrec, trec))
        assert j == t and len(t) >= 1, (state, j, t)
    dropped = chip_smoke.ingest_dropped(gnss, 20)
    expected = sorted({round(float(t), 3) for t in gnss["time"]} - dropped)
    assert sorted(dropped) == [10.0, 11.0, 28.0]
    assert jrec["kept"] == trec["kept"] == expected
    assert (jrec["sheds"], jrec["chained"]) == (trec["sheds"], trec["chained"])
    print(f"TRACK_PASSED at {chip_smoke.fault_states(trec['tracked'], TRACK_PASSED)}, TRACK_LOST at "
          f"{chip_smoke.fault_states(trec['tracked'], TRACK_LOST)} in both; node sheds {trec['sheds']}, chained "
          f"nodes {trec['chained']} in both")


@pytest.mark.slow
@pytest.mark.parametrize("outage_after", [None, chip_smoke.FAULT_OUTAGE_AFTER])
def test_fault_world_to_the_end(tmp_path, outage_after):
    jax = _start_jax(str(tmp_path), "LONG_RAW", outage_after, traced=True)
    (jrows, jerr, jrec, jsum), (trows, terr, trec, tsum), gnss = _port_then_jax(jax, "LONG_RAW", outage_after,
                                                                                traced=True, threads=4)
    print(f"\nLONG_RAW, gnssoutagetime {outage_after}")
    for name, err, rec, summ in (("JAX", jerr, jrec, jsum), ("port", terr, trec, tsum)):
        stray = chip_smoke.fault_states(rec["tracked"], TRACK_LOST,
                                        outside=(chip_smoke.FAULT_GLITCH, chip_smoke.FAULT_BLACKOUT))
        print(f"{name}: {err or 'ran to the end'}, state {summ['state']}, {summ['nodes']} nodes; TRACK_LOST outside "
              f"the faults {len(stray)} times {stray}; node sheds {rec['sheds']}, chained {rec['chained']}")
        for test, gate, value, limit, ok, _ in summ["gates"]:
            print(f"  {name} gate {test}: {gate} {value} (limit {limit}) {'ok' if ok else 'FAILED'}")
    print(chip_smoke.describe_parting("JAX", "port", jrows, trows, chip_smoke.LONG_RAW["track_min_parallax"]))
    for rec in (jrec, trec):
        assert chip_smoke.fault_states(rec["tracked"], TRACK_PASSED, chip_smoke.FAULT_GLITCH)
        assert chip_smoke.fault_states(rec["tracked"], TRACK_LOST, chip_smoke.FAULT_BLACKOUT)
        assert not set(rec["kept"]) & chip_smoke.ingest_dropped(gnss, 20)
        if outage_after is not None:
            assert max(rec["kept"]) < outage_after
