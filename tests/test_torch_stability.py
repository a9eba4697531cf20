"""The hard-cadence stability world of tests/test_gvins_stability_e2e.py
through the port: 160x120 frames of 9000 ground points, a keyframe on most
frames (``track_min_parallax=8``), extrinsic and td estimation on, and GNSS
removed for 20 s from 0.45 of the drive.

Tier-1 (~30 s): ``chip_smoke.stability_world`` (jax-free, what chip_smoke.py
phase 11 replays on the card) against that test's own world, read from its
fixture body with its GvinsModel replaced by a recorder, at a 60 s drive:
the IMU stream and the GNSS fixes left after the outage cut within 1e-9
(heights 1e-8 m, as tests/test_torch_gins.py holds the drive), the frame
stamps equal, frames before, inside and after the outage within 1e-9 gray
as tests/test_torch_gvins.py holds its renderer (observed 4.1e-10 at 59.7
s: the two drives' truths agree within 1e-9 m, and the JAX renderer
projects with XLA-compiled jnp ops, the port with numpy),
the configuration dict and the outage equal; and the gate arithmetic of
``chip_smoke.stability_gates``, the seven tests' thresholds scaled by
duration / 300 as that test scales them, on toy counts.

Slow (``-m slow -s``): the twin at a 60 s drive (the JAX test's fixture in a
child process with ICGVINS_STAB_DURATION=60 in its environment, its solve in
f64, async dispatch off; the port here on the same world with the JAX
RANSAC table), held frame by frame at tests/test_torch_td.py's tolerances
up to the first frame where the two part; that frame and what differs there
are printed. The port's own run is held to the seven gates.
"""

import pickle
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_gvins_stability_e2e as st
from test_torch_gins import _precise_solve_jit
from test_torch_harness import jax_child, jax_result
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_torch_scripts import _close_world
from test_torch_td import Recorder, patched_fixture, replay_summary
from test_torch_tracking import _jax_table
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins
from ic_gvins_tpu_torch.vision import ransac as transac

DURATION = 60.0
TWIN = dict(pos=5e-5, att=2e-5, td=1e-6)


class _Tmp:
    def mktemp(self, name):
        return tempfile.mkdtemp(prefix=name)


def _stab_fixture(mp, duration, model_factory):
    """tests/test_gvins_stability_e2e.py's fixture body at a drive of
    ``duration`` s (its module's DURATION and OUTAGE, as its environment
    variable would set them; ``patched_fixture``)."""
    return patched_fixture(mp, st, lambda: st.stab_run.__wrapped__(_Tmp()),
                           {"DURATION": duration, "OUTAGE": (0.45 * duration, 0.45 * duration + 20.0)},
                           model_factory)


def stability_test_world(duration):
    """The JAX test's world and configuration at ``duration``: (raw config
    dict, outage, imu, gnss, truth, frame_times, image provider)."""
    mp = pytest.MonkeyPatch()
    try:
        raws, (_, _, truth, _, _) = _stab_fixture(mp, duration, Recorder)
        outage = st.OUTAGE
    finally:
        mp.undo()
    imu, gnss, frame_times, provider = Recorder.last.inputs
    return raws[-1], outage, imu, gnss, truth, frame_times, provider


def test_chip_smoke_stability_world_matches_jax_test():
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.vision import camera as tcam

    raw, outage, imu, gnss, truth, frame_times, provider = stability_test_world(DURATION)
    p_imu, p_gnss, p_truth, p_times, frame = chip_smoke.stability_world(tcam, rotation_np, DURATION)
    assert chip_smoke.stab_outage(DURATION) == outage == (27.0, 47.0)
    np.testing.assert_array_equal(p_gnss["time"], gnss["time"])      # the outage cut
    assert not ((p_gnss["time"] >= outage[0]) & (p_gnss["time"] < outage[1])).any()
    assert len(p_gnss["time"]) == len(np.arange(1.0, p_imu["time"][-1], 1.0)) - 20   # 20 fixes removed
    _close_world((p_imu, p_gnss), (imu, gnss))
    np.testing.assert_array_equal(p_times, frame_times)
    inside = int(np.searchsorted(frame_times, outage[0] + 5.0))
    for k in (0, inside, len(frame_times) - 1):
        np.testing.assert_allclose(frame(k), provider(k), atol=1e-9, rtol=0, err_msg=f"frame {k}")
    assert chip_smoke.gvins_raw(p_truth, chip_smoke.STAB_RAW, chip_smoke.STAB_CAMERA) == raw


def _toy(duration, episodes, margs, frames, t_err=0.1, bridge_err=1.0, td=0.0, failures=()):
    """A trajectory one node a 0.2 s with error t_err outside the outage and
    bridge_err inside it, against a zero truth; a model with the given td."""
    times = np.arange(0.2, duration - 0.2, 0.2)
    lo, hi = chip_smoke.stab_outage(duration)
    err = np.where((times >= lo - 2.0) & (times <= hi + 3.0), bridge_err, t_err)
    traj = np.zeros((len(times), 8))
    traj[:, 0], traj[:, 1], traj[:, 7] = times, err, 1.0
    n = int(round(duration * 200))
    truth = dict(p=np.zeros((n, 3)), gnss_local=np.zeros((1, 3)))
    model = types.SimpleNamespace(state="TRACKING_NORMAL", td_b_c=td, pose_b_c_t=np.zeros(3),
                                  pose_b_c_R=np.eye(3))
    gates = chip_smoke.stability_gates(model, traj, truth, dict(frames=frames, episodes=episodes, margs=margs),
                                       list(failures), duration)
    return {name: met for _, name, _, _, met, _ in gates}


@pytest.mark.parametrize("duration", [60.0, 90.0, 300.0])
def test_stability_gates_scale_with_duration(duration):
    """The seven tests' thresholds: episodes >= 400 D / 300 and
    marginalizations >= 100 D / 300, just met and just missed; the error,
    bridge, td, consistency and cadence gates on either side of their
    limits."""
    s = duration / 300.0
    frames = int(duration * 10)
    eps, margs = int(np.ceil(400 * s)), int(np.ceil(100 * s))
    ok = _toy(duration, eps, margs, frames)
    assert all(ok.values()), ok
    assert not _toy(duration, eps - 1, margs, frames)["keyframe episodes"]
    assert not _toy(duration, eps, margs - 1, frames)["marginalizations"]
    assert not _toy(duration, eps, margs, frames, t_err=0.31)["mean error outside the outage m"]
    assert not _toy(duration, eps, margs, frames, bridge_err=3.01)["bridge max error m"]
    assert _toy(duration, eps, margs, frames, bridge_err=2.99)["bridge max error m"]
    assert not _toy(duration, eps, margs, frames, td=0.0811)["|td| s"]
    assert not _toy(duration, eps, margs, frames, failures=[(3, ["x"])])["episodes with violations"]
    assert not _toy(duration, frames // 2 + 1, margs, frames)["kf_ratio"]
    assert not _toy(duration, eps, frames // 2 + 1, frames)["marg_ratio"]


# ---------------------------------------------------------------------------
# slow: the twin at 60 s
# ---------------------------------------------------------------------------

def jax_stability_replay(out_path, solve="f64"):
    """The JAX test's fixture body at its ICGVINS_STAB_DURATION with an
    EstimationLog, its solve in f64 or, with ``solve`` "f32", the package's
    own (production) solve; a refusal of a slide of more than marg_cap
    nodes ends the replay (R1) and is recorded. Pickles its summary to
    out_path."""
    logs, models = [], []
    orig = st.GvinsModel

    def make(cfg, outdir=None):
        models.append(orig(cfg, outdir=outdir))
        logs.append(chip_smoke.EstimationLog(models[-1]))
        return models[-1]

    mp = pytest.MonkeyPatch()
    refused = None
    try:
        if solve == "f64":
            mp.setattr(jest, "_solve_jit", _precise_solve_jit)
        _, (model, traj, truth, _, _) = patched_fixture(mp, st, lambda: st.stab_run.__wrapped__(_Tmp()), {}, make)
    except ValueError as e:
        if "exceeds marg_cap" not in str(e):
            raise
        refused, model, traj = str(e), models[0], np.asarray(models[0].trajectory)
        truth = stability_test_world(st.DURATION)[4]
    finally:
        mp.undo()
    with open(out_path, "wb") as f:
        pickle.dump(dict(replay_summary(model, traj, logs[0], truth), refused=refused), f)


def _first_parting(j, t):
    """(frame, what differs) for the first frame after which the replays'
    states or node counts differ or an episode's td differs by TWIN["td"]
    or more; None if neither happens."""
    partings = [(k, f"state and nodes {b} in the port, {a} in the JAX replay")
                for k, (a, b) in enumerate(zip(j["states"], t["states"])) if a != b][:1]
    partings += [(t["episodes"][e][0] - 1, f"td after episode {e + 1}: {b!r} s in the port, {a!r} s in the JAX replay")
                 for e, (a, b) in enumerate(zip(j["tds"], t["tds"])) if abs(a - b) >= TWIN["td"]][:1]
    return min(partings) if partings else None


@pytest.fixture(scope="module")
def stab_twin(tmp_path_factory):
    """Both replays at DURATION: the JAX one in a child process started
    first, the port's here meanwhile. Returns (JAX summary, port summary,
    the port's model, frame stamps)."""
    tmp = tmp_path_factory.mktemp("stab_twin")
    out_path = str(tmp / "jax_stab.pkl")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("ICGVINS_STAB_DURATION", str(DURATION))
        child = jax_child("test_torch_stability:jax_stability_replay", out_path)
    finally:
        mp.undo()
    try:
        raw, outage, imu, gnss, truth, frame_times, provider = stability_test_world(DURATION)
        images = [provider(k) for k in range(len(frame_times))]
        mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator:
                   torch.tensor(np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
        model = TGvins(tparse(raw), outdir=str(tmp / "port"), device="cpu")
        log = chip_smoke.EstimationLog(model)
        traj = model.run(imu, gnss, frame_times, lambda k: images[k])
        t = replay_summary(model, traj, log, truth)
    finally:
        mp.undo()
        j = jax_result(child, out_path, timeout=3600)
    return j, t, model, frame_times


def _gates(s, duration=DURATION):
    model = types.SimpleNamespace(state=s["state"], td_b_c=s["td_b_c"], pose_b_c_t=s["t_b_c"], pose_b_c_R=s["R_b_c"])
    return chip_smoke.stability_gates(model, s["traj"], s["truth"], s["counts"], s["failures"], duration)


@pytest.mark.slow
def test_stability_twin_at_60s(stab_twin):
    """Frame by frame up to where the replays part: the states after every
    frame, the td after every episode (1e-6 s), node positions (5e-5 m) and
    attitudes (2e-5) before that frame; the frame, the episodes with
    time-consistency violations and both replays' gates are printed."""
    j, t, _, frame_times = stab_twin
    parting = _first_parting(j, t)
    n = min(len(j["traj"]), len(t["traj"]))
    # nodes stamped before the parting frame (frames are counted from the
    # first one the model processes, after the GNSS/INS initialization)
    first = len(frame_times) - j["counts"]["frames"]
    common = n if parting is None else int(np.sum(t["traj"][:n, 0] < frame_times[first + parting[0]]))
    dp = float(np.abs(t["traj"][:common, 1:4] - j["traj"][:common, 1:4]).max()) if common else 0.0
    print(f"\nstability twin at {DURATION:g} s: JAX {j['counts']} {j['state']} td {j['td_b_c']:.6f}, adoptions "
          f"{[x[0] for x in j['decisions']].count(True)} td / {[x[1] for x in j['decisions']].count(True)} "
          f"extrinsic, violations after episodes {[e for e, *_ in j['failures']]}; port {t['counts']} {t['state']} "
          f"td {t['td_b_c']:.6f}, violations after episodes {[e for e, *_ in t['failures']]}; first parting "
          f"{parting}; positions over the {common} nodes before it within {dp:.3g} m")
    for name, s in (("port", t), ("jax", j)):
        for test, gname, value, limit, met, _ in _gates(s):
            print(f"  {name} {test}: {gname} {value} (limit {limit}) {'ok' if met else 'FAILED'}")
    if parting is None:
        assert t["states"] == j["states"] and t["counts"] == j["counts"] and t["decisions"] == j["decisions"]
        assert [e for e, *_ in t["failures"]] == [e for e, *_ in j["failures"]]
        np.testing.assert_allclose(t["traj"][:, 0], j["traj"][:, 0], atol=TWIN["td"], rtol=0)
    assert dp < TWIN["pos"]
    if common:
        np.testing.assert_allclose(t["traj"][:common, 4:8], j["traj"][:common, 4:8], atol=TWIN["att"], rtol=0)


@pytest.mark.slow
def test_stability_port_gates_at_60s(stab_twin):
    """The port's own run held to the seven tests' gates at their 60 s
    thresholds."""
    _, t, _, _ = stab_twin
    failed = [gname for _, gname, _, _, met, _ in _gates(t) if not met]
    assert not failed, failed


# ---------------------------------------------------------------------------
# slow: the spread of outcomes at 90 s (ROADMAP R6)
# ---------------------------------------------------------------------------

SPREAD_DURATION = 90.0
# the JAX package's configurations: (solve, CPU client dispatch, ICGVINS_LK, its level tracker on the CPU, XLA_FLAGS)
JAX_SPREAD = {"f32 production, sync": ("f32", "sync", "auto", None), "f64, sync": ("f64", "sync", "auto", None),
              "f64, async": ("f64", "async", "auto", None), "f64, sync, gather LK": ("f64", "sync", "gather", None),
              "f64, sync, one XLA thread": ("f64", "sync", "auto",
                                            "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")}
# (drive s, configuration): 300 s is the JAX test's own horizon; the f64 sync
# replay also at the drives between, the test's own ICGVINS_STAB_DURATION knob
JAX_SPREAD_CASES = [(90.0, "f32 production, sync"), (90.0, "f64, sync"), (90.0, "f64, async"),
                    (90.0, "f64, sync, gather LK"), (90.0, "f64, sync, one XLA thread"), (60.0, "f64, sync"),
                    (120.0, "f64, sync"), (150.0, "f64, sync"), (180.0, "f64, sync"), (300.0, "f64, sync"),
                    (300.0, "f64, sync, gather LK")]
PORT_SPREAD_THREADS = (1, 2, 3, 4)


def _print_gates(name, s, duration):
    failed = [gname for _, gname, _, _, met, _ in _gates(s, duration) if not met]
    last = float(s["traj"][-1, 0]) if len(s["traj"]) else float("nan")
    print(f"  {name}: {'refused after the node at %.2f s' % last if s.get('refused') else 'reached the end'}; "
          f"{s['counts']}, |t_b_c| {np.linalg.norm(s['t_b_c']):.4f} m, td {s['td_b_c']:.6f} s; gates not met "
          f"{failed}")


@pytest.mark.slow
@pytest.mark.parametrize("duration,name", JAX_SPREAD_CASES)
def test_jax_stability_spread(tmp_path, duration, name):
    """The JAX package's own replay of the stability world under one of its
    own configurations (JAX_SPREAD_CASES) in a child process: at 90 s its
    production f32 solve, and the f64 solve with the CPU client's dispatch
    sync and async, with its other CPU level tracker (ICGVINS_LK=gather)
    and with XLA's CPU client on one thread; the f64 sync solve also at
    60-180 s and at the test's own 300 s. Prints the outcome, counts and
    the gates it does not meet (ROADMAP R5, R6); it must reach the end or
    stop at the marg_cap refusal."""
    solve, dispatch, lk, xla_flags = JAX_SPREAD[name]
    out = str(tmp_path / "jax.pkl")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("ICGVINS_STAB_DURATION", str(duration))
        mp.setenv("ICGVINS_LK", lk)
        if xla_flags:
            mp.setenv("XLA_FLAGS", xla_flags)
        child = jax_child("test_torch_stability:jax_stability_replay", out, solve, dispatch=dispatch)
    finally:
        mp.undo()
    print(f"\nthe JAX replay of the stability world at {duration:g} s:")
    _print_gates(name, jax_result(child, out, timeout=10800), duration)


@pytest.mark.slow
def test_port_stability_spread_at_90s(tmp_path):
    """The port's replay of the stability world at 90 s on the CPU at 1-4
    torch threads (``chip_smoke.py --stab-trace``, in parallel child
    processes); prints each one's outcome, counts, node-capacity sheds and
    the gates it does not meet (ROADMAP R6)."""
    import subprocess
    import sys

    kids = {n: (subprocess.Popen([sys.executable, chip_smoke.__file__, "--stab-trace", str(tmp_path / f"{n}.pkl"),
                                  str(SPREAD_DURATION), str(n)]), tmp_path / f"{n}.pkl") for n in PORT_SPREAD_THREADS}
    print(f"\nthe port's replay of the stability world at {SPREAD_DURATION:g} s on the CPU:")
    for n, (child, out) in kids.items():
        assert child.wait(timeout=5400) == 0
        with open(out, "rb") as f:
            summary, _ = pickle.load(f)
        print(f"  {n} threads: {summary}")
