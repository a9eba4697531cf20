"""The port's GNSS/INS replay end to end on the CPU, against the JAX package's
GinsModel and against the ground truth, on tests/gins_data.py's world cut to
14 s (make_gins_dataset(turn_duration=8.0)): earth rate off and on, a GNSS gap
longer than a preintegration segment, and the output files.

These twins wait on a JAX child, so they live in a file of few tests: the
test queue takes files by their count of tests, most first, and this one
then starts after tests/test_gvins_long_e2e.py
(test_torch_harness.py::test_child_modules_queue_after_the_long_replay).

Tolerances against the JAX run. The JAX package's production solve factors
in f32 with one f64 refinement; the port factors in f64, as the JAX solver's
``precise=True`` mode does. Against that mode (patched into the JAX
estimator) the replays agree to rounding: node positions and velocities
within 1e-8 m (m/s), attitudes 1e-9, biases 1e-10 (observed ~1e-11 m;
``PRECISE`` of tests/test_torch_gins.py). Against production, the f32
factor's error settles in the weakly observable heading and gyro-z bias (as
tests/test_batch_oracle.py finds): positions within 1 mm, velocities 1 mm/s,
quaternions 5e-4, gyro x/y bias 1e-5 rad/s, gyro z 1e-4 rad/s (observed
1.3e-4 m, 1.2e-4, 1e-6 and 2.4e-5 rad/s). The JAX replays of the three twins
(earth rate off, on, and the GNSS gap) run in one child process
(tests/test_torch_harness.py, sync dispatch) started with the module, while
the port's replays run here."""

import os
import pickle
import types

import numpy as np
import pytest
import torch

from gins_data import make_gins_dataset
from test_torch_gins import PRECISE, _precise_solve_jit, assert_twins, raw_cfg
from test_torch_harness import jax_child, jax_result, kill_if_running, module_reads
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.models.gins import GinsModel as JGins
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gins import GinsModel as TGins

torch.set_num_threads(1)
RATE = 200.0
PRODUCTION = dict(pos=1e-3, att=5e-4, vel=1e-3, bg_xy=1e-5, bg_z=1e-4)
GINS_CHILD_LIMIT = 310   # s: ~3x the JAX child's wall alone on an 8-core CPU (103.2 s, three replays)


def jax_run(imu, gnss, truth, with_earth, outdir=None, precise=False):
    """The JAX GinsModel (its solve in f64 mode if ``precise``) on the CPU:
    (model, trajectory)."""
    jm = JGins(jparse(raw_cfg(truth, with_earth)), outdir=outdir)
    mp = pytest.MonkeyPatch()
    if precise:
        mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        jt = jm.run(imu, gnss)
    finally:
        mp.undo()
    return jm, jt


def port_run(imu, gnss, truth, with_earth, outdir=None):
    tm = TGins(tparse(raw_cfg(truth, with_earth)), outdir=outdir, device="cpu")
    return tm, tm.run(imu, gnss)


def gap_world():
    """The 14 s drive with the fixes in (5.5 s, 9.5 s) dropped."""
    imu, gnss, truth = make_gins_dataset(turn_duration=8.0)
    keep = ~((gnss["time"] > 5.5) & (gnss["time"] < 9.5))
    return imu, {k: np.array(v)[keep] for k, v in gnss.items()}, truth


def jax_gins_replays(outdir, out_path):
    """The JAX replays of this file's three twins, one after the other in
    this process: earth rate off (the solve in f64, output files into
    outdir), earth rate on (the production solve) and the GNSS gap (f64).
    Pickles to out_path, for each, its trajectory and what ``assert_twins``
    reads of the model."""
    worlds = {"earth_off": (make_gins_dataset(turn_duration=8.0), False, outdir, True),
              "earth_rate": (make_gins_dataset(turn_duration=8.0, with_earth=True), True, None, False),
              "gap": (gap_world(), False, None, True)}
    out = {}
    for name, ((imu, gnss, truth), with_earth, d, precise) in worlds.items():
        jm, jt = jax_run(imu, gnss, truth, with_earth, d, precise)
        out[name] = dict(traj=np.asarray(jt), state=jm.state, n_nodes=jm.est.n_nodes, times=np.array(jm.est.times),
                         mixes=np.array(jm.est.mixes))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def jax_gins_child(request, jax_compile_cache, tmp_path_factory):
    """``jax_gins_replays`` in a child process (tests/test_torch_harness.py,
    sync dispatch) started with the module, so that the JAX replays run
    beside the port's: (child, its output directory, pickle path), or None
    where no test of the module reads them. Killed at the module's end if
    still running."""
    if not module_reads(request, "jax_gins"):
        yield None
        return
    outdir = str(tmp_path_factory.mktemp("jax_out"))
    out_path = os.path.join(outdir, "jax_gins.pkl")
    child = jax_child("test_torch_gins_twin:jax_gins_replays", outdir, out_path)
    yield child, outdir, out_path
    kill_if_running(child)


@pytest.fixture(scope="module")
def jax_gins(jax_gins_child):
    """{twin: (the JAX model as ``assert_twins`` reads it, trajectory)} of
    ``jax_gins_replays``."""
    child, _, out_path = jax_gins_child
    out = jax_result(child, out_path, timeout=GINS_CHILD_LIMIT)
    return {name: (types.SimpleNamespace(state=r["state"], est=types.SimpleNamespace(
        n_nodes=r["n_nodes"], times=r["times"], mixes=r["mixes"])), r["traj"]) for name, r in out.items()}


def errors(traj, truth):
    idx = np.round(traj[:, 0] * RATE).astype(int) - 1
    return np.linalg.norm(traj[:, 1:4] + truth["gnss_local"][0] - truth["p"][idx], axis=1)


@pytest.fixture(scope="module")
def earth_off(jax_gins_child, jax_gins, tmp_path_factory):
    imu, gnss, truth = make_gins_dataset(turn_duration=8.0)
    dirs = (jax_gins_child[1], str(tmp_path_factory.mktemp("port_out")))
    return (*jax_gins["earth_off"], *port_run(imu, gnss, truth, False, dirs[1]), truth, dirs)


def test_replay_matches_jax_f64_and_truth(earth_off):
    jm, jt, tm, tt, truth, _ = earth_off
    assert_twins(jm, jt, tm, tt, PRECISE)
    err = errors(tt[2:], truth)
    assert err.mean() < 0.08 and err.max() < 0.30, err


def test_output_files_match_jax(earth_off):
    """The reference schemas (gvins.nav 11 columns, trajectory.csv 8,
    IMU_ERR.bin 8 doubles a record), as many rows as the JAX run, the same
    times, values to the last printed digits; all seven files exist."""
    *_, (jdir, tdir) = earth_off
    for name in ("gvins.nav", "trajectory.csv", "IMU_ERR.bin", "statistics.txt", "extrinsic.txt",
                 "mappoint.txt", "tracking.txt"):
        assert os.path.exists(os.path.join(tdir, name)), name
    jnav, tnav = (np.loadtxt(os.path.join(d, "gvins.nav")) for d in (jdir, tdir))
    assert tnav.shape == jnav.shape and tnav.shape[1] == 11 and len(tnav) > 100
    assert abs(tnav[0, 2] - 30.5) < 0.01
    np.testing.assert_array_equal(tnav[:, :2], jnav[:, :2])
    np.testing.assert_allclose(tnav, jnav, atol=2e-9)        # printed to 1e-9
    jtr, ttr = (np.loadtxt(os.path.join(d, "trajectory.csv")) for d in (jdir, tdir))
    assert ttr.shape == jtr.shape and ttr.shape[1] == 8
    np.testing.assert_allclose(ttr, jtr, atol=2e-9)
    jerr, terr = (np.fromfile(os.path.join(d, "IMU_ERR.bin"), dtype=np.float64) for d in (jdir, tdir))
    assert len(terr) == len(jerr) and len(terr) % 8 == 0 and len(terr) > 0
    np.testing.assert_allclose(terr, jerr, atol=1e-6)        # deg/h, mGal


def test_earth_rate_replay_matches_jax_production_and_truth(jax_gins):
    """iswithearth=true, the reference's shipped configuration: the EARTH
    preintegration and the iewn feedback, on an earth-consistent world,
    against the JAX package as it runs in production."""
    imu, gnss, truth = make_gins_dataset(turn_duration=8.0, with_earth=True)
    tm, tt = port_run(imu, gnss, truth, True)
    jm, jt = jax_gins["earth_rate"]
    assert tm.est.wcfg.with_earth
    assert_twins(jm, jt, tm, tt, PRODUCTION)
    err = errors(tt[2:], truth)
    assert err.mean() < 0.08 and err.max() < 0.30, err
    np.testing.assert_allclose(tm.est.mixes[tm.est.n_nodes - 1, 3:5], [0.002, -0.001], atol=1e-3)


def test_gnss_gap_chains_time_nodes(jax_gins):
    """Fixes dropped in (5.5 s, 9.5 s): the 5 s gap (1000 samples > 512) is
    bridged by a chained time node at 7.55 s; the replay matches the JAX
    twin (f64 solve) and recovers to GNSS-noise level."""
    imu, gnss, truth = gap_world()
    chained = []
    add = TGins._chain_time_nodes

    def spy(self, stream, t_target):
        n0 = self.est.n_nodes
        add(self, stream, t_target)
        chained.extend(self.est.times[n0:self.est.n_nodes])

    mp = pytest.MonkeyPatch()
    mp.setattr(TGins, "_chain_time_nodes", spy)
    try:
        tm, tt = port_run(imu, gnss, truth, False)
    finally:
        mp.undo()
    jm, jt = jax_gins["gap"]
    np.testing.assert_allclose(chained, [7.55], atol=1e-9)
    assert_twins(jm, jt, tm, tt, PRECISE)
    err = errors(tt[tt[:, 0] > 10.0], truth)
    assert len(err) >= 3 and err[-4:].mean() < 0.15, err
