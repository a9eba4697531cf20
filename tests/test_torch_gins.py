"""The port's GNSS/INS replay end to end on the CPU, against the JAX package's
GinsModel and against the ground truth, on tests/gins_data.py's world cut to
14 s (make_gins_dataset(turn_duration=8.0)): earth rate off and on, a GNSS gap
longer than a preintegration segment, and the output files. Also the
entry-point guards and chip_smoke.py's copy of the world generator.

Tolerances against the JAX run. The JAX package's production solve factors
in f32 with one f64 refinement; the port factors in f64, as the JAX solver's
``precise=True`` mode does. Against that mode (patched into the JAX
estimator) the replays agree to rounding: node positions and velocities
within 1e-8 m (m/s), attitudes 1e-9, biases 1e-10 (observed ~1e-11 m).
Against production, the f32 factor's error settles in the weakly observable
heading and gyro-z bias (as tests/test_batch_oracle.py finds): positions
within 1 mm, velocities 1 mm/s, quaternions 5e-4, gyro x/y bias 1e-5 rad/s,
gyro z 1e-4 rad/s (observed 1.3e-4 m, 1.2e-4, 1e-6 and 2.4e-5 rad/s).
The JAX replays of the three twins (earth rate off, on, and the GNSS gap)
run in one child process (tests/test_torch_harness.py, sync dispatch)
started with the module; the tests that need none of them come first."""

import functools
import inspect
import os
import pickle
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from gins_data import make_gins_dataset
from test_torch_harness import jax_child, jax_result, kill_if_running, module_reads
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.solver import lm as jlm
from ic_gvins_tpu.models.gins import GinsModel as JGins
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gins import GinsModel as TGins

torch.set_num_threads(1)
RATE = 200.0
PRECISE = dict(pos=1e-8, att=1e-9, vel=1e-8, bg_xy=1e-10, bg_z=1e-10)
PRODUCTION = dict(pos=1e-3, att=5e-4, vel=1e-3, bg_xy=1e-5, bg_z=1e-4)
GINS_CHILD_LIMIT = 310   # s: ~3x the JAX child's wall alone on an 8-core CPU (103.2 s, three replays)
# the JAX estimator's solve in the JAX solver's f64 mode (one jit, shared by
# every run of this file)
_precise_solve_jit = functools.partial(jax.jit, static_argnums=(2, 3))(
    lambda p, t, wc, iters: jlm.solve(p, t, wc, iters, precise=True)[:2])


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def raw_cfg(truth, with_earth, **kw):
    return dict(initlength=3, imudatarate=200, iswithearth=with_earth, antlever=list(truth["lever"]),
                imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0),
                gnssthreshold=20, optimize_windows_size=10, **kw)


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
    beside the tests that need none of them, which come first: (child,
    its output directory, pickle path), or None where no test of the module
    reads them. Killed at the module's end if still running."""
    if not module_reads(request, "jax_gins"):
        yield None
        return
    outdir = str(tmp_path_factory.mktemp("jax_out"))
    out_path = os.path.join(outdir, "jax_gins.pkl")
    child = jax_child("test_torch_gins:jax_gins_replays", outdir, out_path)
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


def assert_twins(jm, jt, tm, tt, tol):
    assert tm.state == jm.state == "INITIALIZING_INS"
    assert tt.shape == jt.shape and len(tt) >= 4
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])                     # node times
    np.testing.assert_allclose(tt[:, 1:4], jt[:, 1:4], atol=tol["pos"])   # positions
    np.testing.assert_allclose(tt[:, 4:8], jt[:, 4:8], atol=tol["att"])   # attitudes
    assert tm.est.n_nodes == jm.est.n_nodes
    np.testing.assert_array_equal(tm.est.times, jm.est.times)
    np.testing.assert_allclose(tm.est.mixes[:, :3], jm.est.mixes[:, :3], atol=tol["vel"])
    k = tm.est.n_nodes - 1
    np.testing.assert_allclose(tm.est.mixes[k, 3:5], jm.est.mixes[k, 3:5], atol=tol["bg_xy"])
    np.testing.assert_allclose(tm.est.mixes[k, 5], jm.est.mixes[k, 5], atol=tol["bg_z"])
    assert tm.est.check_time_consistency() == []


def test_odometer_raises_and_entry_point_defaults_to_cuda():
    """isuseodo=True no longer raises: it builds the odometer window (10-dim
    mix blocks, 19-res preintegration; its replays are held against the JAX
    twin in tests/test_torch_odo.py). GinsModel runs on the card unless the
    caller asks for the CPU, and without CUDA its first device op raises."""
    imu, gnss, truth = chip_smoke.gins_world(turn_duration=2.0)
    odo = TGins(tparse(raw_cfg(truth, False, isuseodo=True)), device="cpu")
    assert odo.wcfg.with_odo and odo.wcfg.mix_dim == 10 and odo.wcfg.preint_res == 19
    assert inspect.signature(TGins).parameters["device"].default == "cuda"
    model = TGins(tparse(raw_cfg(truth, False)))
    assert model.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            model.run(imu, gnss)


@pytest.mark.parametrize("with_earth", [False, True])
def test_chip_smoke_world_matches_gins_data(with_earth):
    """chip_smoke.py cannot import tests/gins_data.py (jax); its generator,
    built from the port, gives the same arrays within 1e-9. GNSS heights
    pass through ECEF coordinates of ~6.4e6 m, whose float64 spacing is
    9.3e-10 m: they agree within 1e-8 m."""
    ref = make_gins_dataset(with_earth=with_earth)
    port = chip_smoke.gins_world(with_earth=with_earth)
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            if k == "blh":
                np.testing.assert_allclose(x[:, 2], y[:, 2], atol=1e-8, rtol=0, err_msg="height")
                x, y = x[:, :2], y[:, :2]
            np.testing.assert_allclose(x, y, atol=1e-9, rtol=0, err_msg=k)


def test_estimator_episode_matches_jax_slot_by_slot():
    """One estimator driven by hand through both packages: the first 7 GNSS
    epochs of the 14 s world as time nodes, the two-pass optimization (the
    JAX solve in f64 mode), reintegration, a marginalization, two more
    nodes: the device tables equal the JAX package's slot by slot (1e-9 of
    scale), and the host mirrors after each step agree within 1e-8."""
    from ic_gvins_tpu.core.types import IntegrationParams as JParams
    from ic_gvins_tpu.core.types import NavState as JNav
    from ic_gvins_tpu.engine.replay import ImuStream
    from ic_gvins_tpu.solver.problem import WindowConfig as JWC
    from ic_gvins_tpu_torch import convert
    from ic_gvins_tpu_torch.engine.estimator import SlidingWindowEstimator as TEst
    from ic_gvins_tpu_torch.solver.problem import WindowConfig as TWC

    imu, gnss, truth = make_gins_dataset(turn_duration=8.0)
    stream = ImuStream(imu)
    wcj, wct = JWC(N=8, L=8, G=8, R=8, with_earth=False), TWC(N=8, L=8, G=8, R=8, with_earth=False)
    jparams = JParams.default()._replace(gravity=jax.numpy.asarray(9.7936))
    tparams = convert.integration_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    lever = truth["lever"]
    je = jest.SlidingWindowEstimator(wcj, jparams, preint_samples=512, antlever=lever)
    te = TEst(wct, tparams, preint_samples=512, antlever=lever, device="cpu")
    q0 = np.array([0.0, 0.0, np.sin(0.05), np.cos(0.05)])
    st0 = dict(time=np.float64(4.0), p=np.zeros(3), q=q0, v=np.zeros(3), bg=np.full(3, 1e-3),
               ba=np.zeros(3), sodo=np.float64(0.0), sg=np.zeros(3), sa=np.zeros(3))
    je.reset_first_node(4.0, JNav(**st0))
    te.reset_first_node(4.0, convert.nav_state(st0, "cpu"))
    pose_std = np.array([0.1, 0.1, 0.1, 0.01, 0.01, 0.03])
    mix_std = np.concatenate([np.full(3, 0.1), np.full(3, 1e-3), np.full(3, 0.2)])
    for e in (je, te):
        e.set_prior(np.concatenate([st0["p"], q0]), pose_std, np.zeros(9), mix_std)

    def add(t):
        g = truth["gnss_local"][int(t) - 1] - truth["gnss_local"][3]
        for e in (je, te):
            e.add_time_node(t, stream.series(e.times[e.n_nodes - 1], t))
            e.add_gnss(t, g, np.full(3, 0.02))

    def same_mirrors():
        assert te.n_nodes == je.n_nodes
        np.testing.assert_array_equal(te.times, je.times)
        np.testing.assert_allclose(te.poses, je.poses, atol=1e-8)
        np.testing.assert_allclose(te.mixes, je.mixes, atol=1e-8)
        for a, b in zip(te.preint_table.summ, je.preint_table.summ):
            np.testing.assert_allclose(a, b, atol=1e-8 * max(1.0, np.abs(b).max()))
        np.testing.assert_array_equal(te.preint_table.valid, je.preint_table.valid)

    for t in (5.0, 6.0, 7.0, 8.0, 9.0, 10.0):
        add(t)
    same_mirrors()
    tt, jt = te.build_tables(), je.build_tables()
    for name in ("gnss", "preint", "prior"):
        for a, b in zip(jax.tree_util.tree_leaves(tuple(getattr(tt, name))),
                        jax.tree_util.tree_leaves(np_tree(getattr(jt, name)))):
            np.testing.assert_allclose(np.asarray(a), b, atol=1e-9 * max(1.0, np.abs(b).max()))
    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        je.optimize(20, two_pass=True)
    finally:
        mp.undo()
    te.optimize(20, two_pass=True)
    same_mirrors()
    assert te.reintegrate_if_needed() == je.reintegrate_if_needed()
    same_mirrors()
    te.marginalize(1)
    je.marginalize(1)
    same_mirrors()
    np.testing.assert_allclose(te.marg_prior.H0.numpy(), np.asarray(je.marg_prior.H0),
                               atol=1e-6 * float(np.abs(np.asarray(je.marg_prior.H0)).max()))
    add(11.0)
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        je.optimize(20)
    finally:
        mp.undo()
    te.optimize(20)
    same_mirrors()
    assert te.check_time_consistency() == je.check_time_consistency() == []


# The twins of ``jax_gins_replays`` come last: the child's replays run while
# the tests above do.
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
