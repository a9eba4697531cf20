"""The two odometer replays of tests/test_gins_e2e.py (GinsModel with
``isuseodo: true``, earth rate off and on) on both packages, on the CPU,
and chip_smoke.py's jax-free copy of their world, which runs while the JAX
replays do.

These twins wait on a JAX child, so they live in a file of few tests: the
test queue takes files by their count of tests, most first, and this one
then starts after tests/test_gvins_long_e2e.py
(test_torch_harness.py::test_child_modules_queue_after_the_long_replay).

Tolerances: the JAX solve patched to its f64 mode, as
tests/test_torch_gins_twin.py does; node times equal, positions 1e-8 m,
attitudes 1e-9, velocities 1e-8 m/s, the odometer scale 1e-9. Both JAX
replays run in one child process (tests/test_torch_harness.py, sync
dispatch) started with the module, beside the world check and the port's
replays."""

import pickle

import numpy as np
import pytest
import torch

from gins_data import make_gins_dataset
from test_torch_gins import _precise_solve_jit
from test_torch_harness import jax_child, jax_result, kill_if_running, module_reads
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.models.gins import GinsModel as JGins
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gins import GinsModel as TGins

torch.set_num_threads(1)
SCALE_ERR = 0.01
ODO_CHILD_LIMIT = 470   # s: ~3x the JAX child's wall alone on an 8-core CPU (155.4 s, both replays)


def _odo_world(with_earth):
    """tests/test_gins_e2e.py's odometer world and configuration."""
    imu, gnss, truth = make_gins_dataset(with_earth=with_earth, with_odo=True, odo_scale_err=SCALE_ERR)
    raw = dict(initlength=3, imudatarate=200, iswithearth=with_earth, antlever=list(truth["lever"]),
               imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
               optimize_windows_size=10, isuseodo=True,
               odometer=dict(std=[0.02, 0.5, 0.5], srw=1000.0, abv=[0.0, 0.0, 0.0], lodo=[0.0, 0.0, 0.0]))
    return imu, gnss, truth, raw


def jax_odo_replays(out_path):
    """The JAX replays of both odometer worlds (earth rate off, then on; the
    solve in f64), one after the other in this process; pickles to
    out_path, for each, its trajectory and what the twin test reads of the
    model."""
    out = {}
    for with_earth in (False, True):
        imu, gnss, truth, raw = _odo_world(with_earth)
        jm = JGins(jparse(raw))
        mp = pytest.MonkeyPatch()
        mp.setattr(jest, "_solve_jit", _precise_solve_jit)
        try:
            jt = jm.run(imu, gnss)
        finally:
            mp.undo()
        out[with_earth] = dict(traj=np.asarray(jt), state=jm.state, mixes=np.array(jm.est.mixes),
                               n_nodes=jm.est.n_nodes)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def jax_odo_child(request, jax_compile_cache, tmp_path_factory):
    """``jax_odo_replays`` in a child process (tests/test_torch_harness.py,
    sync dispatch) started with the module, so that the JAX replays run
    beside the world check and the port's replays: (child, pickle path), or
    None where no test of the module reads them. Killed at the module's end
    if still running."""
    if not module_reads(request, "jax_odo"):
        yield None
        return
    out_path = str(tmp_path_factory.mktemp("jax_odo") / "jax_odo.pkl")
    child = jax_child("test_torch_odo_twin:jax_odo_replays", out_path)
    yield child, out_path
    kill_if_running(child)


def test_chip_smoke_odo_world_matches_gins_data():
    """chip_smoke.py's jax-free world with the wheel odometer (phase 6's
    odometer run) gives tests/gins_data.py's arrays within 1e-9 (GNSS
    heights 1e-8 m, as tests/test_torch_gins.py states)."""
    import chip_smoke

    ref_world = make_gins_dataset(with_earth=True, with_odo=True, odo_scale_err=SCALE_ERR)
    port_world = chip_smoke.gins_world(with_earth=True, with_odo=True, odo_scale_err=SCALE_ERR)
    for a, b in zip(port_world, ref_world):
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            if k == "blh":
                np.testing.assert_allclose(x[:, 2], y[:, 2], atol=1e-8, rtol=0, err_msg="height")
                x, y = x[:, :2], y[:, :2]
            np.testing.assert_allclose(x, y, atol=1e-9, rtol=0, err_msg=k)
    assert np.abs(port_world[0]["odovel"]).max() > 0.005


@pytest.fixture(scope="module")
def jax_odo(jax_odo_child):
    """``jax_odo_replays``' result for a world, the child waited for at the
    first call, so that a test can run the port's replay first."""
    out = []

    def result(with_earth):
        if not out:
            out.append(jax_result(*jax_odo_child, timeout=ODO_CHILD_LIMIT))
        return out[0][with_earth]
    return result


@pytest.mark.parametrize("with_earth", [False, True], ids=["odo", "earth_odo"])
def test_odo_replay_matches_jax(with_earth, jax_odo):
    """test_gins_e2e.py::test_odo_replay_converges (earth off) and
    ::test_earth_odo_replay (earth on) on both packages: the port's
    trajectory, velocities and odometer scale against the JAX twin (f64
    solve, ``jax_odo_replays``, waited for after the port's replay), and
    the JAX test's gates against the truth."""
    imu, gnss, truth, raw = _odo_world(with_earth)
    tm = TGins(tparse(raw), device="cpu")
    tt = tm.run(imu, gnss)
    jm = jax_odo(with_earth)
    jt = jm["traj"]
    assert tm.est.wcfg.with_odo and tm.est.wcfg.with_earth == with_earth and tm.est.mixes.shape[1] == 10
    assert tm.state == jm["state"] == "INITIALIZING_INS"
    assert tt.shape == jt.shape and len(tt) >= 10
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
    np.testing.assert_allclose(tt[:, 1:4], jt[:, 1:4], atol=1e-8)
    np.testing.assert_allclose(tt[:, 4:8], jt[:, 4:8], atol=1e-9)
    np.testing.assert_allclose(tm.est.mixes[:, :3], jm["mixes"][:, :3], atol=1e-8)
    k = tm.est.n_nodes - 1
    sodo = float(tm.est.mixes[k, 9])
    np.testing.assert_allclose(sodo, float(jm["mixes"][k, 9]), atol=1e-9)
    idx = np.round(tt[2:, 0] * 200.0).astype(int) - 1
    err = np.linalg.norm(tt[2:, 1:4] + truth["gnss_local"][0] - truth["p"][idx], axis=1)
    assert err.mean() < 0.08, f"mean pos err {err.mean():.3f} m"
    assert 0.2 * SCALE_ERR < sodo < 3.0 * SCALE_ERR, f"sodo {sodo:.5f}"
    assert tm.est.check_time_consistency() == []
