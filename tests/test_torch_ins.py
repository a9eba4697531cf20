"""The port's INS core against its JAX twins on the CPU: quaternion and earth
helpers, ECEF<->BLH, mechanization (against the JAX scan and the port's own
sequential oracle), zero-velocity detection, pose interpolation, the IMU
stream's interpolated series, and the chunked propagator. Inputs are seeded
numpy arrays fed to both packages."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic as syn
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)

from ic_gvins_tpu.core import earth as jearth
from ic_gvins_tpu.core import earth_np as jearth_np
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.core.types import ImuBatch as JImu
from ic_gvins_tpu.core.types import NavState as JNav
from ic_gvins_tpu.engine import replay as jreplay
from ic_gvins_tpu.engine.config import integration_params_from_config as j_params_from_config
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.ins import mechanization as jmech
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core import earth as tearth
from ic_gvins_tpu_torch.core import earth_np as tearth_np
from ic_gvins_tpu_torch.core import quaternion as tquat
from ic_gvins_tpu_torch.core.types import ImuBatch as TImu
from ic_gvins_tpu_torch.core.types import integration_params_from_config as t_params_from_config
from ic_gvins_tpu_torch.engine import replay as treplay
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.ins import mechanization as tmech

torch.set_num_threads(1)
ORIGIN = np.array([np.deg2rad(30.5), np.deg2rad(114.3), 40.0])


def T(a):
    return torch.tensor(np.asarray(a, np.float64))


def J(a):
    return jnp.asarray(np.asarray(a, np.float64))


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# quaternion + earth: exact formulas, so f64 rounding tolerances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["mul", "rotate", "to_matrix", "from_matrix", "rotvec", "skew_lr",
                                "euler", "boxplus_boxminus"])
def test_quaternion_matches_jax(fn):
    rng = np.random.default_rng(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3))
    if fn == "mul":
        close(tquat.mul(T(q1), T(q2)), jquat.mul(J(q1), J(q2)), 1e-15)
        close(tquat.conj(T(q1)), jquat.conj(J(q1)), 0)
        close(tquat.normalize(T(2 * q1)), jquat.normalize(J(2 * q1)), 1e-15)
    elif fn == "rotate":
        close(tquat.rotate(T(q1), T(v)), jquat.rotate(J(q1), J(v)), 1e-14)
        close(tquat.rotate(T(q1), T(v[0])), jquat.rotate(J(q1), J(v[0])), 1e-14)  # broadcast
    elif fn == "to_matrix":
        close(tquat.to_matrix(T(q1)), jquat.to_matrix(J(q1)), 1e-15)
    elif fn == "from_matrix":
        m = np.asarray(jquat.to_matrix(J(q1)))
        # near-pi rotations take the other pivots
        m_pi = np.asarray(jquat.to_matrix(jquat.from_rotvec(J(rng.normal(size=(16, 3)) * 0.01
                                                            + np.array([np.pi - 1e-3, 0, 0])))))
        for mm in (m, m_pi):
            close(tquat.from_matrix(T(mm)), jquat.from_matrix(J(mm)), 1e-14)
    elif fn == "rotvec":
        rv = np.concatenate([rng.normal(size=(32, 3)), rng.normal(size=(8, 3)) * 1e-10, np.zeros((1, 3))])
        close(tquat.from_rotvec(T(rv)), jquat.from_rotvec(J(rv)), 1e-15)
        close(tquat.to_rotvec(T(q1)), jquat.to_rotvec(J(q1)), 1e-14)
        close(tquat.to_rotvec(tquat.from_rotvec(T(rv[:32]))), jquat.to_rotvec(jquat.from_rotvec(J(rv[:32]))), 1e-13)
    elif fn == "skew_lr":
        close(tquat.skew(T(v)), jquat.skew(J(v)), 0)
        close(tquat.left33(T(q1)), jquat.left33(J(q1)), 0)
        close(tquat.right33(T(q1)), jquat.right33(J(q1)), 0)
    elif fn == "euler":
        e = rng.uniform([-3, -1.5, -3], [3, 1.5, 3], size=(64, 3))
        close(tquat.euler_to_matrix(T(e)), jquat.euler_to_matrix(J(e)), 1e-15)
        close(tquat.euler_to_quat(T(e)), jquat.euler_to_quat(J(e)), 1e-14)
        close(tquat.quat_to_euler(T(q1)), jquat.quat_to_euler(J(q1)), 1e-12)
        lock = np.asarray(jquat.euler_to_matrix(J([[0.3, np.pi / 2 - 1e-4, 0.2], [0.1, -np.pi / 2 + 1e-4, 1.0]])))
        close(tquat.matrix_to_euler(T(lock)), jquat.matrix_to_euler(J(lock)), 1e-9)
        close(tearth_np.matrix_to_euler(lock), jquat.matrix_to_euler(J(lock)), 1e-9)
    else:
        pose = np.concatenate([v, q1], axis=1)
        d = rng.normal(size=(64, 6)) * 0.1
        close(tquat.boxplus_pose(T(pose), T(d)), jquat.boxplus_pose(J(pose), J(d)), 1e-14)
        pose2 = np.concatenate([v + 1, q2], axis=1)
        close(tquat.boxminus_pose(T(pose), T(pose2)), jquat.boxminus_pose(J(pose), J(pose2)), 1e-14)


def test_earth_and_ecef_blh_match_jax():
    """gravity, radii, cne, BLH<->ECEF, local<->global (points and poses),
    iewn and enwn, torch and numpy copies, against the JAX module."""
    rng = np.random.default_rng(1)
    blh = np.stack([rng.uniform(-1.2, 1.2, 32), rng.uniform(-3, 3, 32), rng.uniform(-100, 3000, 32)], 1)
    local = rng.normal(0, 500, (32, 3))
    vel = rng.normal(0, 10, (32, 3))
    close(tearth.gravity(T(blh)), jearth.gravity(J(blh)), 1e-13)
    close(tearth.meridian_prime_vertical_radius(T(blh[:, 0])),
          jearth.meridian_prime_vertical_radius(J(blh[:, 0])), 1e-8)
    close(tearth.cne(T(blh)), jearth.cne(J(blh)), 1e-15)
    ecef = np.asarray(jearth.blh2ecef(J(blh)))
    close(tearth.blh2ecef(T(blh)), ecef, 1e-8)
    close(tearth.ecef2blh(T(ecef)), jearth.ecef2blh(J(ecef)), 1e-8)
    close(tearth.ecef2blh(T(ecef))[:, :2], blh[:, :2], 1e-12)
    close(tearth.local2global(T(ORIGIN), T(local)), jearth.local2global(J(ORIGIN), J(local)), 1e-8)
    g = np.asarray(jearth.local2global(J(ORIGIN), J(local)))
    close(tearth.global2local(T(ORIGIN), T(g)), jearth.global2local(J(ORIGIN), J(g)), 1e-7)
    close(tearth.iewn(T(ORIGIN), T(local)), jearth.iewn(J(ORIGIN), J(local)), 1e-18)
    close(tearth.enwn(T(ORIGIN), T(local), T(vel)), jearth.enwn(J(ORIGIN), J(local), J(vel)), 1e-18)
    R = np.asarray(jquat.to_matrix(J(_quats(rng, 1)[0])))
    for port, ref in zip(tearth.local2global_pose(T(ORIGIN), T(R), T(local[0])),
                         jearth.local2global_pose(J(ORIGIN), J(R), J(local[0]))):
        close(port, ref, 1e-9)
    for port, ref in zip(tearth.global2local_pose(T(ORIGIN), T(R), T(g[0])),
                         jearth.global2local_pose(J(ORIGIN), J(R), J(g[0]))):
        close(port, ref, 1e-7)
    # the numpy copy: same formulas as the JAX package's numpy module
    close(tearth_np.gravity(blh), jearth_np.gravity(blh), 0)
    close(tearth_np.local2global(ORIGIN, local), jearth_np.local2global(ORIGIN, local), 0)
    close(tearth_np.global2local(ORIGIN, g), jearth_np.global2local(ORIGIN, g), 0)
    close(tearth_np.iewn(ORIGIN, local), jearth_np.iewn(ORIGIN, local), 0)
    Rs = np.asarray(jquat.to_matrix(J(_quats(rng, 8))))
    blh_b, R_b = tearth_np.local2global_pose(ORIGIN, Rs, local[:8])
    for k in range(8):
        b1, r1 = jearth.local2global_pose(J(ORIGIN), J(Rs[k]), J(local[k]))
        close(blh_b[k], b1, 1e-9)
        close(R_b[k], r1, 1e-14)


def _imu(n, seed, dt=0.005):
    """smooth_imu stream (increments) with dt on every sample, as numpy."""
    b = syn.smooth_imu(n, dt, seed=seed)
    return dict(time=np.array(b.time) + dt, dt=np.full(n, dt), dtheta=np.array(b.dtheta),
                dvel=np.array(b.dvel), odovel=np.zeros(n))


def _state(seed):
    rng = np.random.default_rng(seed)
    return dict(time=np.float64(0.0), p=rng.normal(0, 5, 3), q=_quats(rng, 1)[0], v=rng.normal(0, 2, 3),
                bg=rng.normal(0, 1e-3, 3), ba=rng.normal(0, 1e-2, 3), sodo=np.float64(0.0),
                sg=np.zeros(3), sa=np.zeros(3))


@pytest.mark.parametrize("with_earth", [False, True])
def test_mechanize_scan_matches_jax_and_sequential(with_earth):
    """Log-depth mechanization vs the JAX scan and vs the port's one-step
    oracle, with a previous sample and 40 zero-padded samples: 1e-9 m, 1e-11
    (quaternion), 1e-10 m/s over 300 samples."""
    imu = _imu(340, 3)
    for f in ("dt", "dtheta", "dvel"):
        imu[f][300:] = 0.0
    st = _state(4)
    g, iw = np.array([0, 0, 9.79]), np.asarray(jearth.iewn(J(ORIGIN), jnp.zeros(3)))
    prev = (0.005, imu["dtheta"][0] * 0.9, imu["dvel"][0] * 1.1)
    jout, jtraj = jmech.mechanize_scan(
        jmech.MechConfig(gravity=J(g), iewn=J(iw), iswithearth=with_earth), JNav(**{k: J(v) for k, v in st.items()}),
        JImu(**{k: J(v) for k, v in imu.items()}), imu_prev=tuple(J(x) for x in prev))
    cfg = tmech.MechConfig(gravity=T(g), iewn=T(iw), iswithearth=with_earth)
    args = (cfg, convert.nav_state(st, "cpu"), TImu(**{k: T(v) for k, v in imu.items()}))
    tprev = tuple(T(x) for x in prev)
    tout, ttraj = tmech.mechanize_scan(*args, imu_prev=tprev)
    sout, straj = tmech.mechanize_scan_seq(*args, imu_prev=tprev)
    for tr in (jtraj, straj):
        for a, b, tol in zip(ttraj, tr, (1e-9, 1e-11, 1e-10)):
            close(a, b, tol)
    close(tout.time, jout.time, 0)
    assert float(tout.time) == float(imu["time"][299])
    close(ttraj[0][299:], np.broadcast_to(np.asarray(ttraj[0][299]), (41, 3)), 0)  # padding is a no-op
    close(sout.p, tout.p, 1e-9)


def test_zero_velocity_interpolation_and_compensation_match_jax():
    rng = np.random.default_rng(5)
    still = rng.normal(0, 1e-6, (100, 3))
    moving = rng.normal(0, 1e-3, (100, 3))
    mask = np.ones(100)
    mask[90:] = 0.0
    for dth in (still, moving):
        jz, jth, jdv = jmech.detect_zero_velocity(J(dth), J(dth * 3), J(mask), 200.0)
        tz, tth, tdv = tmech.detect_zero_velocity(T(dth), T(dth * 3), T(mask), 200.0)
        assert bool(jz) == bool(tz)
        close(tth, jth, 1e-18)
        close(tdv, jdv, 1e-18)
    imu = _imu(16, 5)
    bg, ba = rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3)
    jc = jmech.compensate(JImu(**{k: J(v) for k, v in imu.items()}), J(bg), J(ba))
    tc = tmech.compensate(TImu(**{k: T(v) for k, v in imu.items()}), T(bg), T(ba))
    for a, b in zip(tc, jc):
        close(a, b, 1e-18)
    q0, q1 = _quats(rng, 2)
    p0, p1 = rng.normal(size=3), rng.normal(size=3)
    for s in (0.0, 0.3, 1.0):
        port = tmech.interpolate_pose(T(p0), T(q0), T(1.0), T(p1), T(q1), T(2.0), T(1.0 + s))
        ref = jmech.interpolate_pose(J(p0), J(q0), 1.0, J(p1), J(q1), 2.0, 1.0 + s)
        for a, b in zip(port, ref):
            close(a, b, 1e-14)


def test_imu_stream_series_interpolated_endpoints():
    """ImuStream.series at endpoints inside samples, on samples and within
    the 1e-4 s snap window, from the first sample on: identical arrays."""
    data = _imu(400, 6)
    js, ts = jreplay.ImuStream(data), treplay.ImuStream(data)
    t = data["time"]
    for start, end in ((0.0, 0.5), (t[10] + 0.0021, t[200] - 0.0013), (t[20], t[150]),
                       (t[30] + 5e-5, t[99] - 5e-5), (t[5] + 0.001, t[-1] + 1.0)):
        a, b = ts.series(start, end), js.series(start, end)
        for f in ("time", "dt", "dtheta", "dvel", "odovel"):
            np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize("with_earth", [False, True])
def test_ins_propagator_over_chunks_matches_jax(with_earth):
    """Three 256-sample chunks and a partial one, then one whole and one
    partial: per-sample output (1e-8 m, 1e-11, 1e-9 m/s) and the
    interpolated pose (1e-8)."""
    data = _imu(1400, 7)
    st = _state(8)
    st["time"] = np.float64(data["time"][10])
    g, iw = [0.0, 0.0, 9.79], np.asarray(jearth.iewn(J(ORIGIN), jnp.zeros(3)))
    jp = jreplay.InsPropagator(jreplay.ImuStream(data), J(g), J(iw), with_earth)
    tp = treplay.InsPropagator(treplay.ImuStream(data), g, iw, with_earth, device="cpu")
    out = {"j": [], "t": []}
    jp.set_state(JNav(**{k: J(v) for k, v in st.items()}))
    tp.set_state(convert.nav_state(st, "cpu"))
    for t_end in (data["time"][800] + 0.002, data["time"][1100]):
        jp.propagate_to(t_end, sample_cb=lambda *a: out["j"].append(a))
        tp.propagate_to(t_end, sample_cb=lambda *a: out["t"].append(a))
        assert tp.cursor == jp.cursor and tp._time_host == jp._time_host
    jq = jp.pose_interpolated(data["time"][1150] + 0.0031)
    tq = tp.pose_interpolated(data["time"][1150] + 0.0031)
    assert len(out["t"]) == len(out["j"]) == 6   # 4 chunks, then 2
    for a, b in zip(out["t"], out["j"]):
        for x, y, tol in zip(a, b, (0, 1e-8, 1e-11, 1e-9)):
            close(x, y, tol)
    for x, y in zip(tq, jq):
        close(x, y, 1e-8)


def test_integration_params_from_config_match_jax():
    raw = dict(imumodel=dict(arw=0.2, vrw=0.3, gbstd=400.0, abstd=300.0, corrtime=2.0),
               odometer=dict(std=[0.02, 0.5, 0.5], srw=1000.0, abv=[1.0, 0.0, 0.0], lodo=[0.1, 0.0, 0.0]))
    jp = j_params_from_config(jparse(raw), gravity=9.79)
    tp = t_params_from_config(tparse(raw), gravity=9.79, device="cpu")
    for name in jp._fields:
        close(getattr(tp, name), getattr(jp, name), 0)
    tp2 = convert.integration_params(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp, tp2))


def test_ins_propagator_defaults_to_cuda():
    """The propagator runs on the card unless the caller asks for the CPU;
    without CUDA its first device op raises."""
    assert inspect.signature(treplay.InsPropagator).parameters["device"].default == "cuda"
    stream = treplay.ImuStream(_imu(20, 0))
    if torch.cuda.is_available():
        assert treplay.InsPropagator(stream, [0, 0, 9.8], np.zeros(3), False).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            treplay.InsPropagator(stream, [0, 0, 9.8], np.zeros(3), False)
