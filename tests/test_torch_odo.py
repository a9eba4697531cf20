"""The port's wheel-odometer variants (ODO and EARTH_ODO) against the JAX
package on the CPU: the five cases of tests/test_preint_odo.py with the
port's preintegration and factor held against the JAX functions on the same
seeded inputs. chip_smoke.py's copy of the odometer world and the two
odometer replays on both packages are in tests/test_torch_odo_twin.py.

Tolerances. Preintegration: the fields of tests/test_torch_preint.py's
comparison (both reassociate f64 sums; observed <= 1e-15 m on ds and
1.7e-10 on a whitener of scale 4e5); the port's one-step oracle against
its log-depth form within the same. Factor: residuals within 1e-9 (a
whitened residual of scale 4e5; observed 9e-11), jacobians within 1e-12
relative to their largest entry (observed 1e-16)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_preint_odo as ref
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.factors import basic as jbasic
from ic_gvins_tpu.factors import preint_odo_factor as jfactor
from ic_gvins_tpu.ins import preintegration as jpre
from ic_gvins_tpu.ins.preintegration_odo import preintegrate_odo as jodo
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core.types import ImuBatch as TImu
from ic_gvins_tpu_torch.factors import basic as tbasic
from ic_gvins_tpu_torch.factors import preint_odo_factor as tfactor
from ic_gvins_tpu_torch.ins import preintegration as tpre
from ic_gvins_tpu_torch.ins import preintegration_odo as todo

torch.set_num_threads(1)
TOL = dict(dt=1e-12, dp=1e-10, dv=1e-10, dq=1e-12, ds=1e-10, bg0=0, ba0=0, sodo0=0, dp_dbg=1e-10, dp_dba=1e-10,
           dv_dbg=1e-10, dv_dba=1e-10, dq_dbg=1e-12, ds_dbg=1e-10, ds_dsodo=1e-10, gravity=0, iewn=0,
           sum_dtpn=1e-8, end_p=1e-9, end_q=1e-12, end_v=1e-10, end_time=0)
REL = dict(cov=1e-9, sqrt_info=1e-7)


def _port(p, imu, st):
    """The JAX test's params, IMU batch and state as the port's tensors."""
    tp = convert.integration_params({k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    return tp, TImu(*[torch.tensor(np.asarray(a)) for a in imu]), \
        convert.nav_state({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")


def _check(port, want, fields=todo.PreintOdoSummary._fields):
    for name in fields:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(want, name))
        if name in REL:
            np.testing.assert_allclose(a, b, atol=REL[name] * np.abs(b).max(), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=TOL[name], err_msg=name)


def _both(p, imu, st, with_earth=False, iewn=None):
    """(JAX summary, port summary, port oracle summary) on the same inputs."""
    want = jodo(p, imu, st, with_earth=with_earth, iewn=None if iewn is None else jnp.asarray(iewn))
    args = _port(p, imu, st)
    kw = dict(with_earth=with_earth, iewn=None if iewn is None else torch.tensor(iewn))
    return want, todo.preintegrate_odo(*args, **kw), todo.preintegrate_odo_seq(*args, **kw)


def test_matches_15dim_core():
    """The 19-dim integrals equal the 15-dim variant's (same inputs), in the
    port as in the JAX package, and every field equals the JAX twin's."""
    imu, st, p = ref.make_imu(), ref.start_state(), ref.params()
    want, port, seq = _both(p, imu, st)
    _check(port, want)
    _check(seq, port)
    s15 = tpre.preintegrate(*_port(p, imu, st), with_earth=False)
    np.testing.assert_allclose(port.dp, s15.dp, atol=1e-12)
    np.testing.assert_allclose(port.dv, s15.dv, atol=1e-12)
    np.testing.assert_allclose(abs(float(torch.dot(port.dq, s15.dq))), 1.0, atol=1e-12)
    np.testing.assert_allclose(port.cov[:9, :9], s15.cov[:9, :9], rtol=1e-6, atol=1e-18)
    j15 = jpre.preintegrate(p, imu, st, with_earth=False)
    np.testing.assert_allclose(s15.cov[:9, :9], np.asarray(j15.cov)[:9, :9], rtol=1e-9, atol=1e-20)


def test_odo_integral_straight_line():
    """Constant forward speed, no rotation, no mounting offsets: ds = v*t*x,
    in both packages."""
    n, dt, v = 101, 0.005, 2.0
    imu = ref.ImuBatch(time=jnp.asarray(dt * np.arange(n)), dt=jnp.concatenate([jnp.zeros(1), jnp.full(n - 1, dt)]),
                       dtheta=jnp.zeros((n, 3)), dvel=jnp.tile(jnp.array([0, 0, -ref.G * dt]), (n, 1)),
                       odovel=jnp.full(n, v * dt))
    p = ref.params()._replace(abv=jnp.zeros(3), lodo=jnp.zeros(3))
    want, port, seq = _both(p, imu, ref.NavState.identity())
    np.testing.assert_allclose(port.ds.numpy(), [v * 0.5, 0, 0], atol=1e-9)
    _check(port, want)
    _check(seq, port)


def _factor_case(with_earth):
    """The JAX test's factor case: a preintegrated interval and seeded
    poses/mixes; the port's residual and analytic jacobians against the JAX
    factor's (which tests/test_preint_odo.py holds against forward
    differentiation), also batched over a table axis."""
    imu, st, p = ref.make_imu(seed=17), ref.start_state(19), ref.params()
    iewn = np.array([6e-5, 0.0, -4e-5]) if with_earth else None
    want, port, _ = _both(p, imu, st, with_earth, iewn)
    _check(port, want)
    rng = np.random.default_rng(23)
    pose0 = np.concatenate([rng.normal(0, 5, 3), np.asarray(ref.quat.from_rotvec(jnp.asarray(rng.normal(0, 0.5, 3))))])
    pose1 = np.concatenate([rng.normal(0, 5, 3), np.asarray(ref.quat.from_rotvec(jnp.asarray(rng.normal(0, 0.5, 3))))])
    mix0 = np.concatenate([rng.normal(0, 2, 3), np.asarray(want.bg0), np.asarray(want.ba0), [float(want.sodo0)]])
    mix1 = np.concatenate([rng.normal(0, 2, 3), rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3), [0.005]])
    jargs = [jnp.asarray(a) for a in (pose0, mix0, pose1, mix1)]
    targs = [torch.tensor(a) for a in (pose0, mix0, pose1, mix1)]
    r_j = np.asarray(jfactor.residual(want, *jargs, with_earth=with_earth))
    r_t = tfactor.residual(port, *targs, with_earth=with_earth).numpy()
    assert r_t.shape == (tfactor.NUM_RES,)
    np.testing.assert_allclose(r_t, r_j, atol=1e-9)
    for Jt, Jj in zip(tfactor.jacobians(port, *targs, with_earth=with_earth),
                      jfactor.jacobians(want, *jargs, with_earth=with_earth)):
        Jj = np.asarray(Jj)
        assert Jt.shape == Jj.shape
        np.testing.assert_allclose(Jt.numpy(), Jj, atol=1e-12 * np.abs(Jj).max())
    # batched over a leading table axis, as the solver calls it
    tb = todo.PreintOdoSummary(*[a.expand((2,) + a.shape) for a in port])
    rb = tfactor.residual(tb, *[a.expand(2, -1) for a in targs], with_earth=with_earth)
    np.testing.assert_allclose(rb.numpy(), np.stack([r_t, r_t]), atol=0)


def test_odo_factor_jacobians():
    _factor_case(False)


def test_earth_odo_factor_jacobians():
    _factor_case(True)


def test_bias_scale_jacobian_fd():
    """ds_dbg / ds_dsodo of the port equal the JAX twin's, and both lie
    within the JAX test's bounds of the true derivative of re-integration
    (forward differentiation of the JAX function); the 7-res bias prior of
    the odometer window equals the JAX one."""
    imu, st, p = ref.make_imu(seed=29), ref.start_state(31), ref.params()
    want, port, _ = _both(p, imu, st)
    _check(port, want, ("ds", "ds_dbg", "ds_dsodo"))

    def ds_of(bg, sodo):
        return jodo(p, imu, st._replace(bg=bg, sodo=sodo), with_earth=False).ds

    J_bg = np.asarray(jax.jacfwd(lambda bg: ds_of(bg, st.sodo))(st.bg))
    J_sodo = np.asarray(jax.jacfwd(lambda s: ds_of(st.bg, s))(st.sodo))
    np.testing.assert_allclose(port.ds_dbg.numpy(), J_bg, atol=0.06 * max(1.0, np.abs(J_bg).max()))
    np.testing.assert_allclose(port.ds_dsodo.numpy(), J_sodo, atol=0.05 * max(1.0, np.abs(J_sodo).max()))
    mix = np.random.default_rng(3).normal(0, 1e-3, 10)
    np.testing.assert_allclose(tbasic.imu_error_residual_odo(torch.tensor(mix)).numpy(),
                               np.asarray(jbasic.imu_error_residual_odo(jnp.asarray(mix))), rtol=1e-14)
    np.testing.assert_allclose(tbasic.imu_error_jacobian_odo().numpy(),
                               np.asarray(jbasic.imu_error_jacobian_odo()), rtol=1e-14)
