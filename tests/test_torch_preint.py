"""The port's preintegration (NORMAL and EARTH) against the JAX function and
the port's sequential oracle, on the CPU: seeded IMU windows with an anchor
sample, zero padding and biases, field by field; and the batched form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic as syn
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)

from ic_gvins_tpu.core import earth as jearth
from ic_gvins_tpu.core.types import ImuBatch as JImu
from ic_gvins_tpu.core.types import IntegrationParams as JParams
from ic_gvins_tpu.core.types import NavState as JNav
from ic_gvins_tpu.ins import preintegration as jpre
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core.types import ImuBatch as TImu
from ic_gvins_tpu_torch.core.types import IntegrationParams as TParams
from ic_gvins_tpu_torch.ins import parallel_scan as pscan
from ic_gvins_tpu_torch.ins import preintegration as tpre

torch.set_num_threads(1)
ORIGIN = np.array([np.deg2rad(30.5), np.deg2rad(114.3), 40.0])
# per-field absolute tolerances against the JAX log-depth function (the two
# reassociate sums differently): positions/velocities, attitude, jacobians,
# covariance and whitener (relative to their scale)
TOL = dict(dt=1e-12, dp=1e-10, dv=1e-10, dq=1e-12, bg0=0, ba0=0, dp_dbg=1e-10, dp_dba=1e-10, dv_dbg=1e-10,
           dv_dba=1e-10, dq_dbg=1e-12, gravity=0, iewn=0, sum_dtpn=1e-8, end_p=1e-9, end_q=1e-12,
           end_v=1e-10, end_time=0)
REL = dict(cov=1e-9, sqrt_info=1e-7)


def _window(seed, n=300, pad=40, dt=0.005):
    b = syn.smooth_imu(n + pad, dt, seed=seed)
    imu = dict(time=np.array(b.time) + 1.0, dt=np.full(n + pad, dt), dtheta=np.array(b.dtheta),
               dvel=np.array(b.dvel), odovel=np.zeros(n + pad))
    for f in ("dt", "dtheta", "dvel"):
        imu[f][n:] = 0.0
    imu["dt"][0] = 0.0   # the anchor sample never integrates
    rng = np.random.default_rng(seed + 100)
    q = rng.normal(size=4)
    st = dict(time=np.float64(imu["time"][0]), p=rng.normal(0, 50, 3), q=q / np.linalg.norm(q),
              v=rng.normal(0, 3, 3), bg=rng.normal(0, 1e-3, 3), ba=rng.normal(0, 1e-2, 3),
              sodo=np.float64(0.0), sg=np.zeros(3), sa=np.zeros(3))
    return imu, st


def _params():
    p = JParams.default()._replace(gravity=jnp.asarray(9.7936), corr_time=jnp.asarray(3600.0),
                                   gyr_bias_std=jnp.asarray(400 * np.pi / 180 / 3600),
                                   acc_bias_std=jnp.asarray(400e-5))
    return p, convert.integration_params({k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")


def _check(port, ref, scale=1.0):
    for name in tpre.PreintSummary._fields:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        if name in REL:
            np.testing.assert_allclose(a, b, atol=REL[name] * np.abs(b).max(), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=TOL[name] * scale, err_msg=name)


@pytest.mark.parametrize("with_earth", [False, True])
def test_preintegrate_matches_jax_and_sequential(with_earth):
    imu, st = _window(1)
    jp, tp = _params()
    iewn = np.asarray(jearth.iewn(jnp.asarray(ORIGIN), jnp.zeros(3))) if with_earth else None
    jimu = JImu(**{k: jnp.asarray(v) for k, v in imu.items()})
    ref = jpre.preintegrate(jp, jimu, JNav(**{k: jnp.asarray(v) for k, v in st.items()}),
                            with_earth=with_earth, iewn=None if iewn is None else jnp.asarray(iewn))
    args = (tp, TImu(**{k: torch.tensor(v) for k, v in imu.items()}), convert.nav_state(st, "cpu"))
    kw = dict(with_earth=with_earth, iewn=None if iewn is None else torch.tensor(iewn))
    port = tpre.preintegrate(*args, **kw)
    _check(port, ref)
    # the port's one-step oracle agrees with its log-depth form
    _check(tpre.preintegrate_seq(*args, **kw), port)
    U = port.sqrt_info.numpy()
    np.testing.assert_allclose(U.T @ U @ port.cov.numpy(), np.eye(15), atol=1e-6)


def test_preintegrate_batch_matches_single_calls():
    """Three windows of different lengths and states in one batched call,
    with earth rate: each equals its own call."""
    jp, tp = _params()
    wins = [_window(s, n=n, pad=340 - n) for s, n in ((2, 300), (3, 120), (4, 17))]
    iewn = np.asarray(jearth.iewn(jnp.asarray(ORIGIN), jnp.asarray(np.array([[0, 0, 0], [900, 0, 0], [0, -900, 0.0]]))))
    imu = TImu(**{k: torch.tensor(np.stack([w[0][k] for w in wins])) for k in wins[0][0]})
    st = convert.nav_state({k: np.stack([w[1][k] for w in wins]) for k in wins[0][1]}, "cpu")
    batch = tpre.preintegrate_batch(tp, imu, st, with_earth=True, iewn_batch=torch.tensor(iewn))
    for i, (w_imu, w_st) in enumerate(wins):
        one = tpre.preintegrate(tp, TImu(**{k: torch.tensor(v) for k, v in w_imu.items()}),
                                convert.nav_state(w_st, "cpu"), with_earth=True, iewn=torch.tensor(iewn[i]))
        _check(type(batch)(*[x[i] for x in batch]), one, scale=0.1)


def test_phi_cov_reduce_matches_a_sequential_chain():
    """The pairwise tree reduction of (Phi, Q) equals J_k = Phi_k J_{k-1},
    P_k = Phi_k P Phi_kᵀ + Q_k at odd and even lengths."""
    rng = np.random.default_rng(9)
    for S in (1, 6, 13):
        phi = torch.tensor(np.eye(5) + 0.1 * rng.normal(size=(S, 5, 5)))
        a = rng.normal(size=(S, 5, 5))
        q = torch.tensor(a @ np.swapaxes(a, 1, 2))
        J, P = torch.eye(5, dtype=torch.float64), torch.zeros(5, 5, dtype=torch.float64)
        for k in range(S):
            J, P = phi[k] @ J, phi[k] @ P @ phi[k].T + q[k]
        Jr, Pr = pscan.phi_cov_reduce(phi, q)
        np.testing.assert_allclose(Jr.numpy(), J.numpy(), atol=1e-12)
        np.testing.assert_allclose(Pr.numpy(), P.numpy(), atol=1e-11)


def test_integration_params_default_match_jax():
    jd, td = JParams.default(), TParams.default()
    for name in jd._fields:
        np.testing.assert_allclose(np.asarray(getattr(td, name)), np.asarray(getattr(jd, name)), atol=0)
