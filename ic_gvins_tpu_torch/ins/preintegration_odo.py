"""Odometer-aided IMU preintegration, ODO and EARTH_ODO variants.

Port of ``ic_gvins_tpu/ins/preintegration_odo.py`` (parity targets: IC-GVINS
``preintegration_odo.cc:27-305`` and ``preintegration_earth_odo.cc:28-387``):
19-dim error state (dp, dv, dq, dbg, dba, ds, dsodo), 16-dim noise (gyro /
accel white, gyro / accel Gauss-Markov, odometer white x3, odometer-scale
random walk). The wheel odometer adds a body-frame translation preintegral
ds with lever-arm and mounting-angle compensation and an estimated scale
sodo; the mix parameter block grows to 10 (v, bg, ba, sodo,
integration_state.h:59-63).

``preintegrate_odo`` shares the prefix chains of ``preintegration.py`` (the
odometer does not feed back into the IMU chains) and reduces the 19-dim
(Phi, Q) pairs as a tree; ``preintegrate_odo_seq`` is its
one-step-per-sample oracle, the JAX package's scan.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import quaternion as quat
from ..core.types import ImuBatch, IntegrationParams, NavState
from . import parallel_scan as pscan
from . import preintegration as pre

NUM_STATE = 19
NUM_NOISE = 16

_P, _V, _Q, _BG, _BA, _S, _SODO = 0, 3, 6, 9, 12, 15, 18


class PreintOdoSummary(NamedTuple):
    """Everything the odometer preintegration factor needs about one
    interval (the fields of ``PreintSummary`` and the odometer legs)."""

    dt: torch.Tensor
    dp: torch.Tensor
    dv: torch.Tensor
    dq: torch.Tensor
    ds: torch.Tensor            # (3,) odometer translation preintegral
    bg0: torch.Tensor
    ba0: torch.Tensor
    sodo0: torch.Tensor         # () linearization odometer scale
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor
    dq_dbg: torch.Tensor
    ds_dbg: torch.Tensor        # (3,3)
    ds_dsodo: torch.Tensor      # (3,)
    sqrt_info: torch.Tensor     # (19,19)
    cov: torch.Tensor
    gravity: torch.Tensor
    iewn: torch.Tensor
    sum_dtpn: torch.Tensor
    end_p: torch.Tensor
    end_q: torch.Tensor
    end_v: torch.Tensor
    end_time: torch.Tensor


def _noise_diag(params: IntegrationParams):
    """Diagonal of the 16x16 continuous noise matrix: the IMU's 12, the
    odometer's white noise (3) and its scale random walk (1)."""
    return torch.cat([pre._noise_diag(params), params.odo_std ** 2, (params.odo_srw ** 2)[None]])


def _odo_terms(params, dth, odovel, sodo0):
    """Per-sample (dsodo, s_body, stheta): the vehicle-frame wheel increment,
    its body-frame translation with the lever-arm rotation, and the attitude
    lever of the ds error row (preintegration_odo.cc:210-240)."""
    cvb = quat.euler_to_matrix(params.abv).T
    lodo = params.lodo
    dsodo = F.pad(odovel[..., None], (0, 2))
    scaled = (cvb @ dsodo[..., None])[..., 0] * (1.0 + sodo0)[..., None]
    s_body = scaled - quat.rotate(quat.from_rotvec(dth), lodo) + lodo
    return dsodo, s_body, scaled - quat.cross(dth, lodo)


def _phi_g_batch(params, dt, dth, dvl, cbb, sign_gyro, dsodo, stheta, sodo0):
    """19x19 transitions and 19x16 noise inputs per sample: the 15-dim IMU
    blocks of ``preintegration.py`` plus the ds / dsodo rows; ``sign_gyro``
    is the variant's gyro-noise input sign, which sets the Q-row / S-row
    cross term (ODO: +I, R skew(lodo), preintegration_odo.cc:262-265;
    EARTH_ODO: -I, cbb0 skew(lodo), preintegration_earth_odo.cc:336-340)."""
    cvb = quat.euler_to_matrix(params.abv).T
    sk_lodo = quat.skew(params.lodo)
    I3 = torch.eye(3, dtype=dt.dtype, device=dt.device)
    phi = F.pad(pre._phi_batch(dt, dth, dvl, cbb, params.corr_time), (0, 4, 0, 4))
    phi[..., _S:_S + 3, _Q:_Q + 3] = cbb @ quat.skew(stheta)
    phi[..., _S:_S + 3, _BG:_BG + 3] = cbb @ sk_lodo * dt[..., None, None]
    phi[..., _S:_S + 3, _S:_S + 3] = I3
    phi[..., _S:_S + 3, _SODO] = -(cbb @ (cvb @ dsodo[..., None]))[..., 0]
    phi[..., _SODO, _SODO] = 1.0
    g = F.pad(pre._g_batch(cbb, sign_gyro), (0, 4, 0, 4))
    g[..., _S:_S + 3, 0:3] = -sign_gyro * (cbb @ sk_lodo)
    g[..., _S:_S + 3, 12:15] = -(cbb @ cvb) * (1.0 + sodo0)[..., None, None]
    g[..., _SODO, 15] = 1.0
    return phi, g


def _qk(phi, g, noise, dt):
    a = phi @ (g @ noise @ g.transpose(-1, -2))
    return 0.5 * dt[..., None, None] * (a + a.transpose(-1, -2))


def _summary(dt, dp, dv, dq, ds, state0, jac, cov, gravity, iewn, sum_dtpn, end_p, end_q, end_v, end_time):
    cov_sym, sqrt_info = pre._whitener(cov)
    return PreintOdoSummary(
        dt=dt, dp=dp, dv=dv, dq=dq, ds=ds, bg0=state0.bg, ba0=state0.ba, sodo0=state0.sodo,
        dp_dbg=jac[..., _P:_P + 3, _BG:_BG + 3], dp_dba=jac[..., _P:_P + 3, _BA:_BA + 3],
        dv_dbg=jac[..., _V:_V + 3, _BG:_BG + 3], dv_dba=jac[..., _V:_V + 3, _BA:_BA + 3],
        dq_dbg=jac[..., _Q:_Q + 3, _BG:_BG + 3], ds_dbg=jac[..., _S:_S + 3, _BG:_BG + 3],
        ds_dsodo=jac[..., _S:_S + 3, _SODO], sqrt_info=sqrt_info, cov=cov_sym, gravity=gravity, iewn=iewn,
        sum_dtpn=sum_dtpn, end_p=end_p, end_q=end_q, end_v=end_v, end_time=end_time)


def preintegrate_odo_seq(params: IntegrationParams, imu: ImuBatch, state0: NavState, *,
                         with_earth: bool, iewn=None):
    """One step per sample over an unbatched (S,) series: the oracle of
    :func:`preintegrate_odo`. ``state0.sodo`` is the odometer-scale
    linearization point; ``imu.odovel`` the per-sample wheel distance
    increments."""
    f = dict(dtype=imu.dt.dtype, device=imu.dt.device)
    bg0, ba0, sodo0, q0 = state0.bg, state0.ba, state0.sodo, state0.q
    gravity = torch.tensor([0.0, 0.0, 1.0], **f) * params.gravity
    iewn = torch.zeros(3, **f) if iewn is None else iewn
    noise = torch.diag(_noise_diag(params))
    I3 = torch.eye(3, **f)

    dp, dv, ds, dq = torch.zeros(3, **f), torch.zeros(3, **f), torch.zeros(3, **f), quat.identity(**f)
    ap, aq, av = state0.p, state0.q, state0.v
    jac, cov = torch.eye(NUM_STATE, **f), torch.zeros(NUM_STATE, NUM_STATE, **f)
    dt_tot, sum_dtpn = torch.zeros((), **f), torch.zeros(3, **f)
    prev = (imu.dtheta[0] - imu.dt[0] * bg0, imu.dvel[0] - imu.dt[0] * ba0)
    for k in range(1, imu.dt.shape[0]):
        dt = imu.dt[k]
        dth = imu.dtheta[k] - dt * bg0
        dvl = imu.dvel[k] - dt * ba0
        dvfb, dtheta = pscan.dual_sample(dth, dvl, *prev)
        dt_new = dt_tot + dt
        dsodo, s_body, stheta = _odo_terms(params, dth, imu.odovel[k], sodo0)
        if with_earth:
            dv_cor_g = (gravity - 2.0 * quat.cross(iewn, av)) * dt
            qnn = quat.from_rotvec(-iewn * dt)
            dvel_abs = 0.5 * ((I3 + quat.to_matrix(qnn)) @ quat.rotate(aq, dvfb)) + dv_cor_g
            ap_new = ap + dt * av + 0.5 * dt * dvel_abs
            aq_new = quat.normalize(quat.mul(quat.mul(qnn, aq), quat.from_rotvec(dtheta)))
            sum_dtpn = sum_dtpn + dt * ap_new
            rot = quat.mul(quat.mul(quat.conj(q0), quat.from_rotvec(-(dt_new - 0.5 * dt) * iewn)),
                           quat.mul(q0, dq))
        else:
            dvel_abs = quat.rotate(aq, dvfb) + gravity * dt
            ap_new = ap + dt * av + 0.5 * dt * dvel_abs
            aq_new = quat.normalize(quat.mul(aq, quat.from_rotvec(dtheta)))
            rot = dq
        ds = ds + quat.rotate(rot, s_body)
        dvel_d = quat.rotate(rot, dvfb)
        av_new = av + dvel_abs
        dp = dp + dt * dv + 0.5 * dt * dvel_d
        dv = dv + dvel_d
        dq = quat.normalize(quat.mul(dq, quat.from_rotvec(dtheta)))

        # error-state propagation with the post-update attitude
        if with_earth:
            q_full = quat.mul(quat.mul(quat.conj(q0), quat.from_rotvec(-iewn * dt_new)), quat.mul(q0, dq))
            cbb, sign_gyro = -quat.to_matrix(q_full), -1.0
        else:
            cbb, sign_gyro = -quat.to_matrix(dq), 1.0
        phi, g = _phi_g_batch(params, dt, dth, dvl, cbb, sign_gyro, dsodo, stheta, sodo0)
        jac = phi @ jac
        cov = phi @ cov @ phi.T + _qk(phi, g, noise, dt)
        ap, aq, av, dt_tot, prev = ap_new, aq_new, av_new, dt_new, (dth, dvl)

    end_time = torch.max(torch.where(imu.dt > 0, imu.time, state0.time))
    return _summary(dt_tot, dp, dv, dq, ds, state0, jac, cov, gravity, iewn, sum_dtpn, ap, aq, av, end_time)


def preintegrate_odo(params: IntegrationParams, imu: ImuBatch, state0: NavState, *,
                     with_earth: bool, iewn=None):
    """Preintegrate a zero-padded IMU + wheel series (..., S) from absolute
    state0, as ``preintegration.preintegrate`` (sample 0 the anchor, padded
    samples exact no-ops, leading dims batch dims). Matches
    :func:`preintegrate_odo_seq` to f64 reassociation."""
    if imu.dt.shape[-1] <= 1:
        return preintegrate_odo_seq(params, imu, state0, with_earth=with_earth, iewn=iewn)
    ch = pre._chains(params, imu, state0, with_earth, iewn)
    ax = ch.ax
    sodo1 = state0.sodo.unsqueeze(ax)
    dsodo, s_body, stheta = _odo_terms(params, ch.dth, imu.odovel[..., 1:], sodo1)
    ds = torch.sum(quat.rotate(ch.rot_prev, s_body), dim=ax)
    phi, g = _phi_g_batch(params, ch.dt, ch.dth, ch.dvl, ch.cbb, ch.sign_gyro, dsodo, stheta, sodo1)
    noise = torch.diag(_noise_diag(params))
    jac, cov = pscan.phi_cov_reduce(phi, _qk(phi, g, noise, ch.dt), ax)
    dp, dv = pre._delta_integrals(ch)
    last = lambda x: x.select(ax, -1)  # noqa: E731
    return _summary(last(ch.dt_new), dp, dv, last(ch.dq_all), ds, state0, jac, cov, ch.gravity, ch.iewn,
                    ch.sum_dtpn, last(ch.ap_all), last(ch.aq_all), last(ch.av_all), ch.end_time)
