"""IMU preintegration, NORMAL and EARTH variants.

Port of ``ic_gvins_tpu/ins/preintegration.py`` (parity targets: IC-GVINS
``preintegration_base.cc:39-102``, ``preintegration_normal.cc:183-254``,
``preintegration_earth.cc:205-334``): 15-dim error state (dp, dv, dq, dbg,
dba), 12-dim noise, dual-sample increments, trapezoidal noise propagation,
first-order Gauss-Markov biases; the EARTH variant compensates earth rotation
through the interval-start attitude q0 and the rate iewn and accumulates the
position-history sum(dt_k * p_k).

``preintegrate`` is the log-depth formulation over a zero-padded series and
broadcasts over leading batch dims (``preintegrate_batch`` is the batched
call); ``preintegrate_seq`` is its one-step-per-sample oracle. The result is
a :class:`PreintSummary`, all the factor layer needs about an interval.
"""

from typing import NamedTuple

import torch

from ..core import quaternion as quat
from ..core.types import ImuBatch, IntegrationParams, NavState
from . import parallel_scan as pscan

NUM_STATE = 15
NUM_NOISE = 12

# error-state slot offsets
_P, _V, _Q, _BG, _BA = 0, 3, 6, 9, 12


class PreintSummary(NamedTuple):
    """Everything the preintegration factor needs about one interval."""

    dt: torch.Tensor            # () total integration time
    dp: torch.Tensor            # (3,) delta position (body frame of start)
    dv: torch.Tensor            # (3,) delta velocity
    dq: torch.Tensor            # (4,) delta attitude quaternion (xyzw)
    bg0: torch.Tensor           # (3,) linearization gyro bias
    ba0: torch.Tensor           # (3,) linearization accel bias
    dp_dbg: torch.Tensor        # (3,3)
    dp_dba: torch.Tensor        # (3,3)
    dv_dbg: torch.Tensor        # (3,3)
    dv_dba: torch.Tensor        # (3,3)
    dq_dbg: torch.Tensor        # (3,3)
    sqrt_info: torch.Tensor     # (15,15) upper-tri whitener U with U^T U = cov^-1
    cov: torch.Tensor           # (15,15)
    gravity: torch.Tensor       # (3,) n-frame gravity vector
    iewn: torch.Tensor          # (3,) earth rate (zeros for NORMAL)
    sum_dtpn: torch.Tensor      # (3,) sum(dt_k * p_abs_k) (zeros for NORMAL)
    end_p: torch.Tensor         # (3,) absolute end position
    end_q: torch.Tensor         # (4,) absolute end attitude
    end_v: torch.Tensor         # (3,) absolute end velocity
    end_time: torch.Tensor      # () absolute end time


def _noise_diag(params: IntegrationParams):
    """Diagonal of the 12x12 continuous noise matrix
    (preintegration_normal.cc:246-254)."""
    nw = params.gyr_arw ** 2
    na = params.acc_vrw ** 2
    nbg = 2.0 * params.gyr_bias_std ** 2 / params.corr_time
    nba = 2.0 * params.acc_bias_std ** 2 / params.corr_time
    return torch.stack([nw, na, nbg, nba]).repeat_interleave(3)


def _phi_batch(dt, dth, dvl, cbb, corr_time):
    """State transition phi = I + F dt per sample, (..., 15, 15). cbb maps
    body increments into the delta-velocity error, signed as the reference
    (NORMAL: -R(dq), preintegration_normal.cc:198-232; EARTH: the negated
    earth-corrected rotation, preintegration_earth.cc:266-303)."""
    I3 = torch.eye(3, dtype=dt.dtype, device=dt.device)
    dtm = dt[..., None, None]
    gm = 1.0 - dtm / corr_time
    phi = torch.zeros(dt.shape + (NUM_STATE, NUM_STATE), dtype=dt.dtype, device=dt.device)
    phi[..., _P:_P + 3, _P:_P + 3] = I3
    phi[..., _P:_P + 3, _V:_V + 3] = I3 * dtm
    phi[..., _V:_V + 3, _V:_V + 3] = I3
    phi[..., _V:_V + 3, _Q:_Q + 3] = cbb @ quat.skew(dvl)
    phi[..., _V:_V + 3, _BA:_BA + 3] = cbb * dtm
    phi[..., _Q:_Q + 3, _Q:_Q + 3] = I3 - quat.skew(dth)
    phi[..., _Q:_Q + 3, _BG:_BG + 3] = -I3 * dtm
    phi[..., _BG:_BG + 3, _BG:_BG + 3] = I3 * gm
    phi[..., _BA:_BA + 3, _BA:_BA + 3] = I3 * gm
    return phi


def _g_batch(cbb, sign_gyro):
    """Noise input matrices G, (..., 15, 12)."""
    I3 = torch.eye(3, dtype=cbb.dtype, device=cbb.device)
    g = torch.zeros(cbb.shape[:-2] + (NUM_STATE, NUM_NOISE), dtype=cbb.dtype, device=cbb.device)
    g[..., _V:_V + 3, 3:6] = cbb
    g[..., _Q:_Q + 3, 0:3] = sign_gyro * I3
    g[..., _BG:_BG + 3, 6:9] = I3
    g[..., _BA:_BA + 3, 9:12] = I3
    return g


def _qk(phi, cbb, sign_gyro, noise, dt):
    g = _g_batch(cbb, sign_gyro)
    a = phi @ (g @ noise @ g.transpose(-1, -2))
    return 0.5 * dt[..., None, None] * (a + a.transpose(-1, -2))


def _whitener(cov):
    """(cov_sym, U): U upper-triangular with U^T U = cov^-1 (the reference
    forms LLT(cov^-1).L^T, preintegration_normal.cc:40-41). The ``_ex``
    forms: no error check, so no device read."""
    cov_sym = 0.5 * (cov + cov.transpose(-1, -2))
    info = torch.linalg.inv_ex(cov_sym)[0]
    L = torch.linalg.cholesky_ex(0.5 * (info + info.transpose(-1, -2)))[0]
    return cov_sym, L.transpose(-1, -2)


def _summary(dt, dp, dv, dq, bg0, ba0, jac, cov, gravity, iewn, sum_dtpn, end_p, end_q, end_v, end_time):
    cov_sym, sqrt_info = _whitener(cov)
    return PreintSummary(
        dt=dt, dp=dp, dv=dv, dq=dq, bg0=bg0, ba0=ba0,
        dp_dbg=jac[..., _P:_P + 3, _BG:_BG + 3], dp_dba=jac[..., _P:_P + 3, _BA:_BA + 3],
        dv_dbg=jac[..., _V:_V + 3, _BG:_BG + 3], dv_dba=jac[..., _V:_V + 3, _BA:_BA + 3],
        dq_dbg=jac[..., _Q:_Q + 3, _BG:_BG + 3],
        sqrt_info=sqrt_info, cov=cov_sym, gravity=gravity, iewn=iewn, sum_dtpn=sum_dtpn,
        end_p=end_p, end_q=end_q, end_v=end_v, end_time=end_time)


def preintegrate_seq(params: IntegrationParams, imu: ImuBatch, state0: NavState, *,
                     with_earth: bool, iewn=None):
    """One step per sample over an unbatched (S,) series: the oracle of
    :func:`preintegrate`."""
    f = dict(dtype=imu.dt.dtype, device=imu.dt.device)
    bg0, ba0, q0 = state0.bg, state0.ba, state0.q
    gravity = torch.tensor([0.0, 0.0, 1.0], **f) * params.gravity
    iewn = torch.zeros(3, **f) if iewn is None else iewn
    noise = torch.diag(_noise_diag(params))
    I3 = torch.eye(3, **f)

    dp, dv, dq = torch.zeros(3, **f), torch.zeros(3, **f), quat.identity(**f)
    ap, aq, av = state0.p, state0.q, state0.v
    jac, cov = torch.eye(NUM_STATE, **f), torch.zeros(NUM_STATE, NUM_STATE, **f)
    dt_tot, sum_dtpn = torch.zeros((), **f), torch.zeros(3, **f)
    prev = (imu.dtheta[0] - imu.dt[0] * bg0, imu.dvel[0] - imu.dt[0] * ba0)
    for k in range(1, imu.dt.shape[0]):
        dt = imu.dt[k]
        dth = imu.dtheta[k] - dt * bg0   # bias compensation at the frozen point
        dvl = imu.dvel[k] - dt * ba0
        dvfb, dtheta = pscan.dual_sample(dth, dvl, *prev)
        dt_new = dt_tot + dt
        if with_earth:
            # absolute state with earth terms (preintegration_earth.cc:216-242)
            dv_cor_g = (gravity - 2.0 * quat.cross(iewn, av)) * dt
            qnn = quat.from_rotvec(-iewn * dt)
            dvel_abs = 0.5 * ((I3 + quat.to_matrix(qnn)) @ quat.rotate(aq, dvfb)) + dv_cor_g
            ap_new = ap + dt * av + 0.5 * dt * dvel_abs
            aq_new = quat.normalize(quat.mul(quat.mul(qnn, aq), quat.from_rotvec(dtheta)))
            sum_dtpn = sum_dtpn + dt * ap_new
            # delta state through the mid-interval earth rotation
            q_mid = quat.mul(quat.mul(quat.conj(q0), quat.from_rotvec(-(dt_new - 0.5 * dt) * iewn)),
                             quat.mul(q0, dq))
            dvel_d = quat.rotate(q_mid, dvfb)
        else:
            dvel_abs = quat.rotate(aq, dvfb) + gravity * dt
            ap_new = ap + dt * av + 0.5 * dt * dvel_abs
            aq_new = quat.normalize(quat.mul(aq, quat.from_rotvec(dtheta)))
            dvel_d = quat.rotate(dq, dvfb)
        av_new = av + dvel_abs
        dp = dp + dt * dv + 0.5 * dt * dvel_d
        dv = dv + dvel_d
        dq = quat.normalize(quat.mul(dq, quat.from_rotvec(dtheta)))

        # error-state propagation (post-update attitude, as the reference)
        if with_earth:
            q_full = quat.mul(quat.mul(quat.conj(q0), quat.from_rotvec(-iewn * dt_new)), quat.mul(q0, dq))
            cbb, sign_gyro = -quat.to_matrix(q_full), -1.0
        else:
            cbb, sign_gyro = -quat.to_matrix(dq), 1.0
        phi = _phi_batch(dt, dth, dvl, cbb, params.corr_time)
        jac = phi @ jac
        cov = phi @ cov @ phi.T + _qk(phi, cbb, sign_gyro, noise, dt)
        ap, aq, av, dt_tot, prev = ap_new, aq_new, av_new, dt_new, (dth, dvl)

    end_time = torch.max(torch.where(imu.dt > 0, imu.time, state0.time))
    return _summary(dt_tot, dp, dv, dq, bg0, ba0, jac, cov, gravity, iewn, sum_dtpn, ap, aq, av, end_time)


class _Chains(NamedTuple):
    """Per-sample chains of one zero-padded series (..., S): the samples
    1..S-1 along the scan axis ``ax``."""

    ax: int
    dt: torch.Tensor         # (..., S-1)
    dth: torch.Tensor        # (..., S-1, 3) bias-compensated increments
    dvl: torch.Tensor
    dt_new: torch.Tensor     # (..., S-1) elapsed time after each sample
    dq_all: torch.Tensor     # (..., S-1, 4) delta attitude after each sample
    rot_prev: torch.Tensor   # (..., S-1, 4) the rotation of each sample's delta increments
    cbb: torch.Tensor        # (..., S-1, 3, 3) signed rotation of the error propagation
    sign_gyro: float
    dvel_d: torch.Tensor     # (..., S-1, 3) delta-velocity increments
    ap_all: torch.Tensor     # absolute position, attitude, velocity after each sample
    aq_all: torch.Tensor
    av_all: torch.Tensor
    gravity: torch.Tensor    # (..., 3)
    iewn: torch.Tensor       # (..., 3)
    sum_dtpn: torch.Tensor   # (..., 3)
    end_time: torch.Tensor   # (...)


def _chains(params: IntegrationParams, imu: ImuBatch, state0: NavState, with_earth, iewn):
    """The reference's per-sample loop (preintegration_base.cc:39-70) as
    quaternion prefix products for the delta/absolute attitudes, cumsums for
    the delta integrals and an affine prefix for the Coriolis velocity."""
    f = dict(dtype=imu.dt.dtype, device=imu.dt.device)
    ax = imu.dt.dim() - 1
    batch = imu.dt.shape[:-1]
    bg0, ba0, q0 = state0.bg, state0.ba, state0.q
    gravity = (torch.tensor([0.0, 0.0, 1.0], **f) * params.gravity).expand(batch + (3,))
    iewn = torch.zeros(batch + (3,), **f) if iewn is None else iewn
    g1 = gravity.unsqueeze(ax)
    iw1 = iewn.unsqueeze(ax)
    q01 = q0.unsqueeze(ax)

    dt = imu.dt[..., 1:]
    dt3 = dt[..., None]
    dth = imu.dtheta[..., 1:, :] - dt3 * bg0.unsqueeze(ax)
    dvl = imu.dvel[..., 1:, :] - dt3 * ba0.unsqueeze(ax)
    anchor_th = imu.dtheta[..., 0, :] - imu.dt[..., 0, None] * bg0
    anchor_dv = imu.dvel[..., 0, :] - imu.dt[..., 0, None] * ba0
    dvfb, dtheta = pscan.dual_sample(dth, dvl, pscan.shift_prev(dth, anchor_th, ax),
                                     pscan.shift_prev(dvl, anchor_dv, ax))
    dqs = quat.from_rotvec(dtheta)
    dt_new = torch.cumsum(dt, dim=ax)

    # delta attitude chain (earth rotation lives OUTSIDE the delta, as in
    # preintegration_earth.cc's q_mid/q_full construction)
    pre = pscan.quat_prefix(dqs, ax)
    dq_all = quat.normalize(pre)
    dq_prev = pscan.shift_prev(dq_all, quat.identity(**f).expand(batch + (4,)), ax)

    if with_earth:
        qnn = quat.from_rotvec(-iw1 * dt3)
        L, R = pscan.quat_sandwich_prefix(qnn, dqs, ax)
        aq_all = quat.normalize(quat.mul(quat.mul(L, q01), R))
        rot = quat.rotate(pscan.shift_prev(aq_all, q0, ax), dvfb)
        c = 0.5 * (rot + (quat.to_matrix(qnn) @ rot[..., None])[..., 0]) + g1 * dt3
        A = torch.eye(3, **f) - 2.0 * dt[..., None, None] * quat.skew(iw1)
        P, cpf = pscan.affine_prefix(A, c, ax)
        av_all = (P @ state0.v.unsqueeze(ax)[..., None])[..., 0] + cpf
        av_prev = pscan.shift_prev(av_all, state0.v, ax)
        ap_all = state0.p.unsqueeze(ax) + torch.cumsum(0.5 * dt3 * (av_prev + av_all), dim=ax)
        sum_dtpn = torch.sum(dt3 * ap_all, dim=ax)

        # delta integrals through the mid-interval earth rotation
        rot_prev = quat.mul(quat.mul(quat.conj(q01), quat.from_rotvec(-(dt_new - 0.5 * dt)[..., None] * iw1)),
                            quat.mul(q01, dq_prev))
        q_full = quat.mul(quat.mul(quat.conj(q01), quat.from_rotvec(-dt_new[..., None] * iw1)),
                          quat.mul(q01, dq_all))
        cbb, sign_gyro = -quat.to_matrix(q_full), -1.0
    else:
        aq_all = quat.normalize(quat.mul(q01, pre))
        dvel_abs = quat.rotate(pscan.shift_prev(aq_all, q0, ax), dvfb) + g1 * dt3
        av_all = state0.v.unsqueeze(ax) + torch.cumsum(dvel_abs, dim=ax)
        av_prev = pscan.shift_prev(av_all, state0.v, ax)
        ap_all = state0.p.unsqueeze(ax) + torch.cumsum(0.5 * dt3 * (av_prev + av_all), dim=ax)
        sum_dtpn = torch.zeros(batch + (3,), **f)
        rot_prev = dq_prev
        cbb, sign_gyro = -quat.to_matrix(dq_all), 1.0

    end_time = torch.amax(torch.where(imu.dt > 0, imu.time, state0.time[..., None]), dim=-1)
    return _Chains(ax=ax, dt=dt, dth=dth, dvl=dvl, dt_new=dt_new, dq_all=dq_all, rot_prev=rot_prev, cbb=cbb,
                   sign_gyro=sign_gyro, dvel_d=quat.rotate(rot_prev, dvfb), ap_all=ap_all, aq_all=aq_all,
                   av_all=av_all, gravity=gravity, iewn=iewn, sum_dtpn=sum_dtpn, end_time=end_time)


def _delta_integrals(ch: _Chains):
    """(dp, dv) at the series' end from the delta-velocity increments."""
    ax = ch.ax
    dv_all = torch.cumsum(ch.dvel_d, dim=ax)
    dv_prev = pscan.shift_prev(dv_all, torch.zeros_like(dv_all.select(ax, 0)), ax)
    dp_all = torch.cumsum(0.5 * ch.dt[..., None] * (dv_prev + dv_all), dim=ax)
    return dp_all.select(ax, -1), dv_all.select(ax, -1)


def preintegrate(params: IntegrationParams, imu: ImuBatch, state0: NavState, *,
                 with_earth: bool, iewn=None):
    """Preintegrate a zero-padded IMU series (..., S) from absolute state0.

    imu[..., 0] is the anchor sample (NOT integrated: it carries the
    dual-sample history, imu_buffer_[0] in the reference); samples 1..S-1
    with dt > 0 are integrated. Biases are frozen at state0.bg/ba. Leading
    dims of (imu, state0, iewn) are batch dims.

    The per-sample loop becomes the prefix chains of :func:`_chains` and a
    tree reduction of the (Phi, Q) pairs for the covariance and bias
    jacobians. Matches :func:`preintegrate_seq` to f64 reassociation."""
    if imu.dt.shape[-1] <= 1:
        return preintegrate_seq(params, imu, state0, with_earth=with_earth, iewn=iewn)
    ch = _chains(params, imu, state0, with_earth, iewn)
    noise = torch.diag(_noise_diag(params))
    phi = _phi_batch(ch.dt, ch.dth, ch.dvl, ch.cbb, params.corr_time)
    jac, cov = pscan.phi_cov_reduce(phi, _qk(phi, ch.cbb, ch.sign_gyro, noise, ch.dt), ch.ax)
    dp, dv = _delta_integrals(ch)
    last = lambda x: x.select(ch.ax, -1)  # noqa: E731
    return _summary(last(ch.dt_new), dp, dv, last(ch.dq_all), state0.bg, state0.ba, jac, cov, ch.gravity,
                    ch.iewn, ch.sum_dtpn, last(ch.ap_all), last(ch.aq_all), last(ch.av_all), ch.end_time)


def preintegrate_batch(params, imu_batch, states0, *, with_earth, iewn_batch=None):
    """Preintegrate a leading interval axis in one call: imu_batch (N, S),
    states0 with leading (N,), iewn_batch (N, 3) or None. One call
    reintegrates a whole sliding window."""
    return preintegrate(params, imu_batch, states0, with_earth=with_earth, iewn=iewn_batch)
