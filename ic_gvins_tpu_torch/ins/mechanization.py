"""INS mechanization: earth-rotation-aware strapdown integration.

Port of ``ic_gvins_tpu/ins/mechanization.py`` (parity target:
MISC::insMechanization / redoInsMechanization, IC-GVINS
``misc.cc:151-261``): dual-sample coning/sculling compensation, optional
earth-rotation terms, bias compensation, average-velocity position update.
Zero-padded samples (dt = dtheta = dvel = 0) are exact no-ops.
``mechanize_scan`` is the log-depth prefix formulation;
``mechanize_scan_seq`` is its one-step-per-sample oracle.
"""

from typing import NamedTuple

import torch

from ..core import quaternion as quat
from ..core.types import ImuBatch, NavState
from . import parallel_scan as pscan


class MechConfig(NamedTuple):
    """Mechanization configuration (IntegrationConfiguration,
    integration_state.h:91-99); ``iswithearth`` is a Python bool."""

    gravity: torch.Tensor   # (3,) n-frame gravity vector [0, 0, g]; (..., 3) per world
    iewn: torch.Tensor      # (3,) earth rotation rate in n-frame; (..., 3) per world
    iswithearth: bool = True


def compensate(imu: ImuBatch, bg, ba) -> ImuBatch:
    """Remove bias from increment-form IMU samples (dt-scaled)."""
    return imu._replace(dtheta=imu.dtheta - imu.dt[..., None] * bg,
                        dvel=imu.dvel - imu.dt[..., None] * ba)


def mechanize_step(config: MechConfig, p, q, v, imu_pre, imu_cur):
    """One strapdown update. imu_pre/imu_cur = (dt, dtheta, dvel), already
    bias-compensated. Returns updated (p, q, v)."""
    dt_cur, dtheta_pre, dvel_pre, dtheta_cur, dvel_cur = (
        imu_cur[0], imu_pre[1], imu_pre[2], imu_cur[1], imu_cur[2])
    dvfb, dtheta = pscan.dual_sample(dtheta_cur, dvel_cur, dtheta_pre, dvel_pre)
    if config.iswithearth:
        dv_cor_g = (config.gravity - 2.0 * quat.cross(config.iewn, v)) * dt_cur
        qnn = quat.from_rotvec(-config.iewn * dt_cur)
        rot = quat.rotate(q, dvfb)
        dvel = 0.5 * (rot + quat.to_matrix(qnn) @ rot) + dv_cor_g
        q_new = quat.normalize(quat.mul(quat.mul(qnn, q), quat.from_rotvec(dtheta)))
    else:
        dvel = quat.rotate(q, dvfb) + config.gravity * dt_cur
        q_new = quat.normalize(quat.mul(q, quat.from_rotvec(dtheta)))
    p_new = p + dt_cur * v + 0.5 * dt_cur * dvel
    return p_new, q_new, v + dvel


def _prev0(state, imu_prev):
    if imu_prev is not None:
        return imu_prev
    z = torch.zeros_like(state.p)
    return (torch.zeros_like(state.time), z, z)


def mechanize_scan_seq(config: MechConfig, state: NavState, imu: ImuBatch, imu_prev=None):
    """One step per sample over an unbatched (S,) series: the oracle of
    :func:`mechanize_scan`. Returns (final NavState, (p, q, v) per sample)."""
    prev = _prev0(state, imu_prev)
    p, q, v = state.p, state.q, state.v
    traj = []
    for k in range(imu.dt.shape[0]):
        dt = imu.dt[k]
        cur = (dt, imu.dtheta[k] - dt * state.bg, imu.dvel[k] - dt * state.ba)
        p, q, v = mechanize_step(config, p, q, v, prev, cur)
        prev = cur
        traj.append((p, q, v))
    final_time = torch.max(torch.where(imu.dt > 0, imu.time, state.time))
    out = state._replace(time=final_time, p=p, q=q, v=v)
    return out, tuple(torch.stack(x) for x in zip(*traj))


def mechanize_scan(config: MechConfig, state: NavState, imu: ImuBatch, imu_prev=None):
    """Propagate a NavState through a padded IMU series (..., S).

    imu_prev: the sample immediately before imu[0] (dual-sample cross terms),
    zeros by default. Returns (final NavState, per-sample (p, q, v) of shape
    (..., S, k)); padded samples replicate the running state. With leading
    world dims, ``config.gravity`` and ``config.iewn`` may carry them too
    (each world its own gravity and earth rate). Quaternion
    prefix products carry the attitude, an affine (Coriolis) prefix the
    velocity, cumsums the position (misc.cc:151-206)."""
    _, pth, pdv = _prev0(state, imu_prev)
    ax = imu.dt.dim() - 1
    dt = imu.dt
    dt3 = dt[..., None]
    dth = imu.dtheta - dt3 * state.bg.unsqueeze(ax)
    dvl = imu.dvel - dt3 * state.ba.unsqueeze(ax)
    dvfb, dtheta = pscan.dual_sample(dth, dvl, pscan.shift_prev(dth, pth, ax),
                                     pscan.shift_prev(dvl, pdv, ax))
    dqs = quat.from_rotvec(dtheta)
    q0 = state.q.unsqueeze(ax)
    gravity, iewn = config.gravity.unsqueeze(-2), config.iewn.unsqueeze(-2)   # over the sample axis

    if config.iswithearth:
        qnn = quat.from_rotvec(-iewn * dt3)
        L, R = pscan.quat_sandwich_prefix(qnn, dqs, ax)
        q_all = quat.normalize(quat.mul(quat.mul(L, q0), R))
        rot = quat.rotate(pscan.shift_prev(q_all, state.q, ax), dvfb)
        # v_k = (I - 2 dt [iewn]x) v_{k-1} + c_k  (Coriolis affine map)
        c = 0.5 * (rot + (quat.to_matrix(qnn) @ rot[..., None])[..., 0]) + gravity * dt3
        eye = torch.eye(3, dtype=dt.dtype, device=dt.device)
        A = eye - 2.0 * dt[..., None, None] * quat.skew(iewn)
        P, cpf = pscan.affine_prefix(A, c, ax)
        v_all = (P @ state.v.unsqueeze(ax)[..., None])[..., 0] + cpf
    else:
        q_all = quat.normalize(quat.mul(q0, pscan.quat_prefix(dqs, ax)))
        dvel = quat.rotate(pscan.shift_prev(q_all, state.q, ax), dvfb) + gravity * dt3
        v_all = state.v.unsqueeze(ax) + torch.cumsum(dvel, dim=ax)

    v_prev = pscan.shift_prev(v_all, state.v, ax)
    # p_new = p + dt v + 0.5 dt (v_new - v) = p + 0.5 dt (v + v_new)
    p_all = state.p.unsqueeze(ax) + torch.cumsum(0.5 * dt3 * (v_prev + v_all), dim=ax)
    final_time = torch.amax(torch.where(dt > 0, imu.time, state.time[..., None]), dim=-1)
    out = state._replace(time=final_time, p=p_all.select(ax, -1), q=q_all.select(ax, -1),
                         v=v_all.select(ax, -1))
    return out, (p_all, q_all, v_all)


def interpolate_pose(p0, q0, t0, p1, q1, t1, t):
    """Linear position + slerp-equivalent attitude interpolation
    (MISC::statePoseInterpolation, misc.cc:85-100)."""
    s = (t - t0) / (t1 - t0)
    dq = quat.mul(quat.conj(q1), q0)  # q1^-1 * q0
    rvec = quat.to_rotvec(dq) * s
    q = quat.normalize(quat.mul(q0, quat.conj(quat.from_rotvec(rvec))))
    return p0 + (p1 - p0) * s, q


def state_to_camera_pose(p, q, tbc, Rbc):
    """Body state -> camera pose (misc.cc:102-108): (p + Rwb tbc, Rwb Rbc),
    over leading batch axes of p and q."""
    Rwb = quat.to_matrix(q)
    return p + Rwb @ tbc, Rwb @ Rbc


def detect_zero_velocity(dtheta, dvel, mask, imudatarate, gyr_threshold=0.002, acc_threshold=0.1):
    """Zero-velocity detection over a masked IMU window
    (MISC::detectZeroVelocity, misc.cc:363-415): per-axis std of the
    rate-form signals below the thresholds => stationary. Returns
    (is_zero_velocity, mean_dtheta (3,), mean_dvel (3,)) of the increments."""
    m = mask[..., None]
    n = torch.clamp(torch.sum(mask, dim=-1), min=1.0)[..., None]
    mean_th = torch.sum(dtheta * m, dim=-2) / n
    mean_dv = torch.sum(dvel * m, dim=-2) / n
    var_th = torch.sum((dtheta - mean_th[..., None, :]) ** 2 * m, dim=-2) / n
    var_dv = torch.sum((dvel - mean_dv[..., None, :]) ** 2 * m, dim=-2) / n
    std_th = torch.sqrt(var_th) * imudatarate
    std_dv = torch.sqrt(var_dv) * imudatarate
    is_zero = torch.all(std_th < gyr_threshold, dim=-1) & torch.all(std_dv < acc_threshold, dim=-1)
    return is_zero, mean_th, mean_dv


# Zero-velocity thresholds (misc.h:70-77)
ZERO_VELOCITY_GYR_THRESHOLD = 0.002  # rad/s
ZERO_VELOCITY_ACC_THRESHOLD = 0.1    # m/s^2
MINIMUM_TIME_INTERVAL = 1.0e-4
