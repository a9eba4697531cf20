"""GNSS position factor and IMU prior/regularization factors.

Port of ``ic_gvins_tpu/factors/basic.py`` (parity targets: IC-GVINS
``factors/gnss_factor.h:31-71``, ``preintegration/imu_error_factor.h:30-94``,
``imu_pose_prior_factor.h:28-74``, ``imu_mix_prior_factor.h:28-81``).
Residuals are whitened; jacobians are analytic and LOCAL (6-dim pose
tangent). Functions broadcast over a leading factor-table axis.
"""

import math

import torch

from ..core import quaternion as quat

# Drift-bound soft priors (imu_error_factor.h:89-91)
IMU_GRY_BIAS_STD = 7200.0 / 3600.0 * math.pi / 180.0   # 7200 deg/hr in rad/s
IMU_ACC_BIAS_STD = 2.0e4 * 1.0e-5                      # 20000 mGal in m/s^2
ODO_SCALE_STD = 2.0e4 * 1.0e-6


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def gnss_residual(pose, blh_local, std, lever):
    """r = (p + R(q) lever - z) / std, 3-dim."""
    return (pose[..., :3] + quat.rotate(pose[..., 3:7], lever) - blh_local) / std


def gnss_jacobian(pose, std, lever):
    """(..., 3, 6) local jacobian (gnss_factor.h:58-67)."""
    q = pose[..., 3:7]
    Jr = -quat.to_matrix(q) @ quat.skew(lever)
    Jp = _eye(3, pose).expand(Jr.shape)
    return torch.cat([Jp, Jr], dim=-1) / std[..., :, None]


def imu_error_residual(mix):
    """Soft zero prior on the latest biases, 6-dim (imu_error_factor.h:45-66)."""
    return torch.cat([mix[..., 3:6] / IMU_GRY_BIAS_STD, mix[..., 6:9] / IMU_ACC_BIAS_STD], dim=-1)


def imu_error_jacobian(dtype=torch.float64, device=None):
    J = torch.zeros((6, 9), dtype=dtype, device=device)
    J[0:3, 3:6] = torch.eye(3, dtype=dtype, device=device) / IMU_GRY_BIAS_STD
    J[3:6, 6:9] = torch.eye(3, dtype=dtype, device=device) / IMU_ACC_BIAS_STD
    return J


def imu_error_residual_odo(mix):
    """7-dim odometer variant: biases + sodo/ODO_SCALE_STD
    (imu_error_factor.h:67-83); mix is the 10-dim [v, bg, ba, sodo] block."""
    return torch.cat([imu_error_residual(mix), mix[..., 9:10] / ODO_SCALE_STD], dim=-1)


def imu_error_jacobian_odo(dtype=torch.float64, device=None):
    J = torch.zeros((7, 10), dtype=dtype, device=device)
    J[:6, :9] = imu_error_jacobian(dtype, device)
    J[6, 9] = 1.0 / ODO_SCALE_STD
    return J


def pose_prior_residual(pose, pose_prior, std6):
    """6-dim pose prior: translation difference + quaternion-error attitude
    (imu_pose_prior_factor.h:42-55)."""
    dp = pose[..., :3] - pose_prior[..., :3]
    dq = quat.mul(quat.conj(pose[..., 3:7]), pose_prior[..., 3:7])
    return torch.cat([dp, 2.0 * dq[..., :3]], dim=-1) / std6


def pose_prior_jacobian(pose, pose_prior, std6):
    """(6, 6) local jacobian (imu_pose_prior_factor.h:57-65)."""
    dq = quat.mul(quat.conj(pose[..., 3:7]), pose_prior[..., 3:7])
    J = pose.new_zeros(pose.shape[:-1] + (6, 6))
    J[..., 0:3, 0:3] = _eye(3, pose)
    J[..., 3:6, 3:6] = -quat.right33(dq)
    return J / std6[..., :, None]


def mix_prior_residual(mix, mix_prior, std9):
    return (mix - mix_prior) / std9


def mix_prior_jacobian(std9):
    return torch.diag_embed(1.0 / std9)
