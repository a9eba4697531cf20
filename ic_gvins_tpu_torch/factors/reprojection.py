"""Inverse-depth two-frame reprojection factor with time-delay compensation.

Port of ``ic_gvins_tpu/factors/reprojection.py`` (parity target: IC-GVINS
``factors/reprojection_factor.h:36-158``): 2 residuals in the normalized
camera plane over {pose_ref[7], pose_obs[7], extrinsic[7], invdepth[1],
td[1]}, pixel velocities propagating the time delay. Analytic local
jacobians (2,6), (2,6), (2,6), (2,1), (2,1); every function broadcasts over
a leading factor-table axis.
"""

import torch

from ..core import quaternion as quat


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


def _chain(pose0, pose1, ext, invdepth, td, pts0, pts1, vel0, vel1, td0, td1):
    """Forward transform chain; intermediates for residual and jacobians."""
    p0, q0 = pose0[..., :3], pose0[..., 3:7]
    p1, q1 = pose1[..., :3], pose1[..., 3:7]
    tic, qic = ext[..., :3], ext[..., 3:7]
    pts0_td = pts0 - (td - td0)[..., None] * vel0
    pts1_td = pts1 - (td - td1)[..., None] * vel1
    pts_c0 = pts0_td / invdepth[..., None]
    pts_b0 = quat.rotate(qic, pts_c0) + tic
    pts_n = quat.rotate(q0, pts_b0) + p0
    pts_b1 = quat.rotate(quat.conj(q1), pts_n - p1)
    pts_c1 = quat.rotate(quat.conj(qic), pts_b1 - tic)
    return pts0_td, pts1_td, pts_c0, pts_b0, pts_n, pts_b1, pts_c1


def residual(pose0, pose1, ext, invdepth, td, pts0, pts1, vel0, vel1, td0, td1, sqrt_info):
    _, pts1_td, _, _, _, _, pts_c1 = _chain(pose0, pose1, ext, invdepth, td, pts0, pts1, vel0, vel1, td0, td1)
    r = pts_c1[..., :2] / pts_c1[..., 2:3] - pts1_td[..., :2]
    return sqrt_info * r


def jacobians(pose0, pose1, ext, invdepth, td, pts0, pts1, vel0, vel1, td0, td1, sqrt_info):
    """Analytic local jacobians (reprojection_factor.h:89-144)."""
    p0, q0 = pose0[..., :3], pose0[..., 3:7]
    p1, q1 = pose1[..., :3], pose1[..., 3:7]
    tic, qic = ext[..., :3], ext[..., 3:7]
    pts0_td, _, pts_c0, pts_b0, _, pts_b1, pts_c1 = _chain(
        pose0, pose1, ext, invdepth, td, pts0, pts1, vel0, vel1, td0, td1)
    d1 = pts_c1[..., 2]
    cb0n = quat.to_matrix(q0)
    cnb1 = quat.to_matrix(q1).transpose(-1, -2)
    cbc = quat.to_matrix(qic).transpose(-1, -2)
    zero = torch.zeros_like(d1)
    reduce = torch.stack([
        torch.stack([1.0 / d1, zero, -pts_c1[..., 0] / (d1 * d1)], dim=-1),
        torch.stack([zero, 1.0 / d1, -pts_c1[..., 1] / (d1 * d1)], dim=-1),
    ], dim=-2) * sqrt_info
    eye = torch.eye(3, dtype=d1.dtype, device=d1.device)

    cbc_cnb1 = cbc @ cnb1
    J0 = torch.cat([cbc_cnb1, -cbc_cnb1 @ cb0n @ quat.skew(pts_b0)], dim=-1)   # pose_ref
    J1 = torch.cat([-cbc_cnb1, cbc @ quat.skew(pts_b1)], dim=-1)               # pose_obs
    tmp_r = cbc_cnb1 @ cb0n @ cbc.transpose(-1, -2)
    Jext_t = cbc @ (cnb1 @ cb0n - eye)
    Jext_r = (-tmp_r @ quat.skew(pts_c0) + quat.skew(_mv(tmp_r, pts_c0))
              + quat.skew(_mv(cbc, _mv(cnb1, _mv(cb0n, tic) + p0 - p1) - tic)))
    Jext = torch.cat([Jext_t, Jext_r], dim=-1)                                 # extrinsic
    inv2 = (invdepth * invdepth)[..., None]
    Jid = (-_mv(reduce, _mv(tmp_r, pts0_td)) / inv2)[..., None]                # inverse depth
    Jtd = (-_mv(reduce, _mv(tmp_r, vel0)) / invdepth[..., None]
           + sqrt_info * vel1[..., :2])[..., None]                             # time delay
    return reduce @ J0, reduce @ J1, reduce @ Jext, Jid, Jtd
