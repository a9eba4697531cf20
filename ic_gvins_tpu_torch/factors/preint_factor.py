"""IMU preintegration factor: whitened residual + analytic local jacobians.

Port of ``ic_gvins_tpu/factors/preint_factor.py`` (parity targets: IC-GVINS
``preintegration_normal.cc:38-142`` and ``preintegration_earth.cc:37-164``).
15 residuals over the parameter blocks {pose0[7], mix0[9], pose1[7],
mix1[9]}. Jacobians come directly in LOCAL coordinates (6 for the pose
tangent, 9 for the mix block): the reference emits 7-column global
jacobians and lets Ceres' PoseParameterization drop the last column. All
functions broadcast over a leading factor-table axis.
"""

import torch

from ..core import quaternion as quat

NUM_RES = 15


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


def _lr_corner(a, b):
    """Bottom-right 3x3 block of L4(a) @ R4(b), the w-first quaternion
    left/right product matrices (rotation.h:103-119)."""
    return quat.left33(a) @ quat.right33(b) - a[..., :3, None] * b[..., None, :3]


def _corrected(summ, bg, ba):
    dbg = bg - summ.bg0
    dba = ba - summ.ba0
    cp = summ.dp + _mv(summ.dp_dba, dba) + _mv(summ.dp_dbg, dbg)
    cv = summ.dv + _mv(summ.dv_dba, dba) + _mv(summ.dv_dbg, dbg)
    cq = quat.mul(summ.dq, quat.from_rotvec(_mv(summ.dq_dbg, dbg)))
    return cp, cv, cq


def _deltas(summ, pose0, mix0, pose1, mix1, with_earth):
    """(dpn, dvn, qb0b1) of the residual: the n-frame position and velocity
    differences and, with earth, the relative attitude through qnn."""
    p0, q0, v0 = pose0[..., :3], pose0[..., 3:7], mix0[..., :3]
    p1, q1, v1 = pose1[..., :3], pose1[..., 3:7], mix1[..., :3]
    dt = summ.dt[..., None]
    g = summ.gravity
    dpn = p1 - p0 - v0 * dt - 0.5 * g * dt * dt
    dvn = v1 - v0 - g * dt
    if not with_earth:
        return dpn, dvn, None
    iewn_skew = quat.skew(summ.iewn)
    dpn = dpn + 2.0 * _mv(iewn_skew, summ.sum_dtpn - dt * p0)
    dvn = dvn + 2.0 * _mv(iewn_skew, p1 - p0)
    qnn = quat.from_rotvec(-summ.iewn * dt)
    return dpn, dvn, quat.mul(quat.conj(q1), quat.mul(qnn, q0))


def residual(summ, pose0, mix0, pose1, mix1, *, with_earth: bool):
    """Whitened 15-dim residual for one preintegration interval (or a table)."""
    q0, q1 = pose0[..., 3:7], pose1[..., 3:7]
    cp, cv, cq = _corrected(summ, mix0[..., 3:6], mix0[..., 6:9])
    dpn, dvn, qb0b1 = _deltas(summ, pose0, mix0, pose1, mix1, with_earth)
    r_p = quat.rotate(quat.conj(q0), dpn) - cp
    r_v = quat.rotate(quat.conj(q0), dvn) - cv
    if with_earth:
        r_q = 2.0 * quat.mul(qb0b1, cq)[..., :3]
    else:
        r_q = 2.0 * quat.mul(quat.conj(cq), quat.mul(quat.conj(q0), q1))[..., :3]
    r = torch.cat([r_p, r_v, r_q, mix1[..., 3:6] - mix0[..., 3:6], mix1[..., 6:9] - mix0[..., 6:9]], dim=-1)
    return _mv(summ.sqrt_info, r)


def jacobians(summ, pose0, mix0, pose1, mix1, *, with_earth: bool):
    """Analytic whitened local jacobians: (15,6), (15,9), (15,6), (15,9)."""
    q0, q1 = pose0[..., 3:7], pose1[..., 3:7]
    dt = summ.dt[..., None, None]
    _, _, cq = _corrected(summ, mix0[..., 3:6], mix0[..., 6:9])
    dpn, dvn, qb0b1 = _deltas(summ, pose0, mix0, pose1, mix1, with_earth)
    cnb0 = quat.to_matrix(quat.conj(q0))
    I3 = torch.eye(3, dtype=q0.dtype, device=q0.device)
    batch = q0.shape[:-1]
    # new_zeros: batched like q0 under torch.func.vmap, so the writes below stay legal there
    Jp0 = q0.new_zeros(batch + (NUM_RES, 6))
    Jm0 = q0.new_zeros(batch + (NUM_RES, 9))
    Jp1 = q0.new_zeros(batch + (NUM_RES, 6))
    Jm1 = q0.new_zeros(batch + (NUM_RES, 9))

    Jp0[..., 0:3, 3:6] = quat.skew(_mv(cnb0, dpn))
    Jp0[..., 3:6, 3:6] = quat.skew(_mv(cnb0, dvn))
    Jp1[..., 0:3, 0:3] = cnb0
    if with_earth:
        cnb0_iewn = cnb0 @ quat.skew(summ.iewn)
        Jp0[..., 0:3, 0:3] = -cnb0 - 2.0 * cnb0_iewn * dt
        Jp0[..., 3:6, 0:3] = -2.0 * cnb0_iewn
        Jp0[..., 6:9, 3:6] = _lr_corner(qb0b1, cq)
        Jp1[..., 3:6, 0:3] = 2.0 * cnb0_iewn
        Jp1[..., 6:9, 3:6] = -quat.right33(quat.mul(qb0b1, cq))
        rot_block_m0 = quat.left33(quat.mul(qb0b1, summ.dq)) @ summ.dq_dbg
    else:
        Jp0[..., 0:3, 0:3] = -cnb0
        Jp0[..., 6:9, 3:6] = -_lr_corner(quat.mul(quat.conj(q1), q0), cq)
        Jp1[..., 6:9, 3:6] = quat.left33(quat.mul(quat.conj(cq), quat.mul(quat.conj(q0), q1)))
        rot_block_m0 = -(quat.left33(quat.mul(quat.conj(q1), quat.mul(q0, summ.dq))) @ summ.dq_dbg)

    Jm0[..., 0:3, 0:3] = -cnb0 * dt
    Jm0[..., 0:3, 3:6] = -summ.dp_dbg
    Jm0[..., 0:3, 6:9] = -summ.dp_dba
    Jm0[..., 3:6, 0:3] = -cnb0
    Jm0[..., 3:6, 3:6] = -summ.dv_dbg
    Jm0[..., 3:6, 6:9] = -summ.dv_dba
    Jm0[..., 6:9, 3:6] = rot_block_m0
    Jm0[..., 9:12, 3:6] = -I3
    Jm0[..., 12:15, 6:9] = -I3
    Jm1[..., 3:6, 0:3] = cnb0
    Jm1[..., 9:12, 3:6] = I3
    Jm1[..., 12:15, 6:9] = I3

    U = summ.sqrt_info
    return U @ Jp0, U @ Jm0, U @ Jp1, U @ Jm1
