"""Host-side (pure numpy) rotation helpers for the replay bookkeeping path.

A carried-over copy of ``ic_gvins_tpu/core/rotation_np.py`` (parity target:
IC-GVINS ``common/rotation.h:35-119``). The port cannot import the JAX
package's copy: importing any ``ic_gvins_tpu`` module imports jax, which the
GPU machine does not have. Quaternions are xyzw; matrices follow the
Hamilton convention.
"""

import numpy as np


def to_matrix(q):
    """Quaternion (..., 4) xyzw -> rotation matrix (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty(q.shape[:-1] + (3, 3), np.float64)
    m[..., 0, 0] = 1 - 2 * (yy + zz)
    m[..., 0, 1] = 2 * (xy - wz)
    m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz)
    m[..., 1, 1] = 1 - 2 * (xx + zz)
    m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy)
    m[..., 2, 1] = 2 * (yz + wx)
    m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def from_matrix(m):
    """Rotation matrix (3, 3) -> quaternion (4,) xyzw (Shepperd's method,
    branch on the largest diagonal combination for stability)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] >= m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q if w >= 0 else -q


def matrix_to_euler(dcm):
    """DCM -> [roll, pitch, yaw] (ZYX, FRD; rotation.h:43-74).  pitch uses
    the -asin(m20) convention; roll/yaw from atan2 pairs."""
    dcm = np.asarray(dcm, np.float64)
    pitch = -np.arcsin(np.clip(dcm[2, 0], -1.0, 1.0))
    roll = np.arctan2(dcm[2, 1], dcm[2, 2])
    yaw = np.arctan2(dcm[1, 0], dcm[0, 0])
    return np.array([roll, pitch, yaw])


def rotate(q, v):
    """R(q) @ v without forming the matrix."""
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)
