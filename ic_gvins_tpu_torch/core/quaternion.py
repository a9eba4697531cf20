"""Quaternion / rotation utilities (Hamilton convention, xyzw storage).

Port of ``ic_gvins_tpu/core/quaternion.py`` (parity target: IC-GVINS
``common/rotation.h:35-119``): ZYX euler (front-right-down IMU, RPY out),
rotation-vector exp/log maps, skew matrices, and the 3x3 corner blocks of the
quaternion left/right product matrices used by the analytic jacobians.

Every function broadcasts over leading batch dims (the JAX twin's ``vmap``)
and keeps its inputs' dtype and device; the estimator passes float64.
"""

import functools
import math

import torch

_EPS = 1e-12


def identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def _structure():
    """Constant tensors of the bilinear/quadratic maps below, as float64:
    MUL (4, 16): q1 ⊗ q2 = MUL @ vec(q1 q2ᵀ); ROT (16, 9): R(q) = I +
    vec(q qᵀ) @ ROT for unit q; SKEW (3, 9): [v]x = v @ SKEW; CONJ (4,);
    EYE3 (3, 3)."""
    x, y, z, w = range(4)
    mul = torch.zeros(4, 4, 4, dtype=torch.float64)
    for out, terms in enumerate((
            ((w, x, 1), (x, w, 1), (y, z, 1), (z, y, -1)),
            ((w, y, 1), (x, z, -1), (y, w, 1), (z, x, 1)),
            ((w, z, 1), (x, y, 1), (y, x, -1), (z, w, 1)),
            ((w, w, 1), (x, x, -1), (y, y, -1), (z, z, -1)))):
        for i, j, sign in terms:
            mul[out, i, j] = sign
    rot = torch.zeros(4, 4, 3, 3, dtype=torch.float64)
    for (r, c), terms in {
            (0, 0): ((y, y, -2), (z, z, -2)), (0, 1): ((x, y, 2), (w, z, -2)), (0, 2): ((x, z, 2), (w, y, 2)),
            (1, 0): ((x, y, 2), (w, z, 2)), (1, 1): ((x, x, -2), (z, z, -2)), (1, 2): ((y, z, 2), (w, x, -2)),
            (2, 0): ((x, z, 2), (w, y, -2)), (2, 1): ((y, z, 2), (w, x, 2)), (2, 2): ((x, x, -2), (y, y, -2))}.items():
        for i, j, coef in terms:
            rot[i, j, r, c] = coef
    skew = torch.zeros(3, 3, 3, dtype=torch.float64)
    for k, (r, c) in enumerate(((2, 1), (0, 2), (1, 0))):
        skew[k, r, c], skew[k, c, r] = 1.0, -1.0
    return dict(mul=mul.reshape(4, 16), rot=rot.reshape(16, 9), skew=skew.reshape(3, 9),
                conj=torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=torch.float64),
                eye3=torch.eye(3, dtype=torch.float64))


_STRUCTURE = _structure()


@functools.lru_cache(maxsize=None)
def _const(name, dtype, device):
    """The constant ``name`` in ``dtype`` on ``device``, copied there once."""
    return _STRUCTURE[name].to(dtype=dtype, device=device)


def _c(name, like):
    return _const(name, like.dtype, like.device)


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def mul(q1, q2):
    """Hamilton product q1 ⊗ q2, xyzw layout: one outer product and one
    matrix product against the product's structure constants (few launches
    on the card, where each small op costs more to launch than to run)."""
    q1, q2 = torch.broadcast_tensors(q1, q2)
    outer = (q1[..., :, None] * q2[..., None, :]).reshape(*q1.shape[:-1], 16)
    return outer @ _c("mul", q1).T


def conj(q):
    return q * _c("conj", q)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q, v):
    """Rotate vector(s) v by quaternion q (R(q) @ v)."""
    return (to_matrix(q) @ v[..., None])[..., 0]


def to_matrix(q):
    """Rotation matrix from a unit quaternion (xyzw): I + the quadratic form
    of rotation.h's expansion (1 - 2(yy+zz), 2(xy - wz), ...)."""
    outer = (q[..., :, None] * q[..., None, :]).reshape(*q.shape[:-1], 16)
    return (outer @ _c("rot", q)).reshape(*q.shape[:-1], 3, 3) + _c("eye3", q)


def from_matrix(m):
    """Quaternion (xyzw) from rotation matrix (Shepperd's method, branchless:
    all four pivot constructions, the largest pivot selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    piv = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    s = torch.sqrt(torch.clamp(piv, min=_EPS))  # s_k = 2*|q_k|
    s0, s1, s2, s3 = s.unbind(-1)
    cands = torch.stack(
        [
            torch.stack([(m21 - m12) / (2 * s0), (m02 - m20) / (2 * s0), (m10 - m01) / (2 * s0), 0.5 * s0], -1),
            torch.stack([0.5 * s1, (m01 + m10) / (2 * s1), (m02 + m20) / (2 * s1), (m21 - m12) / (2 * s1)], -1),
            torch.stack([(m01 + m10) / (2 * s2), 0.5 * s2, (m12 + m21) / (2 * s2), (m02 - m20) / (2 * s2)], -1),
            torch.stack([(m02 + m20) / (2 * s3), (m12 + m21) / (2 * s3), 0.5 * s3, (m10 - m01) / (2 * s3)], -1),
        ],
        dim=-2,
    )
    idx = torch.argmax(piv, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4)).squeeze(-2)
    q = torch.where(q[..., 3:4] < 0, -q, q)  # canonical sign: w >= 0
    return normalize(q)


def from_rotvec(rv):
    """Exp map: rotation vector -> quaternion (xyzw), small-angle safe."""
    angle2 = torch.sum(rv * rv, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=_EPS * _EPS))
    half = 0.5 * angle
    small = angle2 < 1e-16
    # sin(x/2)/x, guarded for tiny angles with its taylor series
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return torch.cat([rv * k, w], dim=-1)


def to_rotvec(q):
    """Log map: quaternion -> rotation vector, small-angle safe."""
    q = torch.where(q[..., 3:4] < 0, -q, q)  # shortest arc
    vnorm = torch.linalg.vector_norm(q[..., :3], dim=-1, keepdim=True)
    w = q[..., 3:4]
    angle = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-9
    scale = torch.where(small, 2.0 / torch.clamp(w, min=0.5), angle / torch.clamp(vnorm, min=_EPS))
    return q[..., :3] * scale


def skew(v):
    """Skew-symmetric matrix [v]x; batched over leading dims."""
    return (v @ _c("skew", v)).reshape(*v.shape[:-1], 3, 3)


def left33(q):
    """Bottom-right 3x3 of the quaternion left-product matrix: w*I + [v]x
    (Rotation::quaternionleft, rotation.h:103-110)."""
    return q[..., 3, None, None] * _c("eye3", q) + skew(q[..., :3])


def right33(q):
    """Bottom-right 3x3 of the quaternion right-product matrix: w*I - [v]x."""
    return q[..., 3, None, None] * _c("eye3", q) - skew(q[..., :3])


def euler_to_matrix(euler):
    """ZYX euler (roll, pitch, yaw) -> C_b^n (rotation.h:84-88)."""
    r, p, y = euler.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cp * cy, sr * sp * cy - cr * sy, cr * sp * cy + sr * sy], dim=-1)
    row1 = torch.stack([cp * sy, sr * sp * sy + cr * cy, cr * sp * sy - sr * cy], dim=-1)
    row2 = torch.stack([-sp, sr * cp, cr * cp], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def euler_to_quat(euler):
    return from_matrix(euler_to_matrix(euler))


def matrix_to_euler(dcm):
    """C_b^n -> RPY, ZYX order, heading in [0, 2pi) (rotation.h:44-66), with
    the reference's gimbal-lock branches as selects."""
    pitch = torch.atan(-dcm[..., 2, 0] / torch.sqrt(dcm[..., 2, 1] ** 2 + dcm[..., 2, 2] ** 2))
    roll = torch.atan2(dcm[..., 2, 1], dcm[..., 2, 2])
    yaw_normal = torch.atan2(dcm[..., 1, 0], dcm[..., 0, 0])
    yaw_lock_neg = torch.atan2(dcm[..., 1, 2] - dcm[..., 0, 1], dcm[..., 0, 2] + dcm[..., 1, 1])
    yaw_lock_pos = math.pi + torch.atan2(dcm[..., 1, 2] + dcm[..., 0, 1], dcm[..., 0, 2] - dcm[..., 1, 1])
    yaw = torch.where(dcm[..., 2, 0] <= -0.999, yaw_lock_neg, yaw_normal)
    yaw = torch.where(dcm[..., 2, 0] >= 0.999, yaw_lock_pos, yaw)
    yaw = torch.where(yaw < 0, 2.0 * math.pi + yaw, yaw)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_euler(q):
    return matrix_to_euler(to_matrix(q))


def boxplus_pose(pose, delta):
    """Right-multiplicative SO(3)xR3 update on a pose[7] block:
    p' = p + dp; q' = q * exp(dtheta) (pose_parameterization.h:34-49)."""
    p = pose[..., :3] + delta[..., :3]
    q = normalize(mul(pose[..., 3:7], from_rotvec(delta[..., 3:6])))
    return torch.cat([p, q], dim=-1)


def boxminus_pose(pose, pose0):
    """Local difference of the marginalization prior replay
    (marginalization_factor.h:63-75): dp = p - p0, dq = 2*vec(q0^-1 q), sign
    flipped when w < 0."""
    dp = pose[..., :3] - pose0[..., :3]
    dq = mul(conj(pose0[..., 3:7]), pose[..., 3:7])
    dtheta = 2.0 * dq[..., :3]
    dtheta = torch.where(dq[..., 3:4] < 0, -dtheta, dtheta)
    return torch.cat([dp, dtheta], dim=-1)
