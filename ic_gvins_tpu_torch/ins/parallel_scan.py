"""Log-depth prefix-scan primitives for INS recurrences.

Port of ``ic_gvins_tpu/ins/parallel_scan.py``. Every INS recurrence is an
associative composition (attitude: quaternion prefix products; velocity with
Coriolis: an affine prefix; covariance and bias jacobian: the (Phi, Q) pair),
so a window of S samples runs as ~log2(S) doubling rounds of batched tensor
ops instead of S dependent steps: on the card a 256-sample chunk is 8 rounds
of a few launches each. ``associative_scan`` is the Hillis-Steele inclusive
scan; ``phi_cov_reduce`` needs only the total and runs a pairwise tree
reduction (O(S) work). Both reassociate the sums: results match the
sequential oracles to f64 rounding (tests hold them).
"""

import torch

from ..core import quaternion as quat


def _take(x, axis, start, length=None, step=1):
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, None if length is None else start + length, step)
    return x[tuple(idx)]


def associative_scan(fn, elems, axis=0):
    """Inclusive scan of the tuple ``elems`` (tensors sharing the scan axis
    ``axis``, counted from the front) under ``fn(earlier, later)``, which
    combines two tuples elementwise along that axis."""
    out = tuple(elems)
    n = out[0].shape[axis]
    k = 1
    while k < n:
        comb = fn(tuple(_take(x, axis, 0, n - k) for x in out),
                  tuple(_take(x, axis, k) for x in out))
        out = tuple(torch.cat([_take(x, axis, 0, k), c], dim=axis) for x, c in zip(out, comb))
        k *= 2
    return out


def quat_prefix(dqs, axis=0):
    """Prefix products P_k = dq_0 (X) ... (X) dq_k of (..., S, 4) quaternions
    (right-accumulating, matching q_new = mul(q, dq))."""
    return associative_scan(lambda a, b: (quat.mul(a[0], b[0]),), (dqs,), axis)[0]


def quat_sandwich_prefix(lqs, rqs, axis=0):
    """Prefix composition of maps T_k(x) = l_k (X) x (X) r_k:
    (T_b o T_a)(x) = (l_b l_a) x (r_a r_b); returns (L_k, R_k) with
    q_k = L_k (X) q_0 (X) R_k (the earth-rotation attitude update
    q_k = qnn_k (X) q_{k-1} (X) dq_k, misc.cc:186-189)."""
    return associative_scan(lambda a, b: (quat.mul(b[0], a[0]), quat.mul(a[1], b[1])),
                            (lqs, rqs), axis)


def affine_prefix(A, b, axis=0):
    """Prefix composition of x -> A_k x + b_k over (..., S, 3, 3) / (..., S, 3):
    returns (P_k, c_k) with v_k = P_k v_0 + c_k."""
    def combine(first, second):
        A1, b1 = first
        A2, b2 = second
        return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2

    return associative_scan(combine, (A, b), axis)


def phi_cov_reduce(phi, qk, axis=0):
    """Final (J, P) of J_k = Phi_k J_{k-1} (J_0 = I) and
    P_k = Phi_k P_{k-1} Phi_k^T + Q_k (P_0 = 0) over (..., S, D, D) inputs.
    The pair composes associatively,
    (Phi2, Q2) o (Phi1, Q1) = (Phi2 Phi1, Phi2 Q1 Phi2^T + Q2),
    and (I, 0) is its identity; reduced pairwise, earlier on the left."""
    D = phi.shape[-1]
    while phi.shape[axis] > 1:
        if phi.shape[axis] % 2:
            shape = list(phi.shape)
            shape[axis] = 1
            eye = torch.eye(D, dtype=phi.dtype, device=phi.device).expand(shape)
            phi = torch.cat([phi, eye], dim=axis)
            qk = torch.cat([qk, torch.zeros_like(eye)], dim=axis)
        p1, q1 = _take(phi, axis, 0, step=2), _take(qk, axis, 0, step=2)
        p2, q2 = _take(phi, axis, 1, step=2), _take(qk, axis, 1, step=2)
        phi = p2 @ p1
        qk = p2 @ q1 @ p2.transpose(-1, -2) + q2
    return phi.squeeze(axis), qk.squeeze(axis)


def shift_prev(arr, first, axis=0):
    """arr[k-1] with arr[-1] := first: the dual-sample history chain
    (imu_pre in misc.cc:160-168) as a shifted array."""
    return torch.cat([first.unsqueeze(axis), _take(arr, axis, 0, arr.shape[axis] - 1)], dim=axis)


def dual_sample(dth, dvl, dth_pre, dvl_pre):
    """Batched dual-sample coning/sculling compensation
    (misc.cc:160-173, preintegration_base.cc:44-56)."""
    dvfb = dvl + 0.5 * quat.cross(dth, dvl) + (quat.cross(dth_pre, dvl) + quat.cross(dvl_pre, dth)) / 12.0
    dtheta = dth + quat.cross(dth_pre, dth) / 12.0
    return dvfb, dtheta
