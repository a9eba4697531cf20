"""Fundamental-matrix RANSAC + two-view triangulation, fully batched.

Twin of ``ic_gvins_tpu/vision/ransac.py``. Replaces cv::findFundamentalMat
(FM_RANSAC, thresh, 0.99) culling (tracking.cc:547-555) and the per-point
DLT triangulation (tracking.cc:800-811).

A fixed budget of hypotheses is evaluated at once: each solves the
normalized 8-point system, Sampson distances for all correspondences x all
hypotheses come from one batched product, and the best hypothesis is an
argmax. Hartley normalization and triangulation run in f64; everything
after normalization runs in f32, as in the reference. The hypothesis
sample table comes from ``_draw_samples`` with an explicit host
``torch.Generator`` seeded per call, so a call is deterministic and CPU and
CUDA runs draw the same table. It cannot
reproduce ``jax.random``'s stream; parity tests substitute the reference's
table there. The 8x8 solve and the 3x3 eigenvector follow the reference's
closed forms, so that the same table gives the same inlier mask.
``fundamental_ransac`` also takes a leading world axis (the JAX package's
vmap over worlds in ``parallel/mesh.py``): every world draws, on the host,
the table its own call would draw.
"""

import math

import torch


def _normalize(pts, valid):
    n = torch.clamp(torch.sum(valid, dim=-1), min=1.0)[..., None]
    mean = torch.sum(pts * valid[..., None], dim=-2) / n
    d = torch.linalg.vector_norm(pts - mean[..., None, :], dim=-1) * valid
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d, dim=-1, keepdim=True) / n, min=1e-9)
    return (pts - mean[..., None, :]) * scale[..., None], scale[..., 0]


def _draw_samples(valid, num_hyp, generator):
    """(num_hyp, 8) indices drawn with replacement from the valid entries,
    on the host ``generator``, so CPU and CUDA runs draw the same table."""
    valid = valid.cpu()
    probs = valid / torch.clamp(torch.sum(valid), min=1.0)
    idx = torch.multinomial(probs, num_hyp * 8, replacement=True, generator=generator)
    return idx.reshape(num_hyp, 8)


def _gauss_jordan_solve(B, n):
    """Reduce the batched augmented system B (..., n, n+1) to [I | x] by
    Gauss-Jordan elimination with partial pivoting (first-index pivot ties,
    as the reference). Returns x (..., n)."""
    M = B
    rows = torch.arange(n, device=B.device)
    for k in range(n):
        col = torch.abs(M[..., :, k])
        col = torch.where(rows >= k, col, torch.full_like(col, -1.0))
        p = torch.argmax(col, dim=-1)
        oh = (rows == p[..., None]).to(M.dtype)
        prow = torch.sum(M * oh[..., None], dim=-2)
        rowk = M[..., k, :]
        M = M - oh[..., None] * (prow - rowk)[..., None, :]
        piv = prow[..., k]
        prow = prow / torch.where(torch.abs(piv) > 1e-30, piv, torch.ones_like(piv))[..., None]
        fac = torch.where(rows != k, M[..., :, k], torch.zeros_like(M[..., :, k]))
        M = M - fac[..., None] * prow[..., None, :]
        M[..., k, :] = prow  # M is a fresh tensor here: the write touches no input
    return M[..., :, n]


def _sym3_smallest_eigvec(M):
    """Closed-form unit eigenvector of the smallest eigenvalue of a
    symmetric (..., 3, 3) matrix (trigonometric eigenvalue formula + row
    cross products)."""
    m00, m11, m22 = M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]
    m01, m02, m12 = M[..., 0, 1], M[..., 0, 2], M[..., 1, 2]
    tiny = torch.finfo(M.dtype).tiny
    q = (m00 + m11 + m22) / 3.0
    p1 = m01 * m01 + m02 * m02 + m12 * m12
    p2 = (m00 - q) * (m00 - q) + (m11 - q) * (m11 - q) + (m22 - q) * (m22 - q) + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=tiny))
    d0, d1, d2 = (m00 - q) / p, (m11 - q) / p, (m22 - q) / p
    b01, b02, b12 = m01 / p, m02 / p, m12 / p
    detB = (
        d0 * (d1 * d2 - b12 * b12)
        - b01 * (b01 * d2 - b12 * b02)
        + b02 * (b01 * b12 - d1 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    C = M - lmin[..., None, None] * torch.eye(3, dtype=M.dtype, device=M.device)
    c01 = torch.linalg.cross(C[..., 0, :], C[..., 1, :])
    c02 = torch.linalg.cross(C[..., 0, :], C[..., 2, :])
    c12 = torch.linalg.cross(C[..., 1, :], C[..., 2, :])
    cands = torch.stack([c01, c02, c12], dim=-2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    oh = (torch.arange(3, device=M.device) == best[..., None]).to(M.dtype)
    v = torch.sum(cands * oh[..., None], dim=-2)
    nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    return torch.where(nv > 1e-30, v / torch.clamp(nv, min=tiny), e0)


def _eight_point(p0, p1):
    """F per hypothesis from 8 normalized correspondences (H, 8, 2) each:
    the f33=1 nullspace by Gauss-Jordan on the 8x8 system + closed-form
    rank-2 projection. Returns (H, 3, 3)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    A = torch.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], dim=-1
    )
    B = torch.cat([A[..., :8], -A[..., 8:]], dim=-1)
    f8 = _gauss_jordan_solve(B, 8)
    F = torch.cat([f8, torch.ones_like(f8[..., :1])], dim=-1).reshape(f8.shape[:-1] + (3, 3))
    # rank-2 enforcement: subtract the smallest singular triplet
    v3 = _sym3_smallest_eigvec(F.transpose(-1, -2) @ F)
    Fv = torch.einsum("...ij,...j->...i", F, v3)
    return F - Fv[..., :, None] * v3[..., None, :]


def fundamental_ransac(pts0, pts1, valid, threshold, num_hyp=256, seed=0):
    """RANSAC F-matrix inlier mask over a padded correspondence table.

    pts0/pts1: (N,2) f64 undistorted pixels; valid: (N,) f64 0/1;
    threshold: inlier threshold in pixels (reprojection_error_std).
    Returns (inlier_mask (N,) bool, best_inlier_count). With a leading
    world axis on pts0, pts1 and valid, both results gain it; world b's
    table is the one its own call draws (a generator seeded ``seed``)."""
    validb = valid > 0
    lead = valid.shape[:-1]

    n0, s0 = _normalize(pts0, valid)
    n1, s1 = _normalize(pts1, valid)
    n0 = n0.to(torch.float32)
    n1 = n1.to(torch.float32)

    if lead:   # one host read of every world's valid, then each world's own draw
        host_valid = valid.cpu()
        samples = torch.stack([_draw_samples(v, num_hyp, torch.Generator().manual_seed(seed))
                               for v in host_valid]).to(pts0.device)
        world = torch.arange(lead[0], device=pts0.device)[:, None, None]
        Fs = _eight_point(n0[world, samples], n1[world, samples])   # (B, H, 3, 3)
    else:
        samples = _draw_samples(valid, num_hyp, torch.Generator().manual_seed(seed)).to(pts0.device)
        Fs = _eight_point(n0[samples], n1[samples])                  # (H, 3, 3)

    ones = torch.ones(n0.shape[:-1] + (1,), dtype=n0.dtype, device=n0.device)
    p0h = torch.cat([n0, ones], dim=-1)
    p1h = torch.cat([n1, ones], dim=-1)
    Fx0 = torch.einsum("...nj,...hij->...hni", p0h, Fs)          # F @ x0
    Ftx1 = torch.einsum("...nj,...hji->...hni", p1h, Fs)         # F^T @ x1
    num = torch.sum(p1h[..., None, :, :] * Fx0, dim=-1)
    num = num * num
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    d = num / torch.clamp(den, min=1e-12)                        # (..., H, N) Sampson

    # threshold in normalized coords: scale by the normalization factors
    thr2 = ((threshold ** 2) * (s0 * s1)).to(d.dtype)[..., None, None]
    inliers = (d < thr2) & validb[..., None, :]
    counts = torch.sum(inliers, dim=-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    mask = torch.take_along_dim(inliers, best[..., None], dim=-2)[..., 0, :]
    return mask | ~validb, torch.take_along_dim(counts, best, dim=-1)[..., 0]


def triangulate(Rcw0, tcw0, Rcw1, tcw1, pc0, pc1):
    """Batched DLT triangulation from two views (tracking.cc:800-811).

    Rcw/tcw: world->camera rotation (M,3,3) / translation (M,3); pc:
    normalized plane coords (M,3) with z=1. Least squares with the X4=1
    gauge: 3x3 normal equations solved by the adjugate. Returns pw (M,3)."""
    P0 = torch.cat([Rcw0, tcw0[..., None]], dim=-1)
    P1 = torch.cat([Rcw1, tcw1[..., None]], dim=-1)
    A = torch.stack(
        [
            pc0[..., 0, None] * P0[..., 2, :] - P0[..., 0, :],
            pc0[..., 1, None] * P0[..., 2, :] - P0[..., 1, :],
            pc1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            pc1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        ],
        dim=-2,
    )
    A3 = A[..., :3]
    Nm = A3.transpose(-1, -2) @ A3
    b = -torch.einsum("mki,mk->mi", A3, A[..., 3])
    c0 = torch.linalg.cross(Nm[..., :, 1], Nm[..., :, 2])
    det = torch.sum(Nm[..., :, 0] * c0, dim=-1)
    adjT = torch.stack([c0, torch.linalg.cross(Nm[..., :, 2], Nm[..., :, 0]),
                        torch.linalg.cross(Nm[..., :, 0], Nm[..., :, 1])], dim=-1)
    X3 = torch.einsum("mij,mj->mi", adjT, b)
    return X3 / torch.where(torch.abs(det) > 1e-300, det, torch.ones_like(det))[..., None]


def triangulate_batch(pose0_R, pose0_t, pose1_R, pose1_t, pc0, pc1):
    """Batched triangulation; poses are camera->world (frame poses); converts
    to Tcw internally. All args lead with the point axis except pose1
    (shared current frame) which may be unbatched."""
    Rcw0 = pose0_R.transpose(-1, -2)
    tcw0 = -torch.einsum("...ij,...j->...i", Rcw0, pose0_t)
    Rcw1 = pose1_R.transpose(-1, -2)
    tcw1 = -torch.einsum("...ij,...j->...i", Rcw1, pose1_t)
    M = pc0.shape[0]
    if Rcw1.ndim == 2:
        Rcw1 = Rcw1.expand(M, 3, 3)
        tcw1 = tcw1.expand(M, 3)
    return triangulate(Rcw0, tcw0, Rcw1, tcw1, pc0, pc1)
