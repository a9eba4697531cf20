"""The plain reference of the window's back end, in a dtype of the caller's
choice: float64 is the reference, float32 its control.

- :func:`preintegrate`: one interval's IMU preintegration, one sample at a
  time (IC-GVINS ``preintegration_base.cc:39-102``,
  ``preintegration_earth.cc:205-334``), over the samples that
  :func:`imu_series` cuts from the world's IMU between two node times
  (``misc.cc:263-361``).
- :func:`two_pass`: one keyframe episode's solve: Levenberg-Marquardt with
  Ceres' step test and radius update over the dense normal equations, a pass
  with robust kernels for a quarter of the iterations, the chi2 outlier
  surgery, and a pass without the GNSS kernel for the rest
  (``ic_gvins.cc:1130-1239``).
- :func:`marginalize`: the prior that marginalizing the oldest nodes and the
  landmarks of the oldest keyframe leaves (``ic_gvins.cc:1482-1610``,
  ``marginalization_info.h:73-253``): a dense Schur complement by an
  eigen-decomposed pseudo-inverse, its node columns shifted as the window
  slides.

A problem is a dict of the window's factor tables and parameters (the
layout the episode hands its solver: node slots of 15 local coordinates,
then the extrinsic's 6, the time delay, one inverse depth a landmark). The
factors' residuals and jacobians follow the IC-GVINS sources as the factor
files name them (``gnss_factor.h``, ``imu_error_factor.h``,
``imu_pose_prior_factor.h``, ``imu_mix_prior_factor.h``,
``preintegration_earth.cc:37-164``, ``reprojection_factor.h``,
``marginalization_factor.h``, Ceres' Huber loss and its corrector). Nothing
here imports the program.
"""

import math

import numpy as np
import torch

ND = 15           # local coordinates of a node: pose 6, velocity 3, biases 6
GNSS_CHI2 = 7.815
REPROJ_CHI2 = 5.991
IMU_GYR_BIAS_STD = 7200.0 / 3600.0 * math.pi / 180.0
IMU_ACC_BIAS_STD = 2.0e4 * 1.0e-5


# ---------------------------------------------------------------------------
# quaternions (xyzw, Hamilton)
# ---------------------------------------------------------------------------

def qmul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by, aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw, aw * bw - ax * bx - ay * by - az * bz], -1)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def qmat(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def rot(q, v):
    return (qmat(q) @ v[..., None])[..., 0]


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def exp_q(rv):
    a2 = torch.sum(rv * rv, -1, keepdim=True)
    a = torch.sqrt(torch.clamp(a2, min=1e-24))
    small = a2 < 1e-16
    k = torch.where(small, 0.5 - a2 / 48.0, torch.sin(0.5 * a) / a)
    w = torch.where(small, 1.0 - a2 / 8.0, torch.cos(0.5 * a))
    return torch.cat([rv * k, w], -1)


def left33(q):
    return q[..., 3, None, None] * torch.eye(3, dtype=q.dtype, device=q.device) + skew(q[..., :3])


def right33(q):
    return q[..., 3, None, None] * torch.eye(3, dtype=q.dtype, device=q.device) - skew(q[..., :3])


def boxplus_pose(pose, d):
    return torch.cat([pose[..., :3] + d[..., :3], qnormalize(qmul(pose[..., 3:7], exp_q(d[..., 3:6])))], -1)


def boxminus_pose(pose, pose0):
    dq = qmul(qconj(pose0[..., 3:7]), pose[..., 3:7])
    dth = torch.where(dq[..., 3:4] < 0, -2.0 * dq[..., :3], 2.0 * dq[..., :3])
    return torch.cat([pose[..., :3] - pose0[..., :3], dth], -1)


def _mv(a, x):
    return (a @ x[..., None])[..., 0]


# ---------------------------------------------------------------------------
# preintegration
# ---------------------------------------------------------------------------

def imu_series(imu, start, end, tol=1.0e-4):
    """The samples covering (start, end] of the world's IMU dict, the ends
    split at the node times, sample 0 the anchor (getImuSeriesFromTo)."""
    t = imu["time"]
    sample = lambda i: dict(time=t[i], dt=imu["dt"][i], dtheta=imu["dtheta"][i], dvel=imu["dvel"][i])  # noqa: E731

    def split(i, at):
        s = sample(i)
        scale = (s["time"] - at) / s["dt"]
        first = dict(time=at, dt=s["dt"] - (s["time"] - at), dtheta=s["dtheta"] * (1 - scale),
                     dvel=s["dvel"] * (1 - scale))
        second = dict(time=s["time"], dt=s["time"] - at, dtheta=s["dtheta"] * scale, dvel=s["dvel"] * scale)
        return first, second

    n = len(t)
    i = int(np.searchsorted(t, start, side="right"))
    out = []
    if i == 0:
        out.append(sample(0))
        i = 1
    else:
        cur = sample(i) if i < n else None
        if abs(t[i - 1] - start) < tol or cur is None:
            out.append(sample(i - 1))
        elif abs(cur["time"] - start) < tol:
            out.append(cur)
            i += 1
        else:
            out.extend(split(i, start))
            i += 1
    while i < n and t[i] < end - tol:
        out.append(sample(i))
        i += 1
    if i < n:
        out.append(sample(i) if abs(t[i] - end) < tol else split(i, end)[0])
    out[-1]["time"] = end
    return {f: np.stack([np.asarray(s[f], np.float64) for s in out]) for f in ("time", "dt", "dtheta", "dvel")}


def preintegrate(seg, q0, bg, ba, iewn, imu_model, dtype=torch.float64):
    """(dp, dv, dq, cov, jac) of one interval with the earth rate: the
    segment's samples after its anchor integrated from the node attitude q0
    at the biases (bg, ba), the earth rate ``iewn`` seen through q0.
    ``imu_model``: arw, vrw, gbstd, abstd, corrtime in SI units."""
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype)  # noqa: E731
    q0, bg, ba, iewn = (T(a) for a in (q0, bg, ba, iewn))
    I3 = torch.eye(3, dtype=dtype)
    m = imu_model
    noise = torch.diag(T(np.repeat([m["arw"] ** 2, m["vrw"] ** 2, 2 * m["gbstd"] ** 2 / m["corrtime"],
                                    2 * m["abstd"] ** 2 / m["corrtime"]], 3)))
    dts, dths, dvls = T(seg["dt"]), T(seg["dtheta"]), T(seg["dvel"])
    dp, dv, dq = torch.zeros(3, dtype=dtype), torch.zeros(3, dtype=dtype), T([0.0, 0.0, 0.0, 1.0])
    jac, cov = torch.eye(15, dtype=dtype), torch.zeros(15, 15, dtype=dtype)
    ttot = torch.zeros((), dtype=dtype)
    # the anchor's increments enter the coning and sculling terms as they
    # are: the program's segment carries the anchor with dt = 0, so its bias
    # compensation removes nothing (IC-GVINS compensates them; a gap of
    # ~6e-7 of dp over a keyframe interval)
    th_pre, vl_pre = dths[0], dvls[0]
    for k in range(1, len(dts)):
        dt = dts[k]
        if float(dt) <= 0:
            continue
        th, vl = dths[k] - dt * bg, dvls[k] - dt * ba
        dvfb = vl + 0.5 * torch.linalg.cross(th, vl) + (torch.linalg.cross(th_pre, vl)
                                                       + torch.linalg.cross(vl_pre, th)) / 12.0
        dth = th + torch.linalg.cross(th_pre, th) / 12.0
        tnew = ttot + dt
        q_mid = qmul(qmul(qconj(q0), exp_q(-(tnew - 0.5 * dt) * iewn)), qmul(q0, dq))
        dvel = rot(q_mid, dvfb)
        dp = dp + dt * dv + 0.5 * dt * dvel
        dv = dv + dvel
        dq = qnormalize(qmul(dq, exp_q(dth)))
        cbb = -qmat(qmul(qmul(qconj(q0), exp_q(-iewn * tnew)), qmul(q0, dq)))
        phi = torch.eye(15, dtype=dtype)
        phi[0:3, 3:6] = I3 * dt
        phi[3:6, 6:9] = cbb @ skew(vl)
        phi[3:6, 12:15] = cbb * dt
        phi[6:9, 6:9] = I3 - skew(th)
        phi[6:9, 9:12] = -I3 * dt
        phi[9:12, 9:12] = I3 * (1.0 - dt / m["corrtime"])
        phi[12:15, 12:15] = I3 * (1.0 - dt / m["corrtime"])
        G = torch.zeros(15, 12, dtype=dtype)
        G[3:6, 3:6] = cbb
        G[6:9, 0:3] = -I3
        G[9:12, 6:9] = I3
        G[12:15, 9:12] = I3
        a = phi @ (G @ noise @ G.T)
        jac = phi @ jac
        cov = phi @ cov @ phi.T + 0.5 * dt * (a + a.T)
        ttot, th_pre, vl_pre = tnew, th, vl
    return dict(dp=dp, dv=dv, dq=dq, cov=0.5 * (cov + cov.T), jac=jac)


# ---------------------------------------------------------------------------
# factors
# ---------------------------------------------------------------------------

def huber(s):
    """Ceres' HuberLoss(1): (rho, rho', rho'') at squared norm s."""
    r = torch.sqrt(torch.clamp(s, min=1e-300))
    big = s > 1.0
    return (torch.where(big, 2.0 * r - 1.0, s), torch.where(big, 1.0 / r, torch.ones_like(s)),
            torch.where(big, -0.5 / (s * r), torch.zeros_like(s)))


def corrected(r, J, robust):
    """Ceres' corrector (where ``robust``): the residual block and jacobian
    rescaled so that the Gauss-Newton model of the Huber cost is exact to
    first order."""
    if not robust:
        return r, J
    s = torch.sum(r * r, -1)
    _, d1, d2 = huber(s)
    sq = torch.sqrt(d1)
    trivial = (s == 0.0) | (d2 <= 0.0)
    alpha = 1.0 - torch.sqrt(torch.clamp(1.0 + 2.0 * s * d2 / torch.clamp(d1, min=1e-300), min=0.0))
    rs = torch.where(trivial, sq, sq / (1.0 - alpha))
    a = torch.where(trivial, torch.zeros_like(s), alpha / torch.clamp(s, min=1e-300))
    rJ = (r[..., None, :] @ J)[..., 0, :]
    return rs[..., None] * r, sq[..., None, None] * (J - a[..., None, None] * (r[..., :, None] * rJ[..., None, :]))


def gnss(pose, z, std, lever):
    r = (pose[:, :3] + rot(pose[:, 3:7], lever.expand(len(pose), 3)) - z) / std
    Jr = -qmat(pose[:, 3:7]) @ skew(lever)
    J = torch.cat([torch.eye(3, dtype=pose.dtype).expand(len(pose), 3, 3), Jr], -1) / std[..., None]
    return r, J


def preint(s, pose0, mix0, pose1, mix1):
    """The earth-rate preintegration factor: whitened residual (P, 15) and
    its jacobians over [pose0 6, mix0 9, pose1 6, mix1 9] (P, 15, 30)."""
    p0, q0, v0 = pose0[:, :3], pose0[:, 3:7], mix0[:, :3]
    p1, q1, v1 = pose1[:, :3], pose1[:, 3:7], mix1[:, :3]
    dt = s["dt"][:, None]
    dbg, dba = mix0[:, 3:6] - s["bg0"], mix0[:, 6:9] - s["ba0"]
    cp = s["dp"] + _mv(s["dp_dba"], dba) + _mv(s["dp_dbg"], dbg)
    cv = s["dv"] + _mv(s["dv_dba"], dba) + _mv(s["dv_dbg"], dbg)
    cq = qmul(s["dq"], exp_q(_mv(s["dq_dbg"], dbg)))
    g, W = s["gravity"], skew(s["iewn"])
    dpn = p1 - p0 - v0 * dt - 0.5 * g * dt * dt + 2.0 * _mv(W, s["sum_dtpn"] - dt * p0)
    dvn = v1 - v0 - g * dt + 2.0 * _mv(W, p1 - p0)
    qb = qmul(qconj(q1), qmul(exp_q(-s["iewn"] * dt), q0))
    r = torch.cat([rot(qconj(q0), dpn) - cp, rot(qconj(q0), dvn) - cv, 2.0 * qmul(qb, cq)[:, :3],
                   mix1[:, 3:6] - mix0[:, 3:6], mix1[:, 6:9] - mix0[:, 6:9]], -1)
    P = len(dt)
    C = qmat(qconj(q0))
    CW = C @ W
    I3 = torch.eye(3, dtype=dt.dtype).expand(P, 3, 3)
    J = torch.zeros(P, 15, 30, dtype=dt.dtype)
    dtm = dt[..., None]
    J[:, 0:3, 0:3] = -C - 2.0 * CW * dtm
    J[:, 0:3, 3:6] = skew(_mv(C, dpn))
    J[:, 3:6, 0:3] = -2.0 * CW
    J[:, 3:6, 3:6] = skew(_mv(C, dvn))
    J[:, 6:9, 3:6] = left33(qb) @ right33(cq) - qb[:, :3, None] * cq[:, None, :3]
    J[:, 0:3, 6:9] = -C * dtm
    J[:, 0:3, 9:12] = -s["dp_dbg"]
    J[:, 0:3, 12:15] = -s["dp_dba"]
    J[:, 3:6, 6:9] = -C
    J[:, 3:6, 9:12] = -s["dv_dbg"]
    J[:, 3:6, 12:15] = -s["dv_dba"]
    J[:, 6:9, 9:12] = left33(qmul(qb, s["dq"])) @ s["dq_dbg"]
    J[:, 9:12, 9:12] = -I3
    J[:, 12:15, 12:15] = -I3
    J[:, 0:3, 15:18] = C
    J[:, 3:6, 15:18] = 2.0 * CW
    J[:, 6:9, 18:21] = -right33(qmul(qb, cq))
    J[:, 3:6, 21:24] = C
    J[:, 9:12, 24:27] = I3
    J[:, 12:15, 27:30] = I3
    U = s["sqrt_info"]
    return _mv(U, r), U @ J


def reproj(pose0, pose1, ext, inv, t):
    """The inverse-depth reprojection factor with the time delay held (it
    is not estimated): residual (R, 2), jacobians over [pose_ref 6,
    pose_obs 6, inverse depth 1] (R, 2, 13). Poses translated by a common
    offset first (the factor does not see it)."""
    dpos = pose0[:, :3] - pose1[:, :3]
    p0, q0, q1 = dpos, pose0[:, 3:7], pose1[:, 3:7]
    tic, qic = ext[:3].expand(len(p0), 3), ext[3:7].expand(len(p0), 4)
    pts0 = t["pts0"] - (t["td"] - t["td0"])[:, None] * t["vel0"]
    pts1 = t["pts1"] - (t["td"] - t["td1"])[:, None] * t["vel1"]
    pc0 = pts0 / inv[:, None]
    pb0 = rot(qic, pc0) + tic
    pn = rot(q0, pb0) + p0
    pb1 = rot(qconj(q1), pn)
    pc1 = rot(qconj(qic), pb1 - tic)
    d = pc1[:, 2]
    si = t["sqrt_info"]
    r = si * (pc1[:, :2] / d[:, None] - pts1[:, :2])
    z = torch.zeros_like(d)
    red = torch.stack([torch.stack([1 / d, z, -pc1[:, 0] / (d * d)], -1),
                       torch.stack([z, 1 / d, -pc1[:, 1] / (d * d)], -1)], -2) * si
    cb0n, cnb1, cbc = qmat(q0), qmat(q1).transpose(-1, -2), qmat(qic).transpose(-1, -2)
    A = cbc @ cnb1
    J0 = torch.cat([A, -A @ cb0n @ skew(pb0)], -1)
    J1 = torch.cat([-A, cbc @ skew(pb1)], -1)
    tmp = A @ cb0n @ cbc.transpose(-1, -2)
    Jid = (-_mv(red, _mv(tmp, pts0)) / (inv * inv)[:, None])[..., None]
    return r, torch.cat([red @ J0, red @ J1, Jid], -1)


# ---------------------------------------------------------------------------
# the window problem
# ---------------------------------------------------------------------------

def to_dtype(tree, dtype):
    """A nested dict of tensors with every floating tensor cast to dtype."""
    if isinstance(tree, dict):
        return {k: to_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if torch.is_tensor(tree) and tree.is_floating_point() else tree


class Window:
    """One problem's sizes and column layout, from its tables."""

    def __init__(self, tb):
        self.N = tb["node_valid"].shape[0]
        self.L = tb["lm_valid"].shape[0]
        self.ext_off = self.N * ND
        self.lm_off = self.ext_off + 7
        self.D = self.lm_off + self.L

    def activity(self, tb):
        return torch.cat([tb["node_valid"].repeat_interleave(ND), tb["ext_active"].expand(6),
                          tb["td_active"].reshape(1), tb["lm_valid"]])

    def boxplus(self, x, dx):
        dn = dx[:self.ext_off].reshape(self.N, ND)
        return dict(poses=boxplus_pose(x["poses"], dn[:, :6]), mixes=x["mixes"] + dn[:, 6:],
                    ext=boxplus_pose(x["ext"], dx[self.ext_off:self.ext_off + 6]),
                    td=x["td"] + dx[self.ext_off + 6], invdepths=x["invdepths"] + dx[self.lm_off:])

    def boxminus(self, x, x0):
        dn = torch.cat([boxminus_pose(x["poses"], x0["poses"]), x["mixes"] - x0["mixes"]], -1)
        return torch.cat([dn.reshape(-1), boxminus_pose(x["ext"], x0["ext"]), (x["td"] - x0["td"]).reshape(1),
                          x["invdepths"] - x0["invdepths"]])


def _marg_terms(w, x, tb):
    """The marginalization prior's dx, and D's inverse right jacobians on
    every rotation tangent (the exact chain of 0.5|e0 + J0 (x - x0)|^2)."""
    m = tb["marg"]
    dx0 = w.boxminus(x, m["x0"])[:w.lm_off]
    cols = torch.cat([(torch.arange(w.N) * ND)[:, None] + torch.arange(3, 6),
                      w.ext_off + torch.arange(3, 6)[None]])
    rv = dx0[cols]
    th2 = torch.sum(rv * rv, -1)
    th = torch.sqrt(torch.clamp(th2, min=1e-300))
    small = th2 < 1e-8
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    1.0 / torch.where(small, torch.ones_like(th2), th2)
                    - (1.0 + torch.cos(th)) / torch.clamp(2.0 * th * torch.sin(th), min=1e-300))
    K = skew(rv)
    Jinv = torch.eye(3, dtype=rv.dtype) + 0.5 * K + c[:, None, None] * (K @ K)
    Dm = torch.eye(w.lm_off, dtype=rv.dtype)
    for k in range(len(cols)):
        Dm[cols[k][:, None], cols[k][None, :]] = Jinv[k]
    return dx0, Dm


def factors(w, x, tb):
    """Every factor table at x: (name, columns (B, C), whitened jacobian
    (B, r, C), whitened residual (B, r), weight (B,), robust)."""
    dtype = x["poses"].dtype
    g, p, t, pr = tb["gnss"], tb["preint"], tb["reproj"], tb["prior"]
    rg, Jg = gnss(x["poses"][g["idx"]], g["blh"], g["std"], tb["antlever"])
    i0 = p["idx0"]
    rp, Jp = preint(p["summ"], x["poses"][i0], x["mixes"][i0], x["poses"][i0 + 1], x["mixes"][i0 + 1])
    rr, Jr = reproj(x["poses"][t["ref_idx"]], x["poses"][t["obs_idx"]], x["ext"], x["invdepths"][t["lm_idx"]],
                    dict(t, td=x["td"]))
    k = int(pr["imuerr_idx"])
    mix = x["mixes"][k]
    re = torch.cat([mix[3:6] / IMU_GYR_BIAS_STD, mix[6:9] / IMU_ACC_BIAS_STD])
    Je = torch.zeros(6, 9, dtype=dtype)
    Je[0:3, 3:6] = torch.eye(3, dtype=dtype) / IMU_GYR_BIAS_STD
    Je[3:6, 6:9] = torch.eye(3, dtype=dtype) / IMU_ACC_BIAS_STD
    pose, pp, ps = x["poses"][0], pr["pose_prior"], pr["pose_prior_std"]
    dq = qmul(qconj(pose[3:7]), pp[3:7])
    rpp = torch.cat([pose[:3] - pp[:3], 2.0 * dq[:3]]) / ps
    Jpp = torch.zeros(6, 6, dtype=dtype)
    Jpp[0:3, 0:3] = torch.eye(3, dtype=dtype)
    Jpp[3:6, 3:6] = -right33(dq)
    rmp = (x["mixes"][0] - pr["mix_prior"]) / pr["mix_prior_std"]
    ar = torch.arange
    return [
        ("gnss", g["idx"][:, None] * ND + ar(6), Jg, rg, g["valid"], bool(g["robust"] > 0)),
        ("preint", i0[:, None] * ND + ar(2 * ND), Jp, rp, p["valid"], False),
        ("reproj", torch.cat([t["ref_idx"][:, None] * ND + ar(6), t["obs_idx"][:, None] * ND + ar(6),
                              (w.lm_off + t["lm_idx"])[:, None]], -1), Jr, rr, t["valid"], bool(t["robust"] > 0)),
        ("imu_error", (k * ND + 6 + ar(9))[None], Je[None], re[None], pr["imuerr_valid"].reshape(1), False),
        ("pose_prior", ar(6)[None], (Jpp / ps[:, None])[None], rpp[None], pr["valid"].reshape(1), False),
        ("mix_prior", (6 + ar(9))[None], torch.diag(1.0 / pr["mix_prior_std"])[None], rmp[None],
         pr["valid"].reshape(1), False),
    ]


def cost(w, x, tb):
    """0.5 * the robustified sum of squares over the valid factors, with the
    marginalization prior's quadratic."""
    total = 0.0
    for _, _, _, r, wt, robust in factors(w, x, tb):
        s = torch.sum(r * r, -1)
        total = total + 0.5 * torch.sum((huber(s)[0] if robust else s) * wt)
    m = tb["marg"]
    dx = w.boxminus(x, m["x0"])[:w.lm_off]
    quad = m["c0"] + 2.0 * torch.dot(dx, m["Jte0"]) + torch.dot(dx, m["H0"] @ dx)
    return total + 0.5 * m["valid"] * torch.clamp(quad, min=0.0)


def normal_equations(w, x, tb):
    """Dense (H (D, D), b = -J^T r (D,)) of the window at x, each factor
    robust-corrected where its table says."""
    dtype = x["poses"].dtype
    H = torch.zeros(w.D * w.D, dtype=dtype)
    b = torch.zeros(w.D, dtype=dtype)
    for _, cols, J, r, wt, robust in factors(w, x, tb):
        r, J = corrected(r, J, robust)
        JtJ = (J.transpose(-1, -2) @ J) * wt[:, None, None]
        H.index_add_(0, (cols[:, :, None] * w.D + cols[:, None, :]).reshape(-1), JtJ.reshape(-1))
        b.index_add_(0, cols.reshape(-1), -((J.transpose(-1, -2) @ r[..., None])[..., 0] * wt[:, None]).reshape(-1))
    H = H.reshape(w.D, w.D)
    m, NP = tb["marg"], w.lm_off
    dx0, Dm = _marg_terms(w, x, tb)
    H[:NP, :NP] += m["valid"] * (Dm.T @ m["H0"] @ Dm)
    b[:NP] -= m["valid"] * (Dm.T @ (m["Jte0"] + m["H0"] @ dx0))
    return H, b


def solve(w, x, tb, iterations, radius=1e4, ftol=1e-6):
    """Levenberg-Marquardt with Ceres' step test and radius update; returns
    (x, accepted steps)."""
    dtype = x["poses"].dtype
    act = w.activity(tb)
    c = cost(w, x, tb)
    radius = torch.tensor(radius, dtype=dtype)
    accepted = 0
    for _ in range(iterations):
        H, b = normal_equations(w, x, tb)
        H = H * act[:, None] * act[None, :] + torch.diag(1.0 - act)
        b = b * act
        A = H + torch.diag(torch.clamp(torch.diagonal(H), 1e-6, 1e32) / radius)
        dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
        L, info = torch.linalg.cholesky_ex(A * dinv[:, None] * dinv[None, :])
        dx = dinv * torch.cholesky_solve((b * dinv)[:, None], L)[:, 0] * act
        if int(info) != 0 or not bool(torch.all(torch.isfinite(dx))):
            dx = torch.zeros_like(dx)
        cand = w.boxplus(x, dx)
        c_new = cost(w, cand, tb)
        change = torch.dot(dx, b) - 0.5 * torch.dot(dx, H @ dx)
        rho = (c - c_new) / (change if bool(change > 0) else 1e-300)
        ok = bool(rho > 1e-3) and bool(change > 0) and bool(torch.isfinite(c_new))
        done = bool(torch.amax(torch.abs(dx)) < 1e-12) or (ok and bool(c - c_new <= ftol * c))
        if ok:
            x, c, accepted = cand, c_new, accepted + 1
            radius = torch.clamp(radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), max=1e16)
        else:
            radius = torch.clamp(radius / 2.0, min=1e-32)
        if done:
            break
    return x, accepted


def surgery(w, x, tb):
    """The chi2 surgery between the passes: GNSS blocks over 7.815 have their
    std inflated by sqrt(chi2 / 7.815), reprojection blocks over 5.991 go,
    and GNSS loses its robust kernel."""
    res = {name: r for name, _, _, r, _, _ in factors(w, x, tb)}
    rg, rr = res["gnss"], res["reproj"]
    g, t = dict(tb["gnss"]), dict(tb["reproj"])
    chi_g, chi_r = torch.sum(rg * rg, -1), torch.sum(rr * rr, -1)
    bad = (chi_g > GNSS_CHI2) & (g["valid"] > 0)
    g["std"] = torch.where(bad[:, None], g["std"] * torch.sqrt(torch.clamp(chi_g / GNSS_CHI2, min=1.0))[:, None],
                           g["std"])
    g["robust"] = torch.zeros_like(g["robust"])
    t["valid"] = torch.where((chi_r > REPROJ_CHI2) & (t["valid"] > 0), torch.zeros_like(t["valid"]), t["valid"])
    return dict(tb, gnss=g, reproj=t)


def two_pass(x, tb, iterations):
    """One keyframe episode's solve from state x on tables tb: the solved
    state and the accepted steps of each pass."""
    w = Window(tb)
    n1 = max(iterations // 4, 1)
    x, a1 = solve(w, x, tb, n1)
    x, a2 = solve(w, x, surgery(w, x, tb), max(iterations - n1, 1))
    return x, (a1, a2)


def marginalize(x, tb, num_marg, oldest_node):
    """The prior (H0 (NP, NP), Jte0 (NP,)) that marginalizing nodes
    [0, num_marg) and the landmarks anchored at ``oldest_node`` leaves,
    linearized at x, its node columns shifted left by ``num_marg`` slots."""
    w = Window(tb)
    t = tb["reproj"]
    g = dict(tb["gnss"], valid=tb["gnss"]["valid"] * (tb["gnss"]["idx"] < num_marg),
             robust=torch.zeros_like(tb["gnss"]["robust"]))
    p = dict(tb["preint"], valid=tb["preint"]["valid"] * (tb["preint"]["idx0"] < num_marg))
    anchored = (t["ref_idx"] == oldest_node)
    r = dict(t, valid=t["valid"] * anchored, robust=torch.ones_like(t["robust"]))
    mt = dict(tb, gnss=g, preint=p, reproj=r, prior=dict(tb["prior"], imuerr_valid=torch.zeros_like(
        tb["prior"]["imuerr_valid"])))
    H, b = normal_equations(w, x, mt)
    act = w.activity(tb)
    lm_m = torch.zeros(w.L, dtype=torch.bool)
    lm_m[t["lm_idx"][anchored & (t["valid"] > 0)]] = True
    m = torch.cat([(torch.arange(w.N) < num_marg).repeat_interleave(ND), torch.zeros(7, dtype=torch.bool), lm_m])
    keep = ((~m) & (act > 0))[:w.lm_off].nonzero()[:, 0]
    M = m.nonzero()[:, 0]
    S = H[M][:, M]
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=torch.clamp(torch.diagonal(S).max(), min=1.0) * 1e-30))
    ev, V = torch.linalg.eigh(S / (d[:, None] * d[None, :]))
    inv = torch.where(ev > ev.max() * 1e-12, 1.0 / ev, torch.zeros_like(ev))
    S_pinv = (V * inv) @ V.T / (d[:, None] * d[None, :])
    HkM = H[keep][:, M]
    Hp = H[keep][:, keep] - HkM @ S_pinv @ HkM.T
    bp = b[keep] - HkM @ S_pinv @ b[M]
    NP = w.lm_off
    H0 = torch.zeros(NP, NP, dtype=H.dtype)
    Jte0 = torch.zeros(NP, dtype=H.dtype)
    H0[keep[:, None], keep[None, :]] = 0.5 * (Hp + Hp.T)
    Jte0[keep] = -bp
    nd, s = w.N * ND, num_marg * ND
    order = torch.cat([torch.arange(s, nd), torch.arange(nd, NP)])
    out_H = torch.zeros_like(H0)
    out_J = torch.zeros_like(Jte0)
    dest = torch.cat([torch.arange(0, nd - s), torch.arange(nd, NP)])
    out_H[dest[:, None], dest[None, :]] = H0[order[:, None], order[None, :]]
    out_J[dest] = Jte0[order]
    return out_H, out_J
