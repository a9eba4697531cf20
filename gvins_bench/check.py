"""Whether the window's outputs are correct: what the program produced
in the window against the plain reference, number by number.

- ``pyramid_gap``: the CLAHE pyramids the program built for the sampled
  frames against the reference's, worked out again from the raw frames
  (largest gap, gray levels, over every level).
- ``lk_status_mismatch`` and ``lk_endpoint_gap_px``: the program's
  bidirectional LK on those frames against the reference's LK on the same
  pyramids and points (the share of valid slots whose status differs, over
  all the sampled calls together; the largest endpoint gap over slots both
  track). The points to track are the
  program's state: the reference follows it; the pyramids are held by
  ``pyramid_gap`` on their own.
- ``subpix_gap_px``: the program's cornerSubPix against the reference's on
  the same image and corners (largest gap over valid corners).
- ``ins_gap_m``: the program's INS propagation against the reference's
  strapdown update from the same state over the world's own IMU samples
  (largest position gap over the samples of the sampled propagations).
- ``preint_gap``: the program's preintegration of sampled intervals
  against the reference's (``backend.preintegrate``) from the same node
  state over the world's own IMU samples between the node times (largest
  gap of the summary's deltas, bias jacobians and covariance, each over its
  reference's largest entry).
- ``solve_gap_m``: one keyframe episode drawn from the seed: the state the
  program's two-pass solve returned against the reference's two-pass solve
  (``backend.two_pass``) from the same state on the same factor tables
  (largest node position gap).
- ``prior_gap``: the first marginalization after that episode: the prior
  the program left against the reference's Schur complement of the same
  factors at the same state (largest gap of its information matrix and of
  its gradient, each over its reference's largest entry).

The factor tables are the program's: the reference follows them, and holds
the stages that made them by their own numbers (the kernels' and the
preintegration's). The control puts the reference computed one precision
lower in the program's place: bfloat16 image math for the float32
frontend, float32 for the float64 INS, preintegration, solve and
marginalization. ``ate_rmse_m``, the window's trajectory nodes against the
world's truth, is printed beside the numbers and is not one of them: it has
no reading of the control.
"""

import re

import numpy as np
import torch

from . import backend as be
from . import reference as ref
from . import world as wd

NAMES = ("pyramid_gap", "lk_status_mismatch", "lk_endpoint_gap_px", "subpix_gap_px", "ins_gap_m", "preint_gap",
         "solve_gap_m", "prior_gap")
D2R = np.pi / 180.0


def _max(values):
    return max(values) if values else None


def _lk_gaps(fwd, ok, fwd_ref, ok_ref, valid):
    """(slots whose status differs, valid slots, largest endpoint gap over
    the slots both track)."""
    both = ok & ok_ref
    gap = float(torch.linalg.vector_norm(fwd[both] - fwd_ref[both], dim=-1).max()) if bool(both.any()) else 0.0
    return int(((ok != ok_ref) & valid).sum()), int(valid.sum()), gap


def kernel_readings(captures, frames, control=False):
    """The frontend's numbers over the captured calls: the program's outputs
    against the float32 reference, or (``control``) the bfloat16 reference's
    in their place."""
    low = torch.bfloat16
    pyr_gaps, lk_gaps, sp_gaps = [], [], []
    mismatched = n_valid = 0
    pyramids = {}

    def pyr(k, dtype, device):
        if (k, dtype) not in pyramids:
            pyramids[k, dtype] = ref.pyramid(torch.tensor(frames[k], dtype=torch.float32, device=device), dtype)
        return pyramids[k, dtype]

    for cap in captures["lk"]:
        pyr_prev, pyr_next, pts_prev, pts_pred, valid = cap["args"]
        dev = pts_prev.device
        for k, levels in zip(cap["frames"], (pyr_prev, pyr_next)):
            if k is None:
                continue
            truth = pyr(k, torch.float32, dev)
            seen = pyr(k, low, dev) if control else levels
            pyr_gaps.append(max(float((a.float() - b).abs().max()) for a, b in zip(seen, truth)))
        fwd_ref, ok_ref = ref.lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid)
        if control:
            fwd, ok = ref.lk_pyr([t.to(low) for t in pyr_prev], [t.to(low) for t in pyr_next],
                                 pts_prev, pts_pred, valid)
        else:
            fwd, ok = cap["fwd"], cap["ok"]
        differ, n, gap = _lk_gaps(fwd, ok, fwd_ref, ok_ref, valid)
        mismatched, n_valid = mismatched + differ, n_valid + n
        lk_gaps.append(gap)
    for cap in captures["subpix"]:
        img, corners, valid = cap["args"]
        out_ref, _ = ref.subpix(img, corners, valid)
        out = ref.subpix(img.to(low), corners, valid)[0] if control else cap["out"]
        if bool(valid.any()):
            sp_gaps.append(float(torch.linalg.vector_norm(out - out_ref, dim=-1)[valid].max()))
        if cap["frame"] is not None:
            truth = pyr(cap["frame"], torch.float32, img.device)[0]
            seen = pyr(cap["frame"], low, img.device)[0] if control else img
            pyr_gaps.append(float((seen.float() - truth).abs().max()))
    return dict(pyramid_gap=_max(pyr_gaps), lk_status_mismatch=mismatched / n_valid if n_valid else None,
                lk_endpoint_gap_px=_max(lk_gaps), subpix_gap_px=_max(sp_gaps))


def ins_reading(captures, world, control=False):
    """Largest position gap of the sampled propagations: the program's (or,
    with ``control``, the float32 reference's) against the float64
    reference's, from the program's state before each."""
    imu = world["imu"]
    origin = world["gnss"]["blh"][0]   # the estimator's origin: the first fix
    g = float(wd.gravity(origin))
    gaps = []
    for cap in captures["ins"]:
        j0, j1, s = cap["j0"], cap["j1"], cap["state0"]
        prev = None if j0 == 0 else (imu["dt"][j0 - 1], imu["dtheta"][j0 - 1], imu["dvel"][j0 - 1])
        iewn = wd.earth_rate(wd.local2global(origin, s["p"])) if world["with_earth"] else np.zeros(3)
        run = lambda dtype: wd.mechanize_steps(  # noqa: E731
            s["p"], s["q"], s["v"], s["bg"], s["ba"], imu["dt"][j0:j1], imu["dtheta"][j0:j1], imu["dvel"][j0:j1],
            prev, g, iewn, world["with_earth"], dtype)[0]
        p_ref = run(np.float64)
        p = run(np.float32).astype(np.float64) if control else cap["p"]
        gaps.append(float(np.linalg.norm(p - p_ref, axis=1).max()))
    return _max(gaps)


def imu_model(yaml_text):
    """The gvins.yaml's ``imumodel`` flow map in SI units (arw deg/sqrt(hr),
    vrw m/s/sqrt(hr), gbstd deg/hr, abstd mGal, corrtime hr, as IC-GVINS
    reads them, ``ic_gvins.cc:92-96``)."""
    body = re.search(r"^imumodel:\s*\{([^}]*)\}", yaml_text, re.M).group(1)
    v = {k.strip(): float(x) for k, x in (item.split(":") for item in body.split(","))}
    return dict(arw=v["arw"] * D2R / 60.0, vrw=v["vrw"] / 60.0, gbstd=v["gbstd"] * D2R / 3600.0,
                abstd=v["abstd"] * 1.0e-5, corrtime=v["corrtime"] * 3600.0)


def _rel(a, b):
    """Largest gap of ``a`` from ``b`` over ``b``'s largest entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def preint_reading(captures, world, model, control=False):
    """Largest relative gap of the sampled preintegrations' summaries: the
    program's (or, with ``control``, the float32 reference's) against the
    float64 reference's."""
    origin = world["gnss"]["blh"][0]
    gaps = []
    for cap in captures["preint"]:
        seg = be.imu_series(world["imu"], cap["t0"], cap["t1"])
        iewn = wd.earth_rate(wd.local2global(origin, cap["p"])) if world["with_earth"] else np.zeros(3)
        run = lambda dtype: be.preintegrate(seg, cap["q"], cap["bg"], cap["ba"], iewn, model, dtype)  # noqa: E731
        want = run(torch.float64)
        if control:
            low = run(torch.float32)
            got = dict(dp=low["dp"], dv=low["dv"], dq=low["dq"], cov=low["cov"], jac=low["jac"])
        else:
            s = cap["summ"]
            jac = np.zeros((15, 15))
            jac[0:3, 9:12], jac[0:3, 12:15], jac[3:6, 9:12] = s["dp_dbg"], s["dp_dba"], s["dv_dbg"]
            jac[3:6, 12:15], jac[6:9, 9:12] = s["dv_dba"], s["dq_dbg"]
            got = dict(dp=s["dp"], dv=s["dv"], dq=s["dq"], cov=s["cov"], jac=jac)
        blocks = [(0, 3, 9, 12), (0, 3, 12, 15), (3, 6, 9, 12), (3, 6, 12, 15), (6, 9, 9, 12)]
        gaps.append(max([_rel(torch.as_tensor(got[f]).double(), want[f].double()) for f in ("dp", "dv", "dq", "cov")]
                        + [_rel(torch.as_tensor(got["jac"]).double()[a:b, c:d], want["jac"][a:b, c:d])
                           for a, b, c, d in blocks]))
    return _max(gaps)


def solve_reading(captures, control=False):
    """Largest node position gap of the sampled episode's solve: the
    program's (or, with ``control``, the float32 reference's) against the
    float64 reference's, from the same state on the same tables."""
    cap = captures["solve"]
    if cap is None:
        return None
    valid = cap["tables"]["node_valid"] > 0
    want, _ = be.two_pass(be.to_dtype(cap["x"], torch.float64), be.to_dtype(cap["tables"], torch.float64),
                          cap["iterations"])
    if control:
        got, _ = be.two_pass(be.to_dtype(cap["x"], torch.float32), be.to_dtype(cap["tables"], torch.float32),
                             cap["iterations"])
    else:
        got = cap["out"]
    return float(torch.linalg.vector_norm(got["poses"][valid, :3].double() - want["poses"][valid, :3], dim=-1).max())


def prior_reading(captures, control=False):
    """The marginalization prior's largest relative gap: the program's (or,
    with ``control``, the float32 reference's) against the float64
    reference's Schur complement of the same factors at the same state."""
    cap = captures["marg"]
    if cap is None:
        return None
    run = lambda dtype: be.marginalize(be.to_dtype(cap["x"], dtype), be.to_dtype(cap["tables"], dtype),  # noqa: E731
                                       cap["num_marg"], cap["oldest"])
    H, J = run(torch.float64)
    Hg, Jg = run(torch.float32) if control else (cap["H0"], cap["Jte0"])
    return max(_rel(Hg.double(), H), _rel(Jg.double(), J))


def ate_reading(trajectory, world, t0, t1):
    """RMSE of the trajectory nodes stamped in [t0, t1] against the truth,
    in the estimator's local frame (anchored at the first fix's antenna)."""
    traj = np.asarray(trajectory, np.float64).reshape(-1, 8)
    rows = traj[(traj[:, 0] >= t0) & (traj[:, 0] <= t1)]
    if not len(rows):
        return None
    err = rows[:, 1:4] + world["gnss_local"][0] - wd.truth_at(world, rows[:, 0])
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))


def readings(captures, frames, world, model, control=False):
    out = kernel_readings(captures, frames, control)
    out["ins_gap_m"] = ins_reading(captures, world, control)
    out["preint_gap"] = preint_reading(captures, world, model, control)
    out["solve_gap_m"] = solve_reading(captures, control)
    out["prior_gap"] = prior_reading(captures, control)
    return out


def verdict(values, limits):
    """(correct, checks): every number at or under its limit; a number that
    could not be read fails."""
    checks = {name: dict(value=values.get(name), limit=limits[name]) for name in NAMES}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
