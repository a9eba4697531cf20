"""Fixed-shape sliding-window problem: parameter layout + normal equations.

Port of ``ic_gvins_tpu/solver/problem.py`` (replacing the reference's
ceres::Problem construction, IC-GVINS ``ic_gvins.cc:1130-1239, 1697-1936``).
Every parameter and factor lives in a fixed-size padded table with validity
masks, with the JAX package's shapes and ``WindowConfig`` statics, so the
two can be compared slot by slot. Residuals and jacobians are evaluated per
table in batched tensor ops, in float64 throughout (the JAX package's f32
reprojection path is a TPU choice; its ``precise=True`` mode is the f64 one
this port follows).

The normal equations are assembled by scatter-adds (``scatter_sum``): each
factor's (node, node) blocks land in an (N*N, ND, ND) block tensor by the
flat index i*N + j of its node pair, its gradient in an (N, ND) tensor by
node. The JAX package's one-hot contractions and mask band embeds are TPU
lowering choices; padded rows carry index 0 and weight 0 and add exact
zeros. Each target adds its rows in an order fixed by the rows alone, on
the card as on the CPU, so a replay is repeatable as the JAX package's is.

Local parameter layout (D = N*ND + 7 + L columns; ND = 15, or 16 with the
wheel odometer):
  node k: [k*ND, k*ND+6)  pose tangent (dp, dtheta)
          [k*ND+6, k*ND+ND) mix (v, bg, ba[, sodo])
  ext:    [N*ND, N*ND+6)  camera-IMU extrinsic pose tangent
  td:     N*ND+6          camera-IMU time delay
  lm j:   N*ND+7+j        inverse depth

Every function of one problem here has a batched form over a leading axis
of B independent problems, ``over_problems(fn, cfg)`` (``torch.func.vmap``
with the static config held fixed): the counterpart of the JAX package's
``jax.vmap`` in ``parallel/mesh.py``. B problems then share one stream of
ops. The assembly scatters out of place (never in place into a fresh
tensor) and the jacobians' buffers come from
``new_zeros`` of an input, which is what vmap needs to batch them.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import quaternion as quat
from ..factors import basic, preint_factor, preint_odo_factor, reprojection
from ..factors.robust import correct_blocks, huber_rho
from ..ins.preintegration import PreintSummary
from ..ins.preintegration_odo import PreintOdoSummary

NODE_DIM = 15
POSE_LOCAL = 6
MIX_DIM = 9
F64 = torch.float64


class WindowConfig(NamedTuple):
    """Static table sizes (python ints)."""

    N: int = 20     # time-node slots
    L: int = 512    # landmark slots
    G: int = 24     # GNSS factor slots
    R: int = 2048   # reprojection factor slots
    with_earth: bool = True
    with_odo: bool = False  # wheel odometer: mix gains sodo, preint 19-res

    @property
    def P(self):
        return self.N - 1  # preintegration factor slots (consecutive nodes)

    @property
    def node_dim(self):
        """Per-node local dim: pose(6) + mix; the mix grows to 10 with the
        odometer (preintegration.h:32-119, integration_state.h:59-63)."""
        return NODE_DIM + 1 if self.with_odo else NODE_DIM

    @property
    def mix_dim(self):
        return MIX_DIM + 1 if self.with_odo else MIX_DIM

    @property
    def preint_res(self):
        """Preintegration residual dim: 15, or 19 with odometer."""
        return 19 if self.with_odo else 15

    @property
    def marg_cap(self):
        """Static bound on nodes marginalized per window slide: sizes the
        marged-node block factored by marginalization._schur_reduce."""
        return min(6, self.N)

    @property
    def ext_off(self):
        return self.N * self.node_dim

    @property
    def td_off(self):
        return self.ext_off + POSE_LOCAL

    @property
    def lm_off(self):
        return self.ext_off + POSE_LOCAL + 1

    @property
    def D(self):
        return self.lm_off + self.L


def over_problems(fn, *static):
    """``fn(*tensors, *static)`` over a leading axis of problems: every
    tensor leaf of the arguments and of the result gains that axis, the
    trailing ``static`` arguments (a WindowConfig, ...) are shared. The
    batched forms of build_normal_blocks, apply_gauge_blocks, block_matvec,
    total_cost and chi2_blocks, and of ``WindowParams.boxplus`` through a
    function that calls it."""
    return torch.func.vmap(lambda *tensors: fn(*tensors, *static))


def _z(*shape, device=None):
    return torch.zeros(shape, dtype=F64, device=device)


def _unit_q(n, device=None):
    q = _z(n, 4, device=device)
    q[:, 3] = 1.0
    return q


class WindowParams(NamedTuple):
    """Optimizable parameters."""

    poses: torch.Tensor      # (N,7) [p, q_xyzw]
    mixes: torch.Tensor      # (N, mix_dim) [v, bg, ba(, sodo)]
    ext: torch.Tensor        # (7,)  camera-IMU extrinsic
    td: torch.Tensor         # ()    time delay
    invdepths: torch.Tensor  # (L,)

    @staticmethod
    def zeros(cfg: WindowConfig, device=None):
        poses = torch.cat([_z(cfg.N, 3, device=device), _unit_q(cfg.N, device)], dim=1)
        ext = torch.cat([_z(3, device=device), _unit_q(1, device)[0]])
        return WindowParams(poses=poses, mixes=_z(cfg.N, cfg.mix_dim, device=device), ext=ext,
                            td=_z(device=device), invdepths=torch.full((cfg.L,), 0.1, dtype=F64, device=device))

    def boxplus(self, cfg: WindowConfig, dx):
        """Retract a local step dx (D,) onto the parameters."""
        dnodes = dx[: cfg.ext_off].reshape(cfg.N, cfg.node_dim)
        return WindowParams(
            poses=quat.boxplus_pose(self.poses, dnodes[:, :POSE_LOCAL]),
            mixes=self.mixes + dnodes[:, POSE_LOCAL:],
            ext=quat.boxplus_pose(self.ext, dx[cfg.ext_off: cfg.ext_off + POSE_LOCAL]),
            td=self.td + dx[cfg.td_off],
            invdepths=self.invdepths + dx[cfg.lm_off:])

    def boxminus(self, cfg: WindowConfig, other):
        """Local difference self ⊟ other -> (D,) (for the marg prior)."""
        dnodes = torch.cat([quat.boxminus_pose(self.poses, other.poses), self.mixes - other.mixes], dim=-1)
        return torch.cat([dnodes.reshape(-1), quat.boxminus_pose(self.ext, other.ext),
                          (self.td - other.td)[None], self.invdepths - other.invdepths])


class GnssTable(NamedTuple):
    idx: torch.Tensor     # (G,) int64 node index
    blh: torch.Tensor     # (G,3) local-frame position observation
    std: torch.Tensor     # (G,3)
    valid: torch.Tensor   # (G,) 0/1
    robust: torch.Tensor  # () 0/1: Huber on/off (pass 1 vs pass 2)

    @staticmethod
    def empty(cfg, device=None):
        return GnssTable(idx=torch.zeros(cfg.G, dtype=torch.long, device=device), blh=_z(cfg.G, 3, device=device),
                         std=torch.ones((cfg.G, 3), dtype=F64, device=device), valid=_z(cfg.G, device=device),
                         robust=torch.ones((), dtype=F64, device=device))


def empty_preint_summary(cfg, device=None):
    """The summary of P padded slots (finite, unit whitener): a
    PreintSummary, or a PreintOdoSummary with the odometer."""
    P = cfg.P
    z3, z33 = _z(P, 3, device=device), _z(P, 3, 3, device=device)
    eye = torch.eye(cfg.preint_res, dtype=F64, device=device).repeat(P, 1, 1)
    common = dict(
        dt=torch.ones(P, dtype=F64, device=device), dp=z3, dv=z3, dq=_unit_q(P, device), bg0=z3, ba0=z3,
        dp_dbg=z33, dp_dba=z33, dv_dbg=z33, dv_dba=z33, dq_dbg=z33, sqrt_info=eye, cov=eye.clone(),
        gravity=z3, iewn=z3, sum_dtpn=z3, end_p=z3, end_q=_unit_q(P, device), end_v=z3,
        end_time=_z(P, device=device))
    if cfg.with_odo:
        return PreintOdoSummary(ds=z3, sodo0=_z(P, device=device), ds_dbg=z33, ds_dsodo=z3, **common)
    return PreintSummary(**common)


class PreintTable(NamedTuple):
    summ: PreintSummary   # batched (P, ...); PreintOdoSummary with the odometer
    idx0: torch.Tensor    # (P,) int64: factor connects idx0, idx0+1
    valid: torch.Tensor   # (P,)

    @staticmethod
    def empty(cfg, device=None):
        return PreintTable(summ=empty_preint_summary(cfg, device),
                           idx0=torch.zeros(cfg.P, dtype=torch.long, device=device), valid=_z(cfg.P, device=device))


class ReprojTable(NamedTuple):
    ref_idx: torch.Tensor   # (R,) node of the landmark's reference keyframe
    obs_idx: torch.Tensor   # (R,) node of the observing keyframe
    lm_idx: torch.Tensor    # (R,) landmark slot
    pts0: torch.Tensor      # (R,3) normalized-plane point in ref frame
    pts1: torch.Tensor      # (R,3) in obs frame
    vel0: torch.Tensor      # (R,3) pixel velocity (normalized plane)
    vel1: torch.Tensor      # (R,3)
    td0: torch.Tensor       # (R,)
    td1: torch.Tensor       # (R,)
    valid: torch.Tensor     # (R,)
    sqrt_info: torch.Tensor  # () scalar 1/std in normalized plane
    robust: torch.Tensor    # () 0/1

    @staticmethod
    def empty(cfg, device=None):
        R = cfg.R
        z3 = _z(R, 3, device=device)
        pts = z3.clone()
        pts[:, 2] = 1.0
        zi = torch.zeros(R, dtype=torch.long, device=device)
        return ReprojTable(ref_idx=zi, obs_idx=torch.ones(R, dtype=torch.long, device=device), lm_idx=zi,
                           pts0=pts, pts1=pts, vel0=z3, vel1=z3, td0=_z(R, device=device), td1=_z(R, device=device),
                           valid=_z(R, device=device), sqrt_info=torch.ones((), dtype=F64, device=device),
                           robust=torch.ones((), dtype=F64, device=device))


class PriorTable(NamedTuple):
    """Initialization priors on node 0 (constructPrior, ic_gvins.cc:1911-1936)
    + the bias-bounding ImuErrorFactor on the newest mix block."""

    pose_prior: torch.Tensor      # (7,)
    pose_prior_std: torch.Tensor  # (6,)
    mix_prior: torch.Tensor       # (mix_dim,)
    mix_prior_std: torch.Tensor   # (mix_dim,)
    valid: torch.Tensor           # () 0/1
    imuerr_idx: torch.Tensor      # () int64 node of the newest mix
    imuerr_valid: torch.Tensor    # () 0/1 (off inside marginalization)

    @staticmethod
    def empty(cfg, device=None):
        one = lambda *s: torch.ones(s, dtype=F64, device=device)  # noqa: E731
        return PriorTable(pose_prior=torch.cat([_z(3, device=device), _unit_q(1, device)[0]]),
                          pose_prior_std=one(6), mix_prior=_z(cfg.mix_dim, device=device),
                          mix_prior_std=one(cfg.mix_dim), valid=_z(device=device),
                          imuerr_idx=torch.zeros((), dtype=torch.long, device=device), imuerr_valid=one())


class MargPrior(NamedTuple):
    """Marginalization prior in INFORMATION form on its true (NP = lm_off)
    node/ext/td support: cost ½(c0 + 2 dxᵀJte0 + dxᵀH0 dx), gradient
    Jte0 + H0 dx, Hessian H0, with dx = (x ⊟ x0)[:NP]: the reference's
    linearized sqrt factor e = e0 + J0 dx (marginalization_factor.h:47-101)
    in Gram form."""

    H0: torch.Tensor        # (NP,NP) prior information (J0ᵀJ0)
    Jte0: torch.Tensor      # (NP,)   prior gradient at x0 (J0ᵀe0)
    c0: torch.Tensor        # ()      prior constant |e0|²
    x0: WindowParams        # linearization point
    valid: torch.Tensor     # ()

    @staticmethod
    def empty(cfg, device=None):
        NP = cfg.lm_off
        return MargPrior(H0=_z(NP, NP, device=device), Jte0=_z(NP, device=device), c0=_z(device=device),
                         x0=WindowParams.zeros(cfg, device), valid=_z(device=device))


class FactorTables(NamedTuple):
    gnss: GnssTable
    preint: PreintTable
    reproj: ReprojTable
    prior: PriorTable
    marg: MargPrior
    antlever: torch.Tensor    # (3,)
    node_valid: torch.Tensor  # (N,)
    lm_valid: torch.Tensor    # (L,)
    ext_active: torch.Tensor  # () 0/1: estimate extrinsic
    td_active: torch.Tensor   # () 0/1: estimate time delay

    @staticmethod
    def empty(cfg, device=None):
        return FactorTables(gnss=GnssTable.empty(cfg, device), preint=PreintTable.empty(cfg, device),
                            reproj=ReprojTable.empty(cfg, device), prior=PriorTable.empty(cfg, device),
                            marg=MargPrior.empty(cfg, device), antlever=_z(3, device=device),
                            node_valid=_z(cfg.N, device=device), lm_valid=_z(cfg.L, device=device),
                            ext_active=_z(device=device), td_active=_z(device=device))


# ---------------------------------------------------------------------------
# residual / chi2 evaluation
# ---------------------------------------------------------------------------


def _gnss_residuals(params, t: GnssTable, antlever):
    return basic.gnss_residual(params.poses[t.idx], t.blh, t.std, antlever)  # (G,3)


def _preint_args(params, t: PreintTable):
    i0, i1 = t.idx0, t.idx0 + 1
    return t.summ, params.poses[i0], params.mixes[i0], params.poses[i1], params.mixes[i1]


def _preint_factor(cfg: WindowConfig):
    """The variant's factor module, the reference's Preintegration factory
    (preintegration/preintegration.h:32-119): NORMAL/EARTH the 15-res
    factor, ODO/EARTH_ODO the 19-res odometer factor."""
    return preint_odo_factor if cfg.with_odo else preint_factor


def _imu_error_fns(cfg: WindowConfig):
    """The 6-res bias prior, or the 7-res one with the sodo leg
    (imu_error_factor.h:45-92): (residual, jacobian)."""
    if cfg.with_odo:
        return basic.imu_error_residual_odo, basic.imu_error_jacobian_odo
    return basic.imu_error_residual, basic.imu_error_jacobian


def _preint_residuals(params, t: PreintTable, cfg: WindowConfig):
    return _preint_factor(cfg).residual(*_preint_args(params, t), with_earth=cfg.with_earth)  # (P, preint_res)


def _reproj_inputs(params, t: ReprojTable):
    """Translation-re-centred reprojection inputs: the factor is invariant to
    a common translation of both poses, so the baseline p0 - p1 is formed
    first (as the JAX package does before its dtype cast)."""
    pose0 = params.poses[t.ref_idx]
    pose1 = params.poses[t.obs_idx]
    dp = pose0[:, :3] - pose1[:, :3]
    return (torch.cat([dp, pose0[:, 3:7]], dim=1), torch.cat([torch.zeros_like(dp), pose1[:, 3:7]], dim=1),
            params.ext, params.invdepths[t.lm_idx], params.td,
            t.pts0, t.pts1, t.vel0, t.vel1, t.td0, t.td1, t.sqrt_info)


def _reproj_residuals(params, t: ReprojTable):
    p0, p1, ext, inv, td, *obs = _reproj_inputs(params, t)
    return reprojection.residual(p0, p1, ext, inv, td, *obs)  # (R,2)


def _reproj_blocks(params, t: ReprojTable, ext_active, td_active):
    """Robust-corrected (r (R,2), Jcat (R,2,20)); column order [pose_ref 6,
    pose_obs 6, ext 6, invdepth 1, td 1]."""
    args = _reproj_inputs(params, t)
    rr = reprojection.residual(*args)
    J0, J1, Je, Jid, Jtd = reprojection.jacobians(*args)
    Jcat = torch.cat([J0, J1, Je * ext_active, Jid, Jtd * td_active], dim=-1)
    return correct_blocks(rr, Jcat, t.robust > 0)


def chi2_blocks(params, tables: FactorTables, cfg: WindowConfig):
    """Per-factor chi2 for the outlier logic (gnssOutlierCullingByChi2 /
    removeReprojectionFactorsByChi2, ic_gvins.cc:1241-1297)."""
    rg = _gnss_residuals(params, tables.gnss, tables.antlever)
    rr = _reproj_residuals(params, tables.reproj)
    return torch.sum(rg * rg, dim=-1), torch.sum(rr * rr, dim=-1)


def _robust_sum(r, t):
    s = torch.sum(r * r, dim=-1)
    rho = torch.where(t.robust > 0, huber_rho(s)[0], s)
    return torch.sum(rho * t.valid)


def total_cost(params, tables: FactorTables, cfg: WindowConfig):
    """Robustified total cost 0.5 * sum rho(|r|^2) over valid factors."""
    cost = 0.5 * _robust_sum(_gnss_residuals(params, tables.gnss, tables.antlever), tables.gnss)
    rp = _preint_residuals(params, tables.preint, cfg)
    cost = cost + 0.5 * torch.sum(torch.sum(rp * rp, dim=-1) * tables.preint.valid)
    cost = cost + 0.5 * _robust_sum(_reproj_residuals(params, tables.reproj), tables.reproj)

    pr = tables.prior
    re = _imu_error_fns(cfg)[0](params.mixes[pr.imuerr_idx])   # newest mix
    cost = cost + 0.5 * pr.imuerr_valid * torch.sum(re * re)
    rpp = basic.pose_prior_residual(params.poses[0], pr.pose_prior, pr.pose_prior_std)
    rmp = basic.mix_prior_residual(params.mixes[0], pr.mix_prior, pr.mix_prior_std)
    cost = cost + 0.5 * pr.valid * (torch.sum(rpp * rpp) + torch.sum(rmp * rmp))

    # marginalization prior (landmark-free NP support), information form;
    # the clamp guards the ~1e-6-relative approximation in c0
    m = tables.marg
    dx = params.boxminus(cfg, m.x0)[: cfg.lm_off]
    quad = m.c0 + 2.0 * torch.dot(dx, m.Jte0) + torch.dot(dx, m.H0 @ dx)
    return cost + 0.5 * m.valid * torch.clamp(quad, min=0.0)


# ---------------------------------------------------------------------------
# normal-equation assembly
# ---------------------------------------------------------------------------


def _so3_jr_inv(rv):
    """Inverse right Jacobian of the SO(3) exponential at rotation vector rv:
    Jr(rv)^{-1} = I + ½[rv]× + c·[rv]×², c = 1/θ² − (1+cosθ)/(2θ·sinθ),
    Taylor 1/12 + θ²/720 for small θ."""
    th2 = torch.sum(rv * rv, dim=-1)
    th = torch.sqrt(torch.clamp(th2, min=1e-300))
    K = quat.skew(rv)
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)  # avoid 0/0 in the dead branch
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    1.0 / th2s - (1.0 + torch.cos(th)) / torch.clamp(2.0 * th * torch.sin(th), min=1e-300))
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device)
    return eye + 0.5 * K + c[..., None, None] * (K @ K)


def _marg_rot_correction(dx0, cfg: WindowConfig):
    """Tangent-map correction of the marginalization prior: the exact
    derivative of 0.5‖e0 + J0·(x ⊟ x0)‖² chains through D = ∂(boxminus)/∂δ,
    identity but for a Jr⁻¹(δθ) block on every rotation tangent (nodes and
    extrinsic). Dropping D, as the reference's MarginalizationFactor does,
    stalls LM off-optimum (tests/test_marginalization.py's gate). Returns
    (rc (N+1, 3) rotation column indices, C (N+1, 3, 3) Jr⁻¹ blocks)."""
    dev = dx0.device
    node_rc = (torch.arange(cfg.N, device=dev) * cfg.node_dim)[:, None] + torch.arange(3, 6, device=dev)
    rc = torch.cat([node_rc, cfg.ext_off + torch.arange(3, 6, device=dev)[None]], dim=0)
    return rc, _so3_jr_inv(dx0[rc])


def _dx_cols(M, rc, C):
    """M @ D: M[:, rc[k]] <- M[:, rc[k]] @ C[k]."""
    out = M.clone()
    out[:, rc] = torch.einsum("dni,nij->dnj", M[:, rc], C)
    return out


def _dxT_rows(M, rc, C):
    """Dᵀ @ M: M[rc[k], :] <- C[k]ᵀ @ M[rc[k], :]."""
    out = M.clone()
    out[rc, :] = torch.einsum("nij,nid->njd", C, M[rc, :])
    return out


def _dxT_vec(v, rc, C):
    """Dᵀ @ v on a vector."""
    out = v.clone()
    out[rc] = torch.einsum("nij,ni->nj", C, v[rc])
    return out


def _jtj(J, w):
    """(B, C, C) Jᵀ J of each row block, times its weight."""
    return (J.transpose(-1, -2) @ J) * w[:, None, None]


def _jtr(J, r, w):
    return (J.transpose(-1, -2) @ r[..., None])[..., 0] * w[:, None]


def scatter_sum(out, idx, vals):
    """``out`` with row i of vals added into row idx[i], each target's rows
    in an order fixed by idx alone. ``index_add`` on the CPU (in row
    order); on the card ``index_put`` with ``accumulate``, which sorts the
    rows by target and adds each target's without atomics, where
    ``index_add`` adds them by atomics in an order that changes from run
    to run. Out of place, so ``over_problems`` batches it."""
    if out.device.type == "cpu":
        return out.index_add(0, idx, vals)
    return out.index_put((idx,), vals, accumulate=True)


def _pad_block(M, ND, lead=0):
    """Embed (..., a, b) blocks at offset ``lead`` of (..., ND, ND)."""
    a, b = M.shape[-2:]
    return F.pad(M, (lead, ND - b - lead, lead, ND - a - lead))


def build_normal_equations(params, tables: FactorTables, cfg: WindowConfig):
    """Assemble the dense normal equations: (H (D,D), b (D,) = -Jᵀr, act
    (D,)), with the robust correction and masks. Each factor's whitened
    jacobian block, over the columns it touches, is scattered into H and b
    with ``scatter_sum``: the blocks ``build_normal_blocks`` places by node
    pair, assembled here a second, independent way (the JAX package's
    dense form, for tests, the marginalization checks and small
    problems)."""
    D, ND = cfg.D, cfg.node_dim
    dev = params.poses.device
    H = torch.zeros(D * D, dtype=F64, device=dev)
    b = torch.zeros(D, dtype=F64, device=dev)
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731

    def add(cols, J, r, w):
        """Blocks J (B, res, C) and r (B, res) on columns cols (B, C), weighted w (B,)."""
        nonlocal H, b
        H = scatter_sum(H, (cols[:, :, None] * D + cols[:, None, :]).reshape(-1), _jtj(J, w).reshape(-1))
        b = scatter_sum(b, cols.reshape(-1), -_jtr(J, r, w).reshape(-1))

    # ---- GNSS (3 res, 6 pose cols) ----
    t = tables.gnss
    poses = params.poses[t.idx]
    rg, Jg = correct_blocks(basic.gnss_residual(poses, t.blh, t.std, tables.antlever),
                            basic.gnss_jacobian(poses, t.std, tables.antlever), t.robust > 0)
    add(t.idx[:, None] * ND + ar(POSE_LOCAL), Jg, rg, t.valid)

    # ---- preintegration (2*ND cols over nodes idx0, idx0+1) ----
    t = tables.preint
    args = _preint_args(params, t)
    pf = _preint_factor(cfg)
    add(t.idx0[:, None] * ND + ar(2 * ND), torch.cat(pf.jacobians(*args, with_earth=cfg.with_earth), dim=-1),
        pf.residual(*args, with_earth=cfg.with_earth), t.valid)

    # ---- reprojection (2 res, 20 cols: [ref 6, obs 6, ext 6, lm 1, td 1]) ----
    t = tables.reproj
    rr, Jcat = _reproj_blocks(params, t, tables.ext_active, tables.td_active)
    cols = torch.cat([t.ref_idx[:, None] * ND + ar(POSE_LOCAL), t.obs_idx[:, None] * ND + ar(POSE_LOCAL),
                      (cfg.ext_off + ar(POSE_LOCAL)).expand(cfg.R, POSE_LOCAL), (cfg.lm_off + t.lm_idx)[:, None],
                      torch.full((cfg.R, 1), cfg.td_off, device=dev)], dim=1)
    add(cols, Jcat, rr, t.valid)

    # ---- imu error factor on the newest mix ----
    pr = tables.prior
    k = pr.imuerr_idx.reshape(1)
    res_fn, jac_fn = _imu_error_fns(cfg)
    add(k[:, None] * ND + POSE_LOCAL + ar(cfg.mix_dim), jac_fn(device=dev)[None], res_fn(params.mixes[k]),
        pr.imuerr_valid.reshape(1))

    # ---- init priors on node 0 ----
    pv = pr.valid.reshape(1)
    add(ar(POSE_LOCAL)[None], basic.pose_prior_jacobian(params.poses[0], pr.pose_prior, pr.pose_prior_std)[None],
        basic.pose_prior_residual(params.poses[0], pr.pose_prior, pr.pose_prior_std)[None], pv)
    add(POSE_LOCAL + ar(cfg.mix_dim)[None], basic.mix_prior_jacobian(pr.mix_prior_std)[None],
        basic.mix_prior_residual(params.mixes[0], pr.mix_prior, pr.mix_prior_std)[None], pv)

    # ---- marginalization prior (exact tangent chaining; NP support) ----
    H = H.reshape(D, D)
    m, NP = tables.marg, cfg.lm_off
    dx0 = params.boxminus(cfg, m.x0)[:NP]
    rc, Cj = _marg_rot_correction(dx0, cfg)
    H[:NP, :NP] += m.valid * _dxT_rows(_dx_cols(m.H0, rc, Cj), rc, Cj)
    b[:NP] -= m.valid * _dxT_vec(m.Jte0 + m.H0 @ dx0, rc, Cj)
    return H, b, column_activity(tables, cfg)


def apply_gauge(H, b, act):
    """Freeze inactive columns of the dense form: unit diagonal, zero
    gradient, so dx = 0 there."""
    return H * act[:, None] * act[None, :] + torch.diag(1.0 - act), b * act


def build_normal_blocks(params, tables: FactorTables, cfg: WindowConfig):
    """Assemble the normal equations in BLOCK form for the LM loop:
    (Hss (Ds,Ds), Hsl (Ds,L), hll (L,), b (D,) = -Jᵀr, act (D,)). The
    landmark-landmark block is diagonal by construction (each factor touches
    one landmark; the marginalization prior carries none)."""
    N, L, ND = cfg.N, cfg.L, cfg.node_dim
    Ds = cfg.lm_off
    dev = params.poses.device
    hidx, hblk = [], []   # (N*N,) flat node-pair index, (ND, ND) block
    gidx, gvec = [], []   # (N,) node index, (ND,) gradient piece
    pair = lambda i, j: i * N + j  # noqa: E731

    # ---- GNSS (3 res, 6 pose cols) ----
    t = tables.gnss
    poses = params.poses[t.idx]
    rg, Jg = correct_blocks(basic.gnss_residual(poses, t.blh, t.std, tables.antlever),
                            basic.gnss_jacobian(poses, t.std, tables.antlever), t.robust > 0)
    hidx.append(pair(t.idx, t.idx))
    hblk.append(_pad_block(_jtj(Jg, t.valid), ND))
    gidx.append(t.idx)
    gvec.append(F.pad(_jtr(Jg, rg, t.valid), (0, ND - POSE_LOCAL)))

    # ---- preintegration (15 or 19 res, 2*ND cols over nodes idx0, idx0+1) ----
    t = tables.preint
    args = _preint_args(params, t)
    pf = _preint_factor(cfg)
    rp = pf.residual(*args, with_earth=cfg.with_earth)
    Jcat = torch.cat(pf.jacobians(*args, with_earth=cfg.with_earth), dim=-1)
    JtJ, Jtr = _jtj(Jcat, t.valid), _jtr(Jcat, rp, t.valid)
    i0, i1 = t.idx0, t.idx0 + 1
    hidx += [pair(i0, i0), pair(i1, i1), pair(i0, i1), pair(i1, i0)]
    hblk += [JtJ[:, :ND, :ND], JtJ[:, ND:, ND:], JtJ[:, :ND, ND:], JtJ[:, ND:, :ND]]
    gidx += [i0, i1]
    gvec += [Jtr[:, :ND], Jtr[:, ND:]]

    # ---- reprojection (2 res, 20 cols: [ref 6, obs 6, ext 6, lm 1, td 1]) ----
    t = tables.reproj
    rr, Jcat = _reproj_blocks(params, t, tables.ext_active, tables.td_active)
    # columns reordered to [ref 6, obs 6, ext+td 7 (the tail C), lm 1]
    Jcat = torch.cat([Jcat[..., :18], Jcat[..., 19:], Jcat[..., 18:19]], dim=-1)
    Pr, gr = _jtj(Jcat, t.valid), _jtr(Jcat, rr, t.valid)   # (R,20,20), (R,20)
    A, B, C, LM = slice(0, 6), slice(6, 12), slice(12, 19), 19
    ref, obs, lm = t.ref_idx, t.obs_idx, t.lm_idx
    AB = Pr[:, A, B]
    hidx += [pair(ref, ref), pair(obs, obs), pair(ref, obs), pair(obs, ref)]
    hblk += [_pad_block(Pr[:, A, A], ND), _pad_block(Pr[:, B, B], ND), _pad_block(AB, ND),
             _pad_block(AB.transpose(-1, -2), ND)]
    gidx += [ref, obs]
    gvec += [F.pad(gr[:, A], (0, ND - 6)), F.pad(gr[:, B], (0, ND - 6))]
    Hcross = scatter_sum(Pr.new_zeros((N, 6, 7)), torch.cat([ref, obs]), torch.cat([Pr[:, A, C], Pr[:, B, C]]))
    Htail = torch.sum(Pr[:, C, C], dim=0)
    Hsl_nodes = scatter_sum(Pr.new_zeros((N * L, 6)), torch.cat([ref * L + lm, obs * L + lm]),
                            torch.cat([Pr[:, A, LM], Pr[:, B, LM]]))
    Hsl_tail = scatter_sum(Pr.new_zeros((L, 7)), lm, Pr[:, C, LM])
    hll = scatter_sum(Pr.new_zeros(L), lm, Pr[:, LM, LM])
    b_tail = -torch.sum(gr[:, C], dim=0)
    b_lm = -scatter_sum(gr.new_zeros(L), lm, gr[:, LM])

    # ---- imu error factor on the newest mix ----
    pr = tables.prior
    k = pr.imuerr_idx.reshape(1)
    res_fn, jac_fn = _imu_error_fns(cfg)
    re = res_fn(params.mixes[k])                                         # (1, 6 or 7)
    Je = jac_fn(device=dev)
    hidx.append(pair(k, k))
    hblk.append(_pad_block((Je.T @ Je)[None] * pr.imuerr_valid, ND, POSE_LOCAL))
    gidx.append(k)
    gvec.append(F.pad((re @ Je) * pr.imuerr_valid, (POSE_LOCAL, 0)))

    # ---- init priors on node 0 ----
    rpp = basic.pose_prior_residual(params.poses[0], pr.pose_prior, pr.pose_prior_std)
    Jpp = basic.pose_prior_jacobian(params.poses[0], pr.pose_prior, pr.pose_prior_std)
    rmp = basic.mix_prior_residual(params.mixes[0], pr.mix_prior, pr.mix_prior_std)
    Jmp = basic.mix_prior_jacobian(pr.mix_prior_std)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    hidx.append(zero)
    hblk.append(torch.block_diag(Jpp.T @ Jpp, Jmp.T @ Jmp)[None] * pr.valid)
    gidx.append(zero)
    gvec.append(torch.cat([Jpp.T @ rpp, Jmp.T @ rmp])[None] * pr.valid)

    # ---- scatter, then the block form by concatenation ----
    Hb = scatter_sum(Pr.new_zeros((N * N, ND, ND)), torch.cat(hidx), torch.cat(hblk))
    Hn = Hb.reshape(N, N, ND, ND).permute(0, 2, 1, 3).reshape(N * ND, N * ND)
    Hc = F.pad(Hcross, (0, 0, 0, ND - 6)).reshape(N * ND, 7)
    Hss = torch.cat([torch.cat([Hn, Hc], dim=1), torch.cat([Hc.T, Htail], dim=1)], dim=0)
    Hsl = torch.cat([F.pad(Hsl_nodes.reshape(N, L, 6).permute(0, 2, 1), (0, 0, 0, ND - 6)).reshape(N * ND, L),
                     Hsl_tail.T], dim=0)
    gn = scatter_sum(Pr.new_zeros((N, ND)), torch.cat(gidx), torch.cat(gvec))
    b = torch.cat([-gn.reshape(-1), b_tail, b_lm])

    # ---- marginalization prior (exact tangent chaining; landmark-free,
    # so it lands entirely in Hss and b[:Ds]) ----
    m = tables.marg
    dx0 = params.boxminus(cfg, m.x0)[:Ds]
    rc, Cj = _marg_rot_correction(dx0, cfg)
    Hss = Hss + m.valid * _dxT_rows(_dx_cols(m.H0, rc, Cj), rc, Cj)
    b = b - m.valid * F.pad(_dxT_vec(m.Jte0 + m.H0 @ dx0, rc, Cj), (0, L))
    return Hss, Hsl, hll, b, column_activity(tables, cfg)


def apply_gauge_blocks(Hss, Hsl, hll, b, act, cfg: WindowConfig):
    """Freeze inactive columns on the block form (unit diagonal, zero rows)."""
    acts, actl = act[: cfg.lm_off], act[cfg.lm_off:]
    Hss = Hss * acts[:, None] * acts[None, :] + torch.diag(1.0 - acts)
    Hsl = Hsl * acts[:, None] * actl[None, :]
    hll = hll * actl + (1.0 - actl)
    return Hss, Hsl, hll, b * act


def block_matvec(Hss, Hsl, hll, x, cfg: WindowConfig):
    """H @ x on the block form."""
    xs, xl = x[: cfg.lm_off], x[cfg.lm_off:]
    return torch.cat([Hss @ xs + Hsl @ xl, Hsl.T @ xs + hll * xl])


def column_activity(tables: FactorTables, cfg: WindowConfig):
    """(D,) 0/1 mask of optimizable columns."""
    t = tables
    return torch.cat([t.node_valid.repeat_interleave(cfg.node_dim), t.ext_active.expand(POSE_LOCAL),
                      t.td_active[None], t.lm_valid])
