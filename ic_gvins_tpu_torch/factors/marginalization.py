"""Schur-complement marginalization in information form.

Port of ``ic_gvins_tpu/factors/marginalization.py`` (parity target: IC-GVINS
``factors/marginalization_info.h:73-253``): evaluate the factors touching the
marginalized parameters, assemble H/b, Schur-eliminate the marginalized
block, and carry the reduced system forward as a prior (H0, Jte0, c0) on the
remained node/extrinsic/td support (NP = lm_off), linearized at x0.

The safeguards of the JAX package are kept: the
factorizations run on Jacobi-equilibrated matrices with RELATIVE ridges
(``RIDGE`` pins null directions of the prior, ``RIDGE_FACT`` regularizes the
factorization, whose bias the refinement against the unridged matrix and
one Newton pseudo-inverse step remove), and the prior's node columns follow
every node-slot permutation (``shift_prior``, ``drop_node_from_prior``,
``insert_node_slot_into_prior``). The factors are float64 (``cholesky_ex``);
a failed factorization is retried at 1e3x the ridge, selected on the device
with ``torch.where``, with no host branch.
"""

import torch
import torch.nn.functional as F

from ..engine.host import fetch
from ..solver.problem import POSE_LOCAL, FactorTables, MargPrior, WindowConfig, WindowParams, build_normal_blocks

RIDGE = 1e-9       # prior null-direction pin (relative, equilibrated scale)
RIDGE_FACT = 1e-6  # factorization ridge (relative, equilibrated scale)


def _equilibrated_chol(A, ridge=RIDGE_FACT):
    """Cholesky factor of the Jacobi-equilibrated, ridged ``A``.

    Returns (L, d, An): An = A/(d dᵀ) symmetrized,
    L = chol(An + ridge·I), or chol(An + 1e3·ridge·I) where the first
    factorization failed. An absolute eigenvalue cut (the reference's 1e-8,
    marginalization_info.h:180-187) lets factorization junk on exact-null
    directions of a ~1e9-scale H land on either side of the threshold;
    equilibrating first maps real information to O(1) and keeps junk tiny,
    so a relative ridge regularizes cleanly (the gates of
    tests/test_marginalization.py)."""
    dg = torch.diagonal(A)
    dmax = torch.clamp(torch.max(dg), min=1.0)  # floor 1: empty blocks stay finite
    d = torch.sqrt(torch.maximum(dg, dmax * 1e-30))
    An = A / (d[:, None] * d[None, :])
    An = 0.5 * (An + An.T)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    L1, info1 = torch.linalg.cholesky_ex(An + ridge * eye)
    L2, _ = torch.linalg.cholesky_ex(An + (ridge * 1e3) * eye)
    return torch.where(info1 == 0, L1, L2), d, An


def _refined_solve(L, An, rhs, iters=2):
    """Solve (An + ridge·I) y = rhs, then ``iters`` refinement passes against
    the UNRIDGED An: a direction of strength w converges as (ridge/(w+ridge))
    per pass, so determined directions reach the exact solution and the
    ridge bias survives only within ~a decade of the ridge."""
    y = torch.cholesky_solve(rhs, L)
    for _ in range(iters):
        y = y + torch.cholesky_solve(rhs - An @ y, L)
    return y


def marginalize(params: WindowParams, marg_tables: FactorTables, marg_mask, cfg: WindowConfig):
    """The linearized prior from the factors in ``marg_tables`` (only the
    factors touching marginalized parameters valid: old prior, GNSS at marged
    nodes, preintegrations below the cut, init priors, oldest-keyframe
    reprojections, ic_gvins.cc:1482-1610). marg_mask: (D,) 0/1, 1 for
    marginalized local coordinates. Returns a MargPrior linearized at
    ``params``."""
    Hss, Hsl, hll, b, act = build_normal_blocks(params, marg_tables, cfg)
    node_idx = torch.arange(cfg.marg_cap * cfg.node_dim, device=Hss.device)
    H0, bp, c0 = _schur_reduce(Hss, Hsl, hll, b, marg_mask, (1.0 - marg_mask) * act, node_idx, cfg)
    return MargPrior(H0=H0, Jte0=-bp, c0=c0, x0=params, valid=torch.ones_like(c0))


def _schur_reduce(Hss, Hsl, hll, b, m, r, node_idx, cfg):
    """Schur-eliminate the masked coordinates; return (H0, bp, c0) on the
    prior's (NP, NP) support with H0 = Hp + relative ridge pin and
    c0 = bpᵀHp⁺bp (the reference's |e0|², marginalization_info.h:153-167).

    Block form in (build_normal_blocks): Hss (NP,NP), Hsl (NP,L), hll (L,)
    the diagonal landmark block, b (D,); m, r: (D,) 0/1 marginalized and
    remained masks. Marged non-landmark coordinates lie inside ``node_idx``
    (the leading marg_cap node blocks for a window slide; one interior node
    block for a merge); landmarks eliminate by a diagonal scaling; the
    remained support has no landmark column. The marged-node block S is
    applied as a pseudo-inverse: refined solves of the RIDGE_FACT-ridged
    system and one Newton step X <- X(2I - S X)."""
    NP = cfg.lm_off
    lo = cfg.lm_off
    m_n = m[node_idx]
    m_l = m[lo:]
    rN = r[:NP]

    # masked marg blocks: A (node x node), B (node x landmark), c (lm diag)
    A = Hss[node_idx][:, node_idx] * (m_n[:, None] * m_n[None, :])
    B = Hsl[node_idx] * (m_n[:, None] * m_l[None, :])
    c = hll * m_l
    c_inv = torch.where(c > torch.clamp(torch.max(c), min=1.0) * 1e-30,
                        1.0 / torch.where(c > 0, c, torch.ones_like(c)), torch.zeros_like(c))
    # landmark-eliminated marged node block
    S = A - (B * c_inv[None, :]) @ B.T

    # remained (rows, <= NP) x marged (cols) coupling blocks
    Un = Hss[:, node_idx] * (rN[:, None] * m_n[None, :])
    Ul = Hsl * (rN[:, None] * m_l[None, :])
    Ulc = Ul * c_inv[None, :]
    W = Un - Ulc @ B.T
    bm = b * m
    bl = bm[lo:]
    u = bm[:NP][node_idx] - B @ (c_inv * bl)

    # S⁺ applied to [Wᵀ | u] in solve form, equilibrated scale throughout
    Ls, dS, Sn = _equilibrated_chol(S)
    rhs = torch.cat([W.T, u[:, None]], dim=1) / dS[:, None]
    Y = _refined_solve(Ls, Sn, rhs)
    Y2 = 2.0 * Y - _refined_solve(Ls, Sn, Sn @ Y)      # one Newton pseudo-inverse step
    Yu = Y2 / dS[:, None]                              # S⁺ = dS⁻¹ Sn⁺ dS⁻¹
    G = Yu[:, :NP]        # S⁺ Wᵀ
    x_n = Yu[:, NP]       # S⁺ u

    Hp = Hss * (rN[:, None] * rN[None, :]) - Ulc @ Ul.T - W @ G
    Hp = 0.5 * (Hp + Hp.T)
    bp = (b * r)[:NP] - W @ x_n - Ul @ (c_inv * bl)

    # prior pin + constant c0 = bpᵀHp⁺bp (a cost constant: it moves only LM's
    # relative-decrease test)
    dgp = torch.diagonal(Hp)
    dpmax = torch.clamp(torch.max(dgp), min=1.0)
    dp = torch.sqrt(torch.maximum(dgp, dpmax * 1e-30))
    H0 = Hp + torch.diag(RIDGE * dp * dp)
    Lp, dpe, Hn = _equilibrated_chol(Hp)
    yhat = _refined_solve(Lp, Hn, (bp / dpe)[:, None])[:, 0]
    c0 = torch.clamp(torch.dot(bp / dpe, yhat), min=0.0)
    c0 = torch.where(torch.isfinite(c0), c0, torch.zeros_like(c0))
    return H0, bp, c0


def _unit_pose(n, like):
    pose = torch.zeros((n, 7), dtype=like.dtype, device=like.device)
    pose[:, 6] = 1.0
    return pose


def drop_node_from_prior(prior: MargPrior, cfg: WindowConfig, k: int):
    """Remove interior node ``k`` (a host int) from the prior after a node
    merge (removeUnusedTimeNode, ic_gvins.cc:754-789): Schur-marginalize its
    coordinates out of the prior, then move the node columns above it one
    slot left, or the prior constrains the wrong nodes."""
    D, NP, ND = cfg.D, cfg.lm_off, cfg.node_dim
    dev = prior.H0.device
    idx = k * ND + torch.arange(ND, device=dev)
    m = torch.zeros(D, dtype=prior.H0.dtype, device=dev)
    m[idx] = 1.0
    # only coordinates the prior constrains (a RELATIVE diagonal threshold)
    dg = torch.diagonal(prior.H0)
    act = (dg > 1e-24 * torch.clamp(torch.max(dg), min=1e-30)).to(dg.dtype)
    zL = torch.zeros(cfg.L, dtype=dg.dtype, device=dev)
    H0, bp, c0 = _schur_reduce(prior.H0, torch.zeros((NP, cfg.L), dtype=dg.dtype, device=dev), zL,
                               torch.cat([-prior.Jte0, zL]), m, (1.0 - m) * torch.cat([act, zL]), idx, cfg)

    nd = cfg.N * ND
    lo, hi = k * ND, (k + 1) * ND

    def comp_cols(M):
        return torch.cat([M[:, :lo], M[:, hi:nd], torch.zeros((M.shape[0], ND), dtype=M.dtype, device=dev),
                          M[:, nd:]], dim=1)

    H0 = comp_cols(comp_cols(H0).T)
    nbp = -bp
    Jte0 = torch.cat([nbp[:lo], nbp[hi:nd], torch.zeros(ND, dtype=nbp.dtype, device=dev), nbp[nd:]])
    x0 = prior.x0._replace(
        poses=torch.cat([prior.x0.poses[:k], prior.x0.poses[k + 1:], _unit_pose(1, H0)]),
        mixes=torch.cat([prior.x0.mixes[:k], prior.x0.mixes[k + 1:], torch.zeros_like(prior.x0.mixes[:1])]))
    return prior._replace(H0=H0, Jte0=Jte0, c0=c0, x0=x0)


def shift_prior(prior: MargPrior, cfg: WindowConfig, shift: int):
    """Shift node slots left by ``shift`` (a host int) after the window
    slides: node rows+columns of H0 and the node entries of Jte0/x0 roll
    left, vacated tail slots are zeroed; ext/td and c0 are unchanged."""
    N, ND = cfg.N, cfg.node_dim
    nd = N * ND
    keep = (torch.arange(N, device=prior.H0.device) < (N - shift)).to(prior.H0.dtype)
    keep_cols = keep.repeat_interleave(ND)

    def roll_cols(M):
        return torch.cat([torch.roll(M[:, :nd], -shift * ND, dims=1) * keep_cols[None, :], M[:, nd:]], dim=1)

    H0 = roll_cols(roll_cols(prior.H0).T)
    Jte0 = torch.cat([torch.roll(prior.Jte0[:nd], -shift * ND) * keep_cols, prior.Jte0[nd:]])
    poses0 = torch.where(keep[:, None] > 0, torch.roll(prior.x0.poses, -shift, dims=0), _unit_pose(N, H0))
    mixes0 = torch.roll(prior.x0.mixes, -shift, dims=0) * keep[:, None]
    return prior._replace(H0=H0, Jte0=Jte0, x0=prior.x0._replace(poses=poses0, mixes=mixes0))


def check_insert_capacity(prior: MargPrior, cfg: WindowConfig):
    """Callers of ``insert_node_slot_into_prior`` must guarantee the last
    node slot is free, or the shift silently drops prior information on it.
    The threshold is RELATIVE: a fresh prior carries pin-level junk (~1e-15
    of its scale) in inactive tail columns. A host check (one read)."""
    ND = cfg.node_dim
    nd = cfg.N * ND
    tail, scale = (float(x) for x in fetch(torch.abs(prior.H0[:, nd - ND: nd]).max(),
                                           torch.abs(prior.H0).max()))
    if tail > 1e-9 * max(scale, 1e-30):
        raise RuntimeError(
            f"insert_node_slot_into_prior would drop nonzero prior columns on the last node slot "
            f"(max |H0|={tail:g} vs scale {scale:g}); caller must ensure free capacity before inserting")


def insert_node_slot_into_prior(prior: MargPrior, cfg: WindowConfig, k: int):
    """Shift node columns >= k one slot RIGHT after a node insertion at slot
    ``k`` (a host int; insertNewGnssTimeNode's mid-interval case,
    ic_gvins.cc:864-876). The new slot's columns are zero."""
    ND = cfg.node_dim
    nd = cfg.N * ND
    lo = k * ND
    dev = prior.H0.device

    def ins_cols(M):
        return torch.cat([M[:, :lo], torch.zeros((M.shape[0], ND), dtype=M.dtype, device=dev),
                          M[:, lo: nd - ND], M[:, nd:]], dim=1)

    H0 = ins_cols(ins_cols(prior.H0).T)
    Jte0 = torch.cat([prior.Jte0[:lo], torch.zeros(ND, dtype=H0.dtype, device=dev),
                      prior.Jte0[lo: nd - ND], prior.Jte0[nd:]])
    x0 = prior.x0._replace(
        poses=torch.cat([prior.x0.poses[:k], _unit_pose(1, H0), prior.x0.poses[k: cfg.N - 1]]),
        mixes=torch.cat([prior.x0.mixes[:k], torch.zeros_like(prior.x0.mixes[:1]),
                         prior.x0.mixes[k: cfg.N - 1]]))
    return prior._replace(H0=H0, Jte0=Jte0, x0=x0)


def select_marg_factors(tables: FactorTables, cfg: WindowConfig, num_marg: int, oldest_kf_node: int):
    """The marg_tables + marg mask for marginalizing nodes [0, num_marg) and
    the landmarks referenced by the oldest keyframe (ic_gvins.cc:1482-1610).
    Returns (marg_tables, mask (D,), lm_mask (L,))."""
    t = tables
    f64 = t.gnss.valid.dtype
    gnss = t.gnss._replace(valid=t.gnss.valid * (t.gnss.idx < num_marg), robust=torch.zeros_like(t.gnss.robust))
    preint = t.preint._replace(valid=t.preint.valid * (t.preint.idx0 < num_marg))
    r = t.reproj
    reproj = r._replace(valid=r.valid * (r.ref_idx == oldest_kf_node), robust=torch.ones_like(r.robust))
    # init priors pass through; the ImuErrorFactor is never marginalized
    prior = t.prior._replace(imuerr_valid=torch.zeros_like(t.prior.imuerr_valid))
    marg_tables = t._replace(gnss=gnss, preint=preint, reproj=reproj, prior=prior)

    dev = t.gnss.valid.device
    node_m = (torch.arange(cfg.N, device=dev) < num_marg).to(f64)
    ref_is_old = ((r.ref_idx == oldest_kf_node) & (r.valid > 0)).to(f64)
    lm_m = torch.zeros(cfg.L, dtype=f64, device=dev).scatter_reduce(0, r.lm_idx, ref_is_old, reduce="amax")
    mask = torch.cat([node_m.repeat_interleave(cfg.node_dim), F.pad(lm_m, (POSE_LOCAL + 1, 0))])
    return marg_tables, mask, lm_m
