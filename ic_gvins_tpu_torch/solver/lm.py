"""Levenberg-Marquardt trust-region solver with Schur landmark elimination.

Port of ``ic_gvins_tpu/solver/lm.py`` (replacing Ceres' LEVENBERG_MARQUARDT
+ DENSE_SCHUR, IC-GVINS ``ic_gvins.cc:1136-1146``): normal-equation
assembly, Schur reduction of the diagonal landmark block, a Cholesky solve
of the reduced state system, Ceres' step-quality test and radius update, and
manifold retraction. The JAX package runs the loop as one device program;
here it is a host loop whose only device read per iteration is the ``done``
flag. The reduced system is factored in float64 (``cholesky_ex``: no error
check, hence no extra read); the JAX package's f32 seed + f64 refinement
was a TPU choice, its ``precise=True`` mode is what this solve follows.

``solve_two_pass`` is the reference's two-pass optimization with chi2
outlier surgery between the passes (ic_gvins.cc:1180-1222).

``solve_batched``, ``outlier_surgery_batched`` and
``solve_two_pass_batched`` run B independent problems along a leading axis
with the semantics of the JAX package's ``lax.while_loop`` under ``vmap``
(``ic_gvins_tpu/parallel/mesh.py:batched_two_pass``): every problem takes
the same iteration, one that is done keeps its params, cost, radius and
accepted count by a select from then on, and the loop ends when all are
done or at ``max_iterations``, reading the device once an iteration.
"""

from typing import NamedTuple

import torch

from ..engine.host import fetch
from .problem import (
    FactorTables,
    WindowConfig,
    WindowParams,
    apply_gauge_blocks,
    block_matvec,
    build_normal_blocks,
    chi2_blocks,
    over_problems,
    total_cost,
)

# chi2 thresholds (ic_gvins.cc:1199, 1243)
GNSS_CHI2 = 7.815
REPROJ_CHI2 = 5.991
RIDGE = 1e-13      # on the equilibrated reduced system


class SolveStats(NamedTuple):
    iterations: torch.Tensor     # () int64: accepted steps
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _schur_solve(Hss, Hsl, hll, b, mu_diag, cfg: WindowConfig):
    """Solve (H + diag(mu_diag)) dx = b on the block form of H, eliminating
    the (diagonal) landmark block. The damped system is Jacobi-equilibrated
    (its landmark block becomes the identity), reduced, ridged at 1e-13 and
    factored in f64. A failed factorization or a non-finite step gives
    dx = 0 (a rejected step), selected on the device."""
    Ds = cfg.lm_off
    Hss = Hss + torch.diag(mu_diag[:Ds])
    hll = hll + mu_diag[Ds:]
    dinv = 1.0 / torch.sqrt(torch.clamp(torch.cat([torch.diagonal(Hss), hll]), min=1e-12))
    dS, dL = dinv[:Ds], dinv[Ds:]
    Hssn = Hss * (dS[:, None] * dS[None, :])
    Hsln = Hsl * (dS[:, None] * dL[None, :])
    bn = b * dinv
    eye = torch.eye(Ds, dtype=Hss.dtype, device=Hss.device)
    Lc, info = torch.linalg.cholesky_ex(Hssn - Hsln @ Hsln.T + RIDGE * eye)
    bs, bl = bn[:Ds], bn[Ds:]
    ys = torch.cholesky_solve((bs - Hsln @ bl)[:, None], Lc)[:, 0]
    yl = bl - Hsln.T @ ys
    dx = dinv * torch.cat([ys, yl])
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx))


def _select(ok, a, b):
    return type(a)(*[torch.where(ok, x, y) for x, y in zip(a, b)])


def _step(params: WindowParams, tables: FactorTables, cost, radius, cfg: WindowConfig, ftol):
    """One LM iteration from (params, cost, radius): returns the next
    (params, cost, radius) and the step's (accepted, done) flags."""
    Hss, Hsl, hll, b, act = build_normal_blocks(params, tables, cfg)
    Hss, Hsl, hll, b = apply_gauge_blocks(Hss, Hsl, hll, b, act, cfg)
    # Ceres: damping with the scaled diagonal, clamped
    diagH = torch.clamp(torch.cat([torch.diagonal(Hss), hll]), 1e-6, 1e32)
    dx = _schur_solve(Hss, Hsl, hll, b, (1.0 / radius) * diagH, cfg) * act

    candidate = params.boxplus(cfg, dx)
    new_cost = total_cost(candidate, tables, cfg)
    model_change = torch.dot(dx, b) - 0.5 * torch.dot(dx, block_matvec(Hss, Hsl, hll, dx, cfg))
    rho = (cost - new_cost) / torch.where(model_change > 0, model_change, 1e-300)
    ok = (rho > 1e-3) & (model_change > 0) & torch.isfinite(new_cost)
    params = _select(ok, candidate, params)
    # trust-region update (Ceres LevenbergMarquardtStrategy)
    grow = radius / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    radius = torch.where(ok, torch.clamp(grow, max=1e16), torch.clamp(radius / 2.0, min=1e-32))
    # convergence: tiny step, or tiny relative decrease (Ceres
    # function_tolerance, default 1e-6)
    done = (torch.amax(torch.abs(dx)) < 1e-12) | (ok & ((cost - new_cost) <= ftol * cost))
    return params, torch.where(ok, new_cost, cost), radius, ok, done


def solve(params: WindowParams, tables: FactorTables, cfg: WindowConfig, max_iterations: int,
          radius0=1e4, ftol=1e-6):
    """Run up to ``max_iterations`` LM steps; returns (params, stats, radius).
    ``ftol`` is Ceres' function_tolerance (relative-decrease stop).
    ``solve.steps`` counts the iterations run."""
    init_cost = total_cost(params, tables, cfg)
    cost = init_cost
    radius = torch.tensor(radius0, dtype=init_cost.dtype, device=init_cost.device)
    accepted = torch.zeros((), dtype=torch.long, device=init_cost.device)
    for _ in range(max_iterations):
        _solve.steps += 1
        params, cost, radius, ok, done = _step(params, tables, cost, radius, cfg, ftol)
        accepted = accepted + ok.long()
        if fetch(done)[0]:
            break
    return params, SolveStats(iterations=accepted, initial_cost=init_cost, final_cost=cost), radius


solve.steps = 0   # LM iterations run, accepted or not
_solve = solve    # counts on, whatever later wraps the module's ``solve``


def outlier_surgery(params: WindowParams, tables: FactorTables, cfg: WindowConfig):
    """Between-pass chi2 surgery (ic_gvins.cc:1190-1208): GNSS blocks with
    chi2 > 7.815 get their std inflated by sqrt(chi2/7.815); reprojection
    blocks with chi2 > 5.991 are masked out; GNSS loses its robust kernel for
    pass 2. Returns (tables, gnss_outliers, reproj_outliers), counts as
    tensors."""
    chi_g, chi_r = chi2_blocks(params, tables, cfg)
    g = tables.gnss
    bad_g = (chi_g > GNSS_CHI2) & (g.valid > 0)
    scale = torch.sqrt(torch.clamp(chi_g / GNSS_CHI2, min=1.0))
    gnss = g._replace(std=torch.where(bad_g[:, None], g.std * scale[:, None], g.std),
                      robust=torch.zeros_like(g.robust))
    r = tables.reproj
    bad_r = (chi_r > REPROJ_CHI2) & (r.valid > 0)
    reproj = r._replace(valid=torch.where(bad_r, torch.zeros_like(r.valid), r.valid))
    return tables._replace(gnss=gnss, reproj=reproj), bad_g.sum(), bad_r.sum()


def solve_two_pass(params: WindowParams, tables: FactorTables, cfg: WindowConfig, num_iterations: int):
    """The reference's two-step optimization (ic_gvins.cc:1130-1239): pass 1
    with robust kernels for 1/4 of the iterations, chi2 surgery, pass 2 with
    de-robustified GNSS for the rest."""
    n1 = max(num_iterations // 4, 1)
    n2 = max(num_iterations - n1, 1)
    params, stats1, _ = solve(params, tables, cfg, n1)
    tables2, n_gnss_out, n_reproj_out = outlier_surgery(params, tables, cfg)
    params, stats2, _ = solve(params, tables2, cfg, n2)
    return params, tables2, (stats1, stats2, n_gnss_out, n_reproj_out)


def _select_rows(live, a, b):
    """Per-problem select over a leading axis: ``a`` where ``live``."""
    def pick(x, y):
        return torch.where(live.reshape(live.shape + (1,) * (x.dim() - 1)), x, y)
    return type(a)(*[pick(x, y) for x, y in zip(a, b)])


def solve_batched(params: WindowParams, tables: FactorTables, cfg: WindowConfig, max_iterations: int,
                  radius0=1e4, ftol=1e-6):
    """:func:`solve` over a leading axis of B problems: returns (params,
    stats, radius) with that axis on every leaf. Each problem stops at its
    own ``done``; the host reads ``all(done)`` once an iteration."""
    init_cost = over_problems(total_cost, cfg)(params, tables)
    cost = init_cost
    radius = torch.full_like(init_cost, radius0)
    accepted = torch.zeros(init_cost.shape, dtype=torch.long, device=init_cost.device)
    done = torch.zeros(init_cost.shape, dtype=torch.bool, device=init_cost.device)
    step = over_problems(_step, cfg, ftol)
    for _ in range(max_iterations):
        new_params, new_cost, new_radius, ok, new_done = step(params, tables, cost, radius)
        live = ~done
        params = _select_rows(live, new_params, params)
        cost = torch.where(live, new_cost, cost)
        radius = torch.where(live, new_radius, radius)
        accepted = accepted + (ok & live).long()
        done = done | new_done
        if fetch(torch.all(done))[0]:
            break
    return params, SolveStats(iterations=accepted, initial_cost=init_cost, final_cost=cost), radius


def outlier_surgery_batched(params: WindowParams, tables: FactorTables, cfg: WindowConfig):
    """:func:`outlier_surgery` over a leading axis of problems."""
    return over_problems(outlier_surgery, cfg)(params, tables)


def solve_two_pass_batched(params: WindowParams, tables: FactorTables, cfg: WindowConfig, num_iterations: int):
    """:func:`solve_two_pass` over a leading axis of problems."""
    n1 = max(num_iterations // 4, 1)
    n2 = max(num_iterations - n1, 1)
    params, stats1, _ = solve_batched(params, tables, cfg, n1)
    tables2, n_gnss_out, n_reproj_out = outlier_surgery_batched(params, tables, cfg)
    params, stats2, _ = solve_batched(params, tables2, cfg, n2)
    return params, tables2, (stats1, stats2, n_gnss_out, n_reproj_out)
