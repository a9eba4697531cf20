"""Robust-kernel correction of whitened residual blocks.

Port of ``ic_gvins_tpu/factors/robust.py``: the Triggs corrector (the math of
IC-GVINS ``factors/residual_block_info.h:59-87``, applied by Ceres inside its
solves). Given the Huber loss at the squared norm of a whitened residual
block, the residual and jacobians are rescaled so that the Gauss-Newton
model of the robustified cost is exact to first order.
"""

import torch


def huber_rho(s, delta=1.0):
    """Huber loss on squared norm s: rho, rho', rho'' (Ceres HuberLoss)."""
    d2 = delta * delta
    r = torch.sqrt(torch.clamp(s, min=1e-300))
    big = s > d2
    out = torch.where(big, 2.0 * delta * r - d2, s)
    drho = torch.where(big, delta / r, torch.ones_like(s))
    ddrho = torch.where(big, -0.5 * delta / (s * r), torch.zeros_like(s))
    return out, drho, ddrho


def corrector_scales(s, drho, ddrho):
    """(residual_scaling, alpha/s, sqrt(rho')) of the Triggs corrector."""
    sqrt_rho1 = torch.sqrt(drho)
    trivial = (s == 0.0) | (ddrho <= 0.0)
    D = torch.clamp(1.0 + 2.0 * s * ddrho / torch.clamp(drho, min=1e-300), min=0.0)
    alpha = 1.0 - torch.sqrt(D)
    residual_scaling = torch.where(trivial, sqrt_rho1, sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = torch.where(trivial, torch.zeros_like(s), alpha / torch.clamp(s, min=1e-300))
    return residual_scaling, alpha_sq_norm, sqrt_rho1


def correct_blocks(r, J, use_kernel, delta=1.0):
    """Huber-correct a factor table: r (..., R), J (..., R, C); ``use_kernel``
    a bool tensor (or bool): where false the blocks pass through unchanged.
    Returns (r_corrected, J_corrected)."""
    s = torch.sum(r * r, dim=-1)
    _, drho, ddrho = huber_rho(s, delta)
    scale_r, alpha_sq, sqrt_rho1 = corrector_scales(s, drho, ddrho)
    rJ = (r[..., None, :] @ J)[..., 0, :]                             # (..., C)
    J_corr = sqrt_rho1[..., None, None] * (J - alpha_sq[..., None, None] * (r[..., :, None] * rJ[..., None, :]))
    r_corr = scale_r[..., None] * r
    use = torch.as_tensor(use_kernel, dtype=r.dtype, device=r.device)
    return use * r_corr + (1 - use) * r, use * J_corr + (1 - use) * J


def correct_block(r, J, use_kernel, delta=1.0):
    """The corrector on one whitened block: r (R,), J (R, C) (any packed
    column layout); where ``use_kernel`` is false the block passes through
    unchanged. Returns (r_corrected, J_corrected)."""
    r_c, J_c = correct_blocks(r[None], J[None], use_kernel, delta)
    return r_c[0], J_c[0]
