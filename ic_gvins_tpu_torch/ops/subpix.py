"""Subpixel corner refinement, cv::cornerSubPix (kernel K2).

Replaces ``ic_gvins_tpu/ops/pallas_subpix.py:subpix_pallas`` with the
semantics of the jnp path of ``ic_gvins_tpu/vision/features.py:corner_subpix``
(unpadded image, clip-shifted 13x13 patch, no block guard). The CUDA kernel
is ``csrc/subpix.cu``; its source note says what bounds it on the H100 and
how the design answers that. ``subpix_plain`` is the same function in plain
PyTorch: the CPU path and the kernel's reference.
"""

import torch

from . import _build

HALF = 5          # 11x11 window (cv::Size(5,5))
ITERS = 20        # cv::TermCriteria(COUNT + EPS, 20, 0.01) — tracking.cc:625
EPS = 0.01


def subpix_plain(img, corners, valid, steps=None):
    """img: (H, W) f32; corners: (N, 2) f32 xy; valid: (N,) bool.
    Returns refined (N, 2) f32. ``steps``, an (N,) int32 tensor, receives
    each corner's number of steps applied before it stopped (0 for invalid
    slots), as the kernel's ``iters``. A leading world axis (img (B, H, W),
    corners (B, N, 2), valid and steps (B, N)) runs every world at once."""
    from ..vision.pyramid import extract_patch

    d = torch.arange(2 * HALF + 1, dtype=torch.float32, device=img.device) - HALF
    w1 = torch.exp(-((d / HALF) * (d / HALF)))
    wgt = w1[:, None] * w1[None, :]
    dxg, dyg = d[None, None, :], d[None, :, None]

    pos = corners
    active = torch.ones(corners.shape[:-1], dtype=torch.bool, device=img.device)
    taken = torch.zeros(corners.shape[:-1], dtype=torch.int32, device=img.device)
    for _ in range(ITERS):
        patch = extract_patch(img, pos, HALF + 1)  # (..., N, 13, 13)
        gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
        gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
        wxx = wgt * gx * gx
        wyy = wgt * gy * gy
        wxy = wgt * gx * gy
        gxx = torch.sum(wxx, dim=(-2, -1))
        gyy = torch.sum(wyy, dim=(-2, -1))
        gxy = torch.sum(wxy, dim=(-2, -1))
        bx = torch.sum(wxx * dxg, dim=(-2, -1)) + torch.sum(wxy * dyg, dim=(-2, -1))
        by = torch.sum(wxy * dxg, dim=(-2, -1)) + torch.sum(wyy * dyg, dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        safe = torch.abs(det) > 1e-12
        den = torch.where(safe, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        ddx = torch.where(safe, (gyy * bx - gxy * by) / den, zero)
        ddy = torch.where(safe, (gxx * by - gxy * bx) / den, zero)
        step = torch.clamp(torch.stack([ddx, ddy], dim=-1), -1.0, 1.0)
        # cv TermCriteria(COUNT + EPS, 20, 0.01): apply the step, stop once
        # it fell below eps (tracking.cc:625)
        pos = torch.where(active[..., None], pos + step, pos)
        taken += active.to(torch.int32)
        active = active & (torch.linalg.vector_norm(step, dim=-1) >= EPS)
    if steps is not None:
        steps.copy_(torch.where(valid, taken, torch.zeros_like(taken)))
    # keep refinement only if it stayed close (guards divergence)
    moved = torch.linalg.vector_norm(pos - corners, dim=-1)
    out = torch.where((moved < HALF)[..., None], pos, corners)
    return torch.where(valid[..., None], out, corners)


def subpix(img, corners, valid, iters=None):
    """Kernel K2 wrapper, the arguments of ``subpix_plain`` (a leading world
    axis included: one launch for all worlds). CPU tensors take
    ``subpix_plain``; CUDA tensors launch ``csrc/subpix.cu`` (or raise).
    ``iters``, an int32 tensor shaped like ``valid`` on the inputs' device,
    receives each corner's number of steps."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    N = corners.shape[-2]
    if iters is not None and (iters.shape != lead + (N,) or iters.dtype != torch.int32):
        raise ValueError("subpix: iters must be an int32 tensor shaped like valid")
    if img.device.type == "cpu":
        return subpix_plain(img, corners, valid, steps=iters)
    if img.dim() not in (2, 3) or corners.shape != lead + (N, 2) or valid.shape != lead + (N,):
        raise ValueError("subpix: shape mismatch")
    if (img.dtype, corners.dtype, valid.dtype) != (torch.float32, torch.float32, torch.bool):
        raise TypeError("subpix: img and corners must be float32, valid bool")
    if H < 2 * HALF + 4 or W < 2 * HALF + 4:
        raise ValueError("subpix: image smaller than the 14x14 sampling slice")
    tensors = (img, corners, valid) if iters is None else (img, corners, valid, iters)
    _build.require_cuda("subpix", *tensors)
    out = torch.empty(lead + (N, 2), dtype=torch.float32, device=img.device)
    _build.launch("subpix", img.data_ptr(), H, W, corners.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), None if iters is None else iters.data_ptr(), N,
                  img.shape[0] if lead else 1, _build.stream_ptr(img))
    subpix.launches += 1
    return out


subpix.launches = 0
