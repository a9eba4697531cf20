"""One pyramid level of Lucas-Kanade (kernel K1).

Replaces ``ic_gvins_tpu/ops/pallas_lk.py:lk_level_pallas`` with the
semantics of the gather reference ``ic_gvins_tpu/vision/lk.py:_track_level``
(edge padding by ``PAD``, clip-shifted patch windows, no block-edge cull).
The CUDA kernel is ``csrc/lk_level.cu``; its source note says what bounds
it on the H100 and how the design answers that. ``lk_level_plain`` is the
same function in plain PyTorch: the CPU path and the kernel's reference.
"""

import torch

from . import _build

WIN_HALF = 10          # 21x21 window
MAX_ITERS = 30
EPS = 0.01
MIN_EIG_THRESHOLD = 1e-4
PAD = WIN_HALF + 2


def lk_level_plain(img_prev, img_next, pts_prev, pts_guess, valid):
    """img_*: (H, W) f32; pts_*: (N, 2) f32 xy level coords; valid: (N,) bool.
    Returns (pts_next (N, 2) f32, ok (N,) bool)."""
    from ..vision.pyramid import _edge_pad, extract_patch

    img_prev = _edge_pad(img_prev, PAD, PAD, PAD, PAD)
    img_next = _edge_pad(img_next, PAD, PAD, PAD, PAD)
    pp = pts_prev + PAD
    pos = pts_guess + PAD

    p = extract_patch(img_prev, pp, WIN_HALF + 1)  # (N, 23, 23)
    tpl = p[:, 1:-1, 1:-1]
    gx = 0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
    gy = 0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])
    gxx = torch.sum(gx * gx, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    n_px = (2 * WIN_HALF + 1) ** 2
    min_eig = 0.5 * ((gxx + gyy) - torch.sqrt((gxx - gyy) * (gxx - gyy) + 4 * gxy * gxy)) / n_px
    ok = (min_eig > MIN_EIG_THRESHOLD) & (torch.abs(det) > 1e-12) & valid
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))

    active = torch.ones_like(ok)
    for _ in range(MAX_ITERS):
        cur = extract_patch(img_next, pos, WIN_HALF)
        diff = cur - tpl
        bx = torch.sum(diff * gx, dim=(1, 2))
        by = torch.sum(diff * gy, dim=(1, 2))
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(gxx * by - gxy * bx) * inv_det
        step = torch.stack([dx, dy], dim=1)
        # cv semantics: apply the step, THEN stop once it fell below EPS
        pos = pos + step * (active & ok)[:, None]
        active = active & (torch.linalg.vector_norm(step, dim=1) >= EPS)
    return pos - PAD, ok


def lk_level(img_prev, img_next, pts_prev, pts_guess, valid):
    """Kernel K1 wrapper. CPU tensors take ``lk_level_plain``; CUDA tensors
    launch ``csrc/lk_level.cu`` (or raise)."""
    if img_prev.device.type == "cpu":
        return lk_level_plain(img_prev, img_next, pts_prev, pts_guess, valid)
    H, W = img_prev.shape
    N = pts_prev.shape[0]
    if img_next.shape != (H, W) or pts_guess.shape != (N, 2) or valid.shape != (N,):
        raise ValueError("lk_level: shape mismatch")
    if (img_prev.dtype, img_next.dtype, pts_prev.dtype, pts_guess.dtype, valid.dtype) != (
            torch.float32,) * 4 + (torch.bool,):
        raise TypeError("lk_level: images and points must be float32, valid bool")
    _build.require_cuda("lk_level", img_prev, img_next, pts_prev, pts_guess, valid)
    out = torch.empty((N, 2), dtype=torch.float32, device=img_prev.device)
    ok = torch.empty((N,), dtype=torch.bool, device=img_prev.device)
    _build.launch("lk_level", img_prev.data_ptr(), img_next.data_ptr(), H, W,
                  pts_prev.data_ptr(), pts_guess.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), ok.data_ptr(), N, _build.stream_ptr(img_prev))
    lk_level.launches += 1
    return out, ok


lk_level.launches = 0
