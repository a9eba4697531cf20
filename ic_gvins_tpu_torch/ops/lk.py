"""Bidirectional pyramidal Lucas-Kanade (kernel K1).

Replaces ``ic_gvins_tpu/ops/pallas_lk.py:lk_level_pallas`` with the
semantics of the gather reference ``ic_gvins_tpu/vision/lk.py:_track_level``
(edge padding by ``PAD``, clip-shifted patch windows, no block-edge cull),
together with the cascade of ``pyr_lk`` / ``track_bidirectional`` around it.
The CUDA kernel is ``csrc/lk_pyr.cu``: one launch runs a frame's whole
track, every level and both directions; its source note says what bounds it
on the H100 and how the design answers that. ``lk_level_plain`` is one level
in plain PyTorch and ``lk_pyr_plain`` composes it: the CPU path and the
kernel's reference.
"""

import torch

from . import _build

WIN_HALF = 10          # 21x21 window
MAX_ITERS = 30
EPS = 0.01
MIN_EIG_THRESHOLD = 1e-4
PAD = WIN_HALF + 2
PYRAMID_LEVELS = 4     # TRACK_PYRAMID_LEVEL=3 + base
MAX_LEVELS = 4         # level pointers the kernel takes


def lk_level_plain(img_prev, img_next, pts_prev, pts_guess, valid):
    """img_*: (H, W) f32; pts_*: (N, 2) f32 xy level coords; valid: (N,) bool.
    Returns (pts_next (N, 2) f32, ok (N,) bool). A leading world axis on
    every argument runs every world at once."""
    from ..vision.pyramid import _edge_pad, extract_patch

    img_prev = _edge_pad(img_prev, PAD, PAD, PAD, PAD)
    img_next = _edge_pad(img_next, PAD, PAD, PAD, PAD)
    pp = pts_prev + PAD
    pos = pts_guess + PAD

    p = extract_patch(img_prev, pp, WIN_HALF + 1)  # (..., N, 23, 23)
    tpl = p[..., 1:-1, 1:-1]
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    gxx = torch.sum(gx * gx, dim=(-2, -1))
    gyy = torch.sum(gy * gy, dim=(-2, -1))
    gxy = torch.sum(gx * gy, dim=(-2, -1))
    det = gxx * gyy - gxy * gxy
    n_px = (2 * WIN_HALF + 1) ** 2
    min_eig = 0.5 * ((gxx + gyy) - torch.sqrt((gxx - gyy) * (gxx - gyy) + 4 * gxy * gxy)) / n_px
    ok = (min_eig > MIN_EIG_THRESHOLD) & (torch.abs(det) > 1e-12) & valid
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))

    active = torch.ones_like(ok)
    for _ in range(MAX_ITERS):
        cur = extract_patch(img_next, pos, WIN_HALF)
        diff = cur - tpl
        bx = torch.sum(diff * gx, dim=(-2, -1))
        by = torch.sum(diff * gy, dim=(-2, -1))
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(gxx * by - gxy * bx) * inv_det
        step = torch.stack([dx, dy], dim=-1)
        # cv semantics: apply the step, THEN stop once it fell below EPS
        pos = pos + step * (active & ok)[..., None]
        active = active & (torch.linalg.vector_norm(step, dim=-1) >= EPS)
    return pos - PAD, ok


def _pyr_lk_plain(pyr_prev, pyr_next, pts_prev, pts_init, valid, levels):
    """One direction: levels-1 .. 0, each gated by the original ``valid``."""
    pts_prev = pts_prev.to(pyr_prev[0].dtype)
    pts_init = pts_init.to(pyr_prev[0].dtype)
    scale = 2.0 ** (levels - 1)
    guess = pts_init / scale
    status = valid
    for lvl in range(levels - 1, -1, -1):
        s = 2.0**lvl
        pp = pts_prev / s
        guess, ok = lk_level_plain(pyr_prev[lvl], pyr_next[lvl], pp, guess, valid)
        status = status & ok
        if lvl > 0:
            guess = guess * 2.0
    H, W = pyr_next[0].shape[-2:]
    inb = (
        (guess[..., 0] >= 0) & (guess[..., 0] <= W - 1)
        & (guess[..., 1] >= 0) & (guess[..., 1] <= H - 1)
    )
    return guess, status & inb


def lk_pyr_plain(pyr_prev, pyr_next, pts_prev, pts_pred, valid, directions=2,
                 levels=PYRAMID_LEVELS, fb_threshold=0.5, border=5):
    """pyr_*: lists of (H/2^l, W/2^l) f32 levels; pts_*: (N, 2) level-0 xy;
    valid: (N,) bool. ``directions=1`` is pyr_lk (tracked points and
    status); ``directions=2`` adds the backward track and the consistency
    check (tracking.cc:380-403). Returns (fwd (N, 2) f32, ok (N,) bool).
    With a leading world axis (levels (B, h, w), points (B, N, 2), valid
    (B, N)) every world is tracked at once."""
    fwd, st_f = _pyr_lk_plain(pyr_prev, pyr_next, pts_prev, pts_pred, valid, levels)
    if directions == 1:
        return fwd, st_f
    # the backward track is gated by forward success: a failed-forward
    # feature is culled either way (ok requires st_f below)
    bwd, st_b = _pyr_lk_plain(pyr_next, pyr_prev, fwd, pts_prev, valid & st_f, levels)
    H, W = pyr_next[0].shape[-2:]
    dist = torch.linalg.vector_norm(bwd - pts_prev.to(bwd.dtype), dim=-1)
    on_border = (
        (fwd[..., 0] < border) | (fwd[..., 1] < border)
        | (fwd[..., 0] > W - border) | (fwd[..., 1] > H - border)
    )
    ok = st_f & st_b & (dist < fb_threshold) & ~on_border & valid
    return fwd, ok


def lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid, directions=2,
           levels=PYRAMID_LEVELS, fb_threshold=0.5, border=5, iters=None):
    """Kernel K1 wrapper, the arguments of ``lk_pyr_plain`` (a leading world
    axis included: one launch for all worlds). CPU tensors take
    ``lk_pyr_plain``; CUDA tensors launch ``csrc/lk_pyr.cu`` once (or raise).
    ``iters``, an int32 CUDA tensor shaped like ``valid``, receives each
    slot's number of LK steps (both directions, all levels); the plain
    version does not count."""
    if pyr_prev[0].device.type == "cpu":
        if iters is not None:
            raise ValueError("lk_pyr: iters is counted by the CUDA kernel only")
        return lk_pyr_plain(pyr_prev, pyr_next, pts_prev, pts_pred, valid, directions, levels,
                            fb_threshold, border)
    if directions not in (1, 2) or not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"lk_pyr: directions must be 1 or 2 and levels 1..{MAX_LEVELS}")
    if len(pyr_prev) < levels or len(pyr_next) < levels:
        raise ValueError("lk_pyr: pyramids shorter than levels")
    pyr_prev, pyr_next = list(pyr_prev[:levels]), list(pyr_next[:levels])
    H, W = pyr_prev[0].shape[-2:]
    lead = pyr_prev[0].shape[:-2]
    h, w = H, W
    for a, b in zip(pyr_prev, pyr_next):
        if a.shape != lead + (h, w) or b.shape != lead + (h, w):
            raise ValueError(f"lk_pyr: level shape {tuple(a.shape)} / {tuple(b.shape)}, "
                             f"pyr_down gives {lead + (h, w)}")
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    N = pts_prev.shape[-2]
    if len(lead) > 1 or pts_prev.shape != lead + (N, 2) or pts_pred.shape != lead + (N, 2) or (
            valid.shape != lead + (N,)):
        raise ValueError("lk_pyr: shape mismatch")
    if any(t.dtype != torch.float32 for t in (*pyr_prev, *pyr_next, pts_prev, pts_pred)) or (
            valid.dtype != torch.bool):
        raise TypeError("lk_pyr: images and points must be float32, valid bool")
    tensors = (*pyr_prev, *pyr_next, pts_prev, pts_pred, valid)
    if iters is not None:
        if iters.shape != lead + (N,) or iters.dtype != torch.int32:
            raise ValueError("lk_pyr: iters must be an int32 tensor shaped like valid")
        tensors = (*tensors, iters)
    _build.require_cuda("lk_pyr", *tensors)
    dev = pyr_prev[0].device
    fwd = torch.empty(lead + (N, 2), dtype=torch.float32, device=dev)
    ok = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    level_ptrs = [t.data_ptr() for t in pyr_prev] + [None] * (MAX_LEVELS - levels)
    level_ptrs += [t.data_ptr() for t in pyr_next] + [None] * (MAX_LEVELS - levels)
    _build.launch("lk_pyr", *level_ptrs, H, W, levels, pts_prev.data_ptr(),
                  pts_pred.data_ptr(), valid.data_ptr(), directions, float(fb_threshold),
                  int(border), fwd.data_ptr(), ok.data_ptr(),
                  None if iters is None else iters.data_ptr(), N, lead[0] if lead else 1,
                  _build.stream_ptr(fwd))
    lk_pyr.launches += 1
    return fwd, ok


lk_pyr.launches = 0
