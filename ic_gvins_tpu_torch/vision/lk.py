"""Pyramidal Lucas-Kanade optical flow, batched over features.

Twin of ``ic_gvins_tpu/vision/lk.py``. Replaces cv::calcOpticalFlowPyrLK
(21x21 window, 3+1 pyramid levels, 30 iterations, eps 0.01,
OPTFLOW_USE_INITIAL_FLOW — tracking.cc:385-393), with forward/backward
consistency culling at 0.5 px (tracking.cc:396-403).

Every level runs kernel K1 (``ops/lk.py:lk_level``), which follows the
gather reference ``_track_level`` of the JAX package. The JAX package's
batched-matmul level tracker and its environment switches are TPU/CPU
lowering choices and are not ported.
"""

import torch

from ..ops.lk import lk_level

PYRAMID_LEVELS = 4     # TRACK_PYRAMID_LEVEL=3 + base


def pyr_lk(pyr_prev, pyr_next, pts_prev, pts_init, valid, levels=PYRAMID_LEVELS):
    """Track pts_prev from pyr_prev into pyr_next starting at pts_init
    (USE_INITIAL_FLOW). pyramids: lists of (H/2^l, W/2^l) f32 images;
    points (N, 2); valid (N,) bool. Returns (pts_next f32, status bool)."""
    pts_prev = pts_prev.to(pyr_prev[0].dtype)
    pts_init = pts_init.to(pyr_prev[0].dtype)
    scale = 2.0 ** (levels - 1)
    guess = pts_init / scale
    status = valid
    for lvl in range(levels - 1, -1, -1):
        s = 2.0**lvl
        pp = pts_prev / s
        guess, ok = lk_level(pyr_prev[lvl], pyr_next[lvl], pp, guess, valid)
        status = status & ok
        if lvl > 0:
            guess = guess * 2.0
    H, W = pyr_next[0].shape
    inb = (
        (guess[:, 0] >= 0) & (guess[:, 0] <= W - 1)
        & (guess[:, 1] >= 0) & (guess[:, 1] <= H - 1)
    )
    return guess, status & inb


def track_bidirectional(pyr_prev, pyr_next, pts_prev, pts_pred, valid,
                        levels=PYRAMID_LEVELS, fb_threshold=0.5, border=5):
    """Forward + backward LK with consistency check (tracking.cc:380-403).

    Returns (pts_next, ok) where ok requires: both tracks succeed, the
    backward track returns within fb_threshold px of the start, and the
    forward point is inside the 5-px border."""
    fwd, st_f = pyr_lk(pyr_prev, pyr_next, pts_prev, pts_pred, valid, levels)
    # the backward track is gated by forward success: a failed-forward
    # feature is culled either way (ok requires st_f below)
    bwd, st_b = pyr_lk(pyr_next, pyr_prev, fwd, pts_prev, valid & st_f, levels)
    H, W = pyr_next[0].shape
    dist = torch.linalg.vector_norm(bwd - pts_prev.to(bwd.dtype), dim=-1)
    on_border = (
        (fwd[:, 0] < border) | (fwd[:, 1] < border)
        | (fwd[:, 0] > W - border) | (fwd[:, 1] > H - border)
    )
    ok = st_f & st_b & (dist < fb_threshold) & ~on_border & valid
    return fwd, ok
