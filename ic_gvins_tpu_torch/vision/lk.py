"""Pyramidal Lucas-Kanade optical flow, batched over features.

Twin of ``ic_gvins_tpu/vision/lk.py``. Replaces cv::calcOpticalFlowPyrLK
(21x21 window, 3+1 pyramid levels, 30 iterations, eps 0.01,
OPTFLOW_USE_INITIAL_FLOW — tracking.cc:385-393), with forward/backward
consistency culling at 0.5 px (tracking.cc:396-403).

Both entry points are kernel K1 (``ops/lk.py:lk_pyr``): one launch tracks
every level, and with ``track_bidirectional`` both directions; its levels
follow the gather reference ``_track_level`` of the JAX package. The JAX
package's batched-matmul level tracker and its environment switches are
TPU/CPU lowering choices and are not ported.
"""

from ..ops.lk import PYRAMID_LEVELS, lk_pyr


def pyr_lk(pyr_prev, pyr_next, pts_prev, pts_init, valid, levels=PYRAMID_LEVELS):
    """Track pts_prev from pyr_prev into pyr_next starting at pts_init
    (USE_INITIAL_FLOW). pyramids: lists of (H/2^l, W/2^l) f32 images;
    points (N, 2); valid (N,) bool. Returns (pts_next f32, status bool)."""
    return lk_pyr(pyr_prev, pyr_next, pts_prev, pts_init, valid, directions=1, levels=levels)


def track_bidirectional(pyr_prev, pyr_next, pts_prev, pts_pred, valid,
                        levels=PYRAMID_LEVELS, fb_threshold=0.5, border=5):
    """Forward + backward LK with consistency check (tracking.cc:380-403).

    Returns (pts_next, ok) where ok requires: both tracks succeed, the
    backward track returns within fb_threshold px of the start, and the
    forward point is inside the 5-px border."""
    return lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid, directions=2, levels=levels,
                  fb_threshold=fb_threshold, border=border)
