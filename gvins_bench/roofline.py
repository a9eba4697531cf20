"""Least times of the three frontend kernels on the inputs a run gave them.

The peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W:
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores. A
kernel's least time is the larger of the bytes its inputs need over the
first and the float32 operations they need over the second. Bytes count
each input byte read once and each output byte written once; where the work
depends on the data (LK's and cornerSubPix's early stops) the counts are of
what these inputs needed, taken from the plain reference's own run on them.
The counting rules are those the kernels were sized by (bytes under the
first step's windows; a step's operations per window pixel).
"""

import math

import torch

from . import reference as ref

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# each kernel wrapper's CUDA kernel, as the device trace names it
KERNELS = {"clahe_apply": "clahe_apply_kernel", "lk_pyr": "lk_pyr_kernel", "subpix": "subpix_kernel"}


def least_s(n_bytes, n_ops):
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def slice_pixels(img, pts, half, pad):
    """Flat indices into ``img`` of the (2*half+2)^2 slices read around
    ``pts`` of ``img`` edge-padded by ``pad`` px, clipped inward as
    ``reference.extract_patch`` clips them, the padding an index clamp."""
    H, W = img.shape
    size = 2 * half + 2
    r = torch.arange(size, device=img.device)
    x0 = torch.clamp(torch.floor(pts[:, 0] + pad).long() - half, 0, W + 2 * pad - size)
    y0 = torch.clamp(torch.floor(pts[:, 1] + pad).long() - half, 0, H + 2 * pad - size)
    xs = torch.clamp(x0[:, None] + r - pad, 0, W - 1)
    ys = torch.clamp(y0[:, None] + r - pad, 0, H - 1)
    return (ys[:, :, None] * W + xs[:, None, :]).reshape(-1)


def clahe_apply(v_shape, v_size, lut_shape, lut_size):
    """The CLAHE blend of gray values of ``v_shape`` (``v_size`` bytes each)
    through tables of ``lut_shape``: the values and tables read, the float32
    output written; per pixel 4 weight products, 4 weighted taps and 3 sums."""
    hw, n_lut = math.prod(v_shape), math.prod(lut_shape)
    return hw * v_size + n_lut * lut_size + hw * 4, 11 * hw


def lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid):
    """The fused bidirectional LK: every level pixel under a template slice
    (24x24 at a gated slot's point) or under its first step's window slice
    (22x22 at the level's first guess, slots whose template passed) read
    once, the points and flags read once, the outputs written once. Per
    slot-level 529 bilinear samples of 7 operations and 441 pixels of 10
    (gradient and normal matrix); per step 441 pixels of 12."""
    log = []
    ref.lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid, log=log)
    read, slot_levels, steps = {}, 0, 0
    for img_prev, img_next, pts_prev_l, guess, gate, ok, n_steps in log:
        for img, pts, mask, half in ((img_prev, pts_prev_l, gate, ref.LK_WIN_HALF + 1),
                                     (img_next, guess, ok, ref.LK_WIN_HALF)):
            read.setdefault(img.data_ptr(), []).append(slice_pixels(img, pts[mask], half, ref.LK_PAD))
        slot_levels += int(gate.sum())
        steps += int(n_steps.sum())
    n_px = sum(int(torch.unique(torch.cat(idx)).numel()) for idx in read.values())
    n_bytes = 4 * n_px + nbytes(pts_prev, pts_pred, valid) + valid.numel() * (2 * 4 + 1)
    return n_bytes, slot_levels * (529 * 7 + 441 * 10) + steps * 441 * 12


def subpix(img, corners, valid):
    """cornerSubPix: the 14x14 slices at the valid corners (the first
    step's; later steps move under a pixel a step), the corners and flags
    read, the output written; per step 169 patch samples of 7 operations and
    121 window pixels of 20."""
    _, steps = ref.subpix(img, corners, valid)
    n_px = int(torch.unique(slice_pixels(img, corners[valid], ref.SUBPIX_HALF + 1, 0)).numel())
    return 4 * n_px + nbytes(corners, valid) + nbytes(corners), int(steps.sum()) * (169 * 7 + 121 * 20)


def least_s_by_kernel(kernel_args, frames, device):
    """Least seconds of each kernel over the calls recorded in a profiled
    sub-window: CLAHE from its shapes; LK and cornerSubPix from their point
    tensors and the reference's pyramids of the calls' frames, worked out
    again from the raw frames (the program's agree with them to 1e-4 gray,
    ``check.pyramid_gap``). Calls whose frame is unknown are left out of
    both sums, which the caller reports."""
    pyramids = {}

    def pyr(k, levels):
        if k not in pyramids:
            pyramids.clear() if len(pyramids) > 8 else None
            pyramids[k] = ref.pyramid(torch.tensor(frames[k], dtype=torch.float32, device=device), levels=levels)
        return pyramids[k]

    least = {"clahe_apply": 0.0, "lk_pyr": 0.0, "subpix": 0.0}
    skipped = 0
    for args in kernel_args["clahe_apply"]:
        least["clahe_apply"] += least_s(*clahe_apply(*args))
    for (k_prev, k_next), levels, pts_prev, pts_pred, valid in kernel_args["lk_pyr"]:
        if k_prev is None or k_next is None:
            skipped += 1
            continue
        least["lk_pyr"] += least_s(*lk_pyr(pyr(k_prev, levels), pyr(k_next, levels), pts_prev, pts_pred, valid))
    for k, corners, valid in kernel_args["subpix"]:
        if k is None:
            skipped += 1
            continue
        least["subpix"] += least_s(*subpix(pyr(k, ref.LK_LEVELS)[0], corners, valid))
    return least, skipped
