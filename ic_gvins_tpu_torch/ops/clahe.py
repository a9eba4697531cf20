"""CLAHE apply (kernel K3): per-pixel 9-LUT lookup + separable bilinear blend.

Replaces ``ic_gvins_tpu/ops/pallas_clahe.py:clahe_apply_pallas``. The CUDA
kernel is ``csrc/clahe_apply.cu``; its source note says what bounds it on
the H100 and how the design answers that. ``clahe_apply_plain`` is the same
function in plain PyTorch: the CPU path and the kernel's reference.

For pixel (y, x) of tile (i, j) with gray value v:

    out = sum over dy, dx in {0,1,2} of  w_row(y)[dy] * w_col(x)[dx]
                                         * LUT[clamp(i+dy-1), clamp(j+dx-1)][v]

LUT entries are bf16 (the reference's +-0.5 gray budget); the blend is f32.
"""

import numpy as np
import torch

from . import _build


def offset_weights(n, tn, tsize, device):
    """(n, 3) f32 blend weights over tile offsets {-1, 0, +1} relative to each
    coordinate's own tile: ``vision/pyramid.py:_tile_offset_weights``."""
    yy = torch.arange(n, dtype=torch.float32, device=device)
    tf = ((yy - tsize / 2.0) + 0.5) / tsize
    tf = tf.clamp(0.0, float(np.float32(tn - 1.000001)))
    y0 = torch.floor(tf)
    f = tf - y0
    y0 = y0.long()
    own = torch.arange(n, device=device) // tsize
    y1 = torch.clamp(y0 + 1, max=tn - 1)
    w = torch.zeros((n, 3), dtype=torch.float32, device=device)
    rows = torch.arange(n, device=device)
    for yi, wi in ((y0, 1.0 - f), (y1, f)):
        off = torch.clamp(yi - own, -1, 1) + 1
        w.index_put_((rows, off), wi, accumulate=True)
    return w


def clahe_apply_plain(v, lut, grid, tile):
    """v: (H, W) i32 gray values (clamped to [0, 255], as the kernel does);
    lut: (ty*tx, 256) bf16; grid = (ty, tx) tiles of tile = (th, tw)
    pixels. Returns (H, W) f32. With a leading world axis, v (B, H, W) and
    lut (B, ty*tx, 256) give (B, H, W)."""
    H, W = v.shape[-2:]
    lead = v.shape[:-2]
    (ty, tx), (th, tw) = grid, tile
    dev = v.device
    wr = offset_weights(H, ty, th, dev)
    wc = offset_weights(W, tx, tw, dev)
    ti = torch.arange(H, device=dev) // th
    tj = torch.arange(W, device=dev) // tw
    flat = lut.float().reshape(lead + (-1,))
    vl = v.long().clamp(0, 255)
    out = torch.zeros(lead + (H, W), dtype=torch.float32, device=dev)
    for dy in range(3):
        ni = torch.clamp(ti + dy - 1, 0, ty - 1)
        for dx in range(3):
            nj = torch.clamp(tj + dx - 1, 0, tx - 1)
            idx = (ni[:, None] * tx + nj[None, :]) * 256 + vl
            vals = torch.gather(flat, -1, idx.reshape(lead + (-1,))).reshape(idx.shape)
            out = out + (wr[:, dy, None] * wc[None, :, dx]) * vals
    return out


def clahe_apply(v, lut, grid, tile):
    """Kernel K3 wrapper, the arguments of ``clahe_apply_plain`` (a leading
    world axis included: one launch for all worlds). CPU tensors take
    ``clahe_apply_plain``; CUDA tensors launch ``csrc/clahe_apply.cu`` (or
    raise)."""
    if v.device.type == "cpu":
        return clahe_apply_plain(v, lut, grid, tile)
    (ty, tx), (th, tw) = grid, tile
    H, W = v.shape[-2:]
    lead = v.shape[:-2]
    if v.dtype != torch.int32 or lut.dtype != torch.bfloat16:
        raise TypeError("clahe_apply: v must be int32 and lut bfloat16")
    if v.dim() not in (2, 3) or tuple(lut.shape) != lead + (ty * tx, 256) or H > ty * th or W > tx * tw:
        raise ValueError("clahe_apply: lut / tile grid do not cover the image")
    _build.require_cuda("clahe_apply", v, lut)
    out = torch.empty(lead + (H, W), dtype=torch.float32, device=v.device)
    # two columns a thread (8-byte accesses) where every row stays 8-byte aligned
    vec = 2 if W % 2 == 0 and v.data_ptr() % 8 == 0 and out.data_ptr() % 8 == 0 else 1
    _build.launch("clahe_apply", v.data_ptr(), lut.data_ptr(), out.data_ptr(), H, W,
                  ty, tx, th, tw, float(np.float32(ty - 1.000001)),
                  float(np.float32(tx - 1.000001)), vec, v.shape[0] if lead else 1,
                  _build.stream_ptr(v))
    clahe_apply.launches += 1
    return out


clahe_apply.launches = 0
