"""Shi-Tomasi corner detection: blockwise masked top-k + subpixel refinement.

Twin of ``ic_gvins_tpu/vision/features.py``. Replaces the reference's
per-block cv::goodFeaturesToTrack + cv::cornerSubPix (tracking.cc:576-688):
the min-eigenvalue response over the whole image, per-block quality gating,
NMS and top-k as a reshape + per_block argmax rounds, and the circular
feature mask as a max-pooled occupancy image. Output is a fixed-size padded
corner table with a validity mask. Subpixel refinement is kernel K2
(``ops/subpix.py``). The elementwise arithmetic follows the reference's
operation order, so on the same f32 image the responses and corner tables
agree exactly. ``occupancy_mask``, ``detect_blockwise`` and
``corner_subpix`` also take a leading world axis (B images, the JAX
package's vmap over worlds in ``parallel/mesh.py``).
"""

import torch
import torch.nn.functional as F

from ..ops.subpix import subpix
from .pyramid import _edge_pad


def _sobel(img):
    """3x3 Sobel gradients with cv-compatible scale (aperture 3)."""
    img = img.to(torch.float32)
    p = _edge_pad(img, 1, 1, 1, 1)
    # separable: d = [-1,0,1], s = [1,2,1]
    dx = p[..., 2:] - p[..., :-2]
    gx = dx[..., :-2, :] + 2.0 * dx[..., 1:-1, :] + dx[..., 2:, :]
    dy = p[..., 2:, :] - p[..., :-2, :]
    gy = dy[..., :-2] + 2.0 * dy[..., 1:-1] + dy[..., 2:]
    return gx, gy


def min_eig_response(img, block_size=3):
    """Per-pixel smaller eigenvalue of the gradient covariance (the
    cv::goodFeaturesToTrack response)."""
    gx, gy = _sobel(img)
    xx, yy, xy = gx * gx, gy * gy, gx * gy
    k = block_size // 2

    def box(a):
        p = _edge_pad(a, k, k, k, k)
        out = torch.zeros_like(a)
        for i in range(block_size):
            for j in range(block_size):
                out = out + p[..., i : i + a.shape[-2], j : j + a.shape[-1]]
        return out / (block_size * block_size)

    sxx, syy, sxy = box(xx), box(yy), box(xy)
    tr = sxx + syy
    d = sxx - syy
    det = torch.sqrt(torch.clamp(d * d + 4.0 * sxy * sxy, min=0.0))
    return 0.5 * (tr - det)


def _max_filter(a, k):
    """Separable k x k max filter with -inf padding ("SAME", k odd) over
    the last two axes."""
    a = F.max_pool2d(a.unsqueeze(-3), (k, 1), stride=1, padding=(k // 2, 0))
    return F.max_pool2d(a, (1, k), stride=1, padding=(0, k // 2)).squeeze(-3)


def occupancy_mask(points_xy, valid, shape, radius):
    """0/1 image that is 0 within ``radius`` (square window) of any valid
    point — the feature-distance mask (tracking.cc:609-620, circles
    approximated by squares of the same radius)."""
    H, W = shape
    dev = points_xy.device
    lead = points_xy.shape[:-2]
    xi = torch.clamp(points_xy[..., 0].to(torch.int32), 0, W - 1).long()
    yi = torch.clamp(points_xy[..., 1].to(torch.int32), 0, H - 1).long()
    occ = torch.zeros(lead + (H * W,), dtype=torch.float32, device=dev)
    occ = occ.scatter_reduce(-1, yi * W + xi, valid.to(torch.float32), "amax")
    occ = _max_filter(occ.reshape(lead + (H, W)), int(2 * radius + 1))
    return 1.0 - torch.clamp(occ, min=0.0)


def detect_blockwise(img, mask, block_counts, *, block_rows, block_cols, per_block,
                     min_distance=15, quality_level=0.01, border=5):
    """Blockwise Shi-Tomasi detection.

    img: (H,W) f32 (CLAHE'd); mask: (H,W) 0/1 allowed regions;
    block_counts: (block_rows*block_cols,) already-present features per block
    (detection fills each block up to ``per_block``).

    Returns (corners (B*per_block, 2) f32 xy, response, valid) padded tables.
    Parity: per-block quality gate at 0.01 * block max, NMS at min_distance,
    5-px borders between blocks (tracking.cc:639-642). With a leading
    world axis on img, mask and block_counts, every table gains it."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    dev = img.device
    bh, bw = H // block_rows, W // block_cols

    resp = min_eig_response(img)

    # NMS: local maxima within the min-distance window (separable max)
    k = int(min_distance) | 1
    is_max = (resp >= _max_filter(resp, k)) & (resp > 0)

    # border suppression: global image border + inter-block seams
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    inb = inb & ~((yy % bh) >= (bh - border)) & ~((xx % bw) >= (bw - border))

    resp_m = torch.where(is_max & inb & (mask > 0), resp, torch.zeros_like(resp))

    # crop to whole blocks, reshape to (B, bh*bw)
    crop = resp_m[..., : block_rows * bh, : block_cols * bw]
    blocks = crop.reshape(lead + (block_rows, bh, block_cols, bw)).transpose(-3, -2)
    blocks = blocks.reshape(lead + (block_rows * block_cols, bh * bw))

    # per-block quality gate
    bmax = torch.amax(blocks, dim=-1, keepdim=True)
    blocks = torch.where(blocks >= quality_level * bmax, blocks, torch.zeros_like(blocks))

    # top-k by per_block rounds of (max, first argmax, knock out)
    vals, idxs = [], []
    work = blocks.clone()
    for _ in range(per_block):
        v, i = torch.max(work, dim=-1)
        vals.append(v)
        idxs.append(i)
        work.scatter_(-1, i[..., None], 0.0)
    top_val = torch.stack(vals, dim=-1)
    top_idx = torch.stack(idxs, dim=-1)

    # slot budget per block: per_block - existing features
    budget = torch.clamp(per_block - block_counts.to(dev).long(), min=0)
    rank = torch.arange(per_block, device=dev)
    valid = (top_val > 0) & (rank < budget[..., None])

    by = top_idx // bw
    bx = top_idx % bw
    block_ids = torch.arange(block_rows * block_cols, device=dev)
    brow = (block_ids // block_cols)[:, None]
    bcol = (block_ids % block_cols)[:, None]
    x = (bcol * bw + bx).to(torch.float32)
    y = (brow * bh + by).to(torch.float32)

    flat = lead + (-1,)
    corners = torch.stack([x.reshape(flat), y.reshape(flat)], dim=-1)
    return corners, top_val.reshape(flat), valid.reshape(flat)


def corner_subpix(img, corners, valid):
    """Subpixel refinement (cv::cornerSubPix, 11x11 window, 20 iterations,
    eps 0.01): kernel K2, one launch for all worlds."""
    return subpix(img.to(torch.float32).contiguous(), corners.to(torch.float32).contiguous(),
                  valid.contiguous())
