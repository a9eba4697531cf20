"""Image preprocessing: CLAHE, Gaussian pyramid, bilinear sampling.

Twin of ``ic_gvins_tpu/vision/pyramid.py``. Replaces cv::createCLAHE(3.0,
21x21) (tracking.cc:63, 139) and the pyramid inside
cv::calcOpticalFlowPyrLK / cv::pyrDown. All image math is f32.

The reference's nibble one-hot matmuls and banded pyrDown matrices are TPU
lowerings; this module computes the same functions directly: a per-tile
``bincount`` histogram, and the 5-tap blur as shifted-slice multiply-adds
(no ``conv2d``, so no cuDNN TF32 path). The CLAHE apply is kernel K3
(``ops/clahe.py``).

``_edge_pad``, ``pyr_down``, ``build_pyramid``, ``extract_patch``,
``clahe_tables`` and ``clahe`` also take a leading world axis (B images,
the JAX package's vmap over worlds in ``parallel/mesh.py``).
"""

import torch

from ..ops.clahe import clahe_apply

# cv::pyrDown 5-tap kernel (exact in f32)
_PYR_K = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img, top, bottom, left, right):
    """Edge (replicate) padding of the last two axes by index clamping."""
    H, W = img.shape[-2:]
    rows = torch.arange(-top, H + bottom, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=img.device).clamp(0, W - 1)
    return img[..., rows, :][..., cols]


def pyr_down(img):
    """One pyramid level down: 5-tap Gaussian (separable, edge-padded) + 2x
    decimation. out[i] = sum_k K[k] * padded[2i + k] per axis, rows first."""
    img = img.to(torch.float32)
    H, W = img.shape[-2:]
    H2, W2 = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    p = _edge_pad(img, 2, 2, 2, 2)
    v = _PYR_K[0] * p[..., 0 : 2 * H2 - 1 : 2, :]
    for k in range(1, 5):
        v = v + _PYR_K[k] * p[..., k : k + 2 * H2 - 1 : 2, :]
    out = _PYR_K[0] * v[..., 0 : 2 * W2 - 1 : 2]
    for k in range(1, 5):
        out = out + _PYR_K[k] * v[..., k : k + 2 * W2 - 1 : 2]
    return out


def build_pyramid(img, levels=4):
    """[level0 (full res), level1, ...]."""
    pyr = [img.to(torch.float32)]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def bilinear_sample(img, xy):
    """Sample img (H,W) at float coords xy (...,2) [x, y], edge-clamped."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (x - x0).to(img.dtype)
    fy = (y - y0).to(img.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def extract_patch(img, centers, half):
    """(N, 2*half+1, 2*half+1) bilinear patches around centers (N, 2) xy;
    with a world axis, img (B, H, W) and centers (B, N, 2).

    As the reference: the (size+1)^2 slice starts at the integer corner and
    is CLIPPED inward at the image border, so there the window shifts
    instead of clamping pixel by pixel; the fraction is the center's own."""
    size = 2 * half + 1
    H, W = img.shape[-2:]
    x, y = centers[..., 0], centers[..., 1]
    ix = torch.floor(x)
    iy = torch.floor(y)
    fx = (x - ix).to(img.dtype)[..., None, None]
    fy = (y - iy).to(img.dtype)[..., None, None]
    x0 = torch.clamp(ix.long() - half, 0, W - (size + 1))
    y0 = torch.clamp(iy.long() - half, 0, H - (size + 1))
    r = torch.arange(size + 1, device=img.device)
    rows, cols = (y0[..., None] + r)[..., :, None], (x0[..., None] + r)[..., None, :]
    if img.dim() == 3:
        world = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
        raw = img[world, rows, cols]
    else:
        raw = img[rows, cols]
    p00 = raw[..., :-1, :-1]
    p01 = raw[..., :-1, 1:]
    p10 = raw[..., 1:, :-1]
    p11 = raw[..., 1:, 1:]
    return (
        (1 - fy) * (1 - fx) * p00
        + (1 - fy) * fx * p01
        + fy * (1 - fx) * p10
        + fy * fx * p11
    )


def clahe_tables(img, clip_limit=3.0, tile=21, nbins=256):
    """Everything of CLAHE before the apply: (v, lut, grid, tile_size) with v
    the (H, W) i32 gray values, lut the (ty*tx, 256) bf16 per-tile transfer
    functions, grid = (ty, tx) tiles of tile_size = (th, tw) pixels.

    Per-tile 256-bin histogram of the edge-padded image, clipped at
    clip_limit * area / nbins with the excess spread evenly, CDF normalized
    to [0, 255] and rounded to bf16 (the reference's +-0.5 gray budget,
    pyramid.py:190). With a world axis, img (B, H, W) gives v (B, H, W) and
    lut (B, ty*tx, 256)."""
    img = torch.clamp(img.to(torch.float32), 0.0, 255.0)
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    ty = tx = tile
    th, tw = -(-H // ty), -(-W // tx)  # tile size (ceil)
    Hp, Wp = th * ty, tw * tx
    v = img.to(torch.int32).clamp(0, nbins - 1)
    vp = _edge_pad(v, 0, Hp - H, 0, Wp - W).long()

    dev = img.device
    tid = ((torch.arange(Hp, device=dev) // th)[:, None] * tx
           + (torch.arange(Wp, device=dev) // tw)[None, :])
    bins = tid * nbins + vp
    n_worlds = 1
    if lead:  # one bincount for every world: world b's bins from b * ty*tx*nbins
        n_worlds = lead[0]
        bins = bins + (torch.arange(n_worlds, device=dev) * (ty * tx * nbins))[:, None, None]
    hist = torch.bincount(bins.reshape(-1), minlength=n_worlds * ty * tx * nbins)
    hist = hist.reshape(lead + (ty * tx, nbins)).to(torch.float32)

    # clip + redistribute (cv semantics: clipLimit scaled by tile area / bins)
    limit = max(clip_limit * (th * tw) / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins

    cdf = torch.cumsum(hist, dim=-1)
    lut = (cdf - cdf[..., :1]) / torch.clamp(cdf[..., -1:] - cdf[..., :1], min=1.0) * 255.0
    return v.contiguous(), lut.to(torch.bfloat16).contiguous(), (ty, tx), (th, tw)


def clahe(img, clip_limit=3.0, tile=21, nbins=256):
    """Contrast-limited adaptive histogram equalization on a tile x tile grid
    (cv::CLAHE(clipLimit=3.0, tileGrid=(21,21)) semantics, tracking.cc:63,
    139). Input gray values 0..255 (any float/int dtype); output f32: the
    tables of ``clahe_tables`` blended by kernel K3."""
    return clahe_apply(*clahe_tables(img, clip_limit, tile, nbins))
