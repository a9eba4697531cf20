"""The plain reference of the frontend's image math, in plain torch ops.

Frozen copies of the program's plain versions of its three kernels and of
the CLAHE and pyramid steps around them (cv::createCLAHE(3.0, 21x21),
cv::pyrDown, cv::calcOpticalFlowPyrLK with its forward-backward check,
cv::cornerSubPix), kept here so that no change to the program moves the
yardstick. Every function computes in the dtype of its image argument:
float32 is the precision the configuration states for the frontend, and
bfloat16 image math (points kept in float32) is the control. The CLAHE
transfer tables are rounded to bfloat16 in both, as the configuration states.
"""

import numpy as np
import torch

LK_WIN_HALF = 10
LK_MAX_ITERS = 30
LK_EPS = 0.01
LK_MIN_EIG = 1e-4
LK_PAD = LK_WIN_HALF + 2
LK_LEVELS = 4
SUBPIX_HALF = 5
SUBPIX_ITERS = 20
SUBPIX_EPS = 0.01
PYR_K = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def edge_pad(img, top, bottom, left, right):
    H, W = img.shape[-2:]
    rows = torch.arange(-top, H + bottom, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=img.device).clamp(0, W - 1)
    return img[..., rows, :][..., cols]


def clahe_tables(img, clip_limit=3.0, tile=21, nbins=256):
    """(v int32 gray values, lut (tile*tile, 256) bf16, grid, tile size):
    clipped per-tile histograms of the edge-padded image, their normalized
    CDFs."""
    img = torch.clamp(img.to(torch.float32), 0.0, 255.0)
    H, W = img.shape
    th, tw = -(-H // tile), -(-W // tile)
    v = img.to(torch.int32).clamp(0, nbins - 1)
    vp = edge_pad(v, 0, th * tile - H, 0, tw * tile - W).long()
    dev = img.device
    tid = (torch.arange(th * tile, device=dev) // th)[:, None] * tile + (torch.arange(tw * tile, device=dev) // tw)
    hist = torch.bincount((tid * nbins + vp).reshape(-1), minlength=tile * tile * nbins)
    hist = hist.reshape(tile * tile, nbins).to(torch.float32)
    limit = max(clip_limit * (th * tw) / nbins, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, dim=-1)
    lut = (cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1], min=1.0) * 255.0
    return v, lut.to(torch.bfloat16), (tile, tile), (th, tw)


def _offset_weights(n, tn, tsize, device):
    """(n, 3) blend weights over tile offsets {-1, 0, +1} of each coordinate's
    own tile (bilinear between tile centres, clamped at the edge tiles)."""
    yy = torch.arange(n, dtype=torch.float32, device=device)
    tf = (((yy - tsize / 2.0) + 0.5) / tsize).clamp(0.0, float(np.float32(tn - 1.000001)))
    y0 = torch.floor(tf)
    f = tf - y0
    own = torch.arange(n, device=device) // tsize
    w = torch.zeros((n, 3), dtype=torch.float32, device=device)
    rows = torch.arange(n, device=device)
    for yi, wi in ((y0.long(), 1.0 - f), (torch.clamp(y0.long() + 1, max=tn - 1), f)):
        w.index_put_((rows, torch.clamp(yi - own, -1, 1) + 1), wi, accumulate=True)
    return w


def clahe(img, dtype=torch.float32):
    """CLAHE of a gray image, its blend computed in ``dtype``."""
    v, lut, (ty, tx), (th, tw) = clahe_tables(img)
    H, W = v.shape
    dev = v.device
    wr = _offset_weights(H, ty, th, dev).to(dtype)
    wc = _offset_weights(W, tx, tw, dev).to(dtype)
    ti, tj = torch.arange(H, device=dev) // th, torch.arange(W, device=dev) // tw
    flat = lut.to(dtype).reshape(-1)
    out = torch.zeros((H, W), dtype=dtype, device=dev)
    for dy in range(3):
        ni = torch.clamp(ti + dy - 1, 0, ty - 1)
        for dx in range(3):
            nj = torch.clamp(tj + dx - 1, 0, tx - 1)
            vals = flat[((ni[:, None] * tx + nj[None, :]) * 256 + v.long()).reshape(-1)].reshape(H, W)
            out = out + (wr[:, dy, None] * wc[None, :, dx]) * vals
    return out


def pyr_down(img):
    H, W = img.shape[-2:]
    H2, W2 = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    p = edge_pad(img, 2, 2, 2, 2)
    v = PYR_K[0] * p[0:2 * H2 - 1:2, :]
    for k in range(1, 5):
        v = v + PYR_K[k] * p[k:k + 2 * H2 - 1:2, :]
    out = PYR_K[0] * v[:, 0:2 * W2 - 1:2]
    for k in range(1, 5):
        out = out + PYR_K[k] * v[:, k:k + 2 * W2 - 1:2]
    return out


def pyramid(img, dtype=torch.float32, levels=LK_LEVELS):
    """The CLAHE pyramid of a raw gray frame, every step in ``dtype``."""
    pyr = [clahe(img, dtype)]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def extract_patch(img, centers, half):
    """(N, 2*half+1, 2*half+1) bilinear patches at ``centers`` (N, 2) xy,
    from the (size+1)^2 slice at the integer corner, clipped inward at the
    border; the weights in the image's dtype."""
    size = 2 * half + 1
    H, W = img.shape
    ix, iy = torch.floor(centers[:, 0]), torch.floor(centers[:, 1])
    fx = (centers[:, 0] - ix).to(img.dtype)[:, None, None]
    fy = (centers[:, 1] - iy).to(img.dtype)[:, None, None]
    x0 = torch.clamp(ix.long() - half, 0, W - (size + 1))
    y0 = torch.clamp(iy.long() - half, 0, H - (size + 1))
    r = torch.arange(size + 1, device=img.device)
    raw = img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]
    return ((1 - fy) * (1 - fx) * raw[:, :-1, :-1] + (1 - fy) * fx * raw[:, :-1, 1:]
            + fy * (1 - fx) * raw[:, 1:, :-1] + fy * fx * raw[:, 1:, 1:])


def lk_level(img_prev, img_next, pts_prev, pts_guess, valid, log=None):
    """One pyramidal-LK level: (next points, ok). Points stay float32. With
    ``log`` a list, appends (img_prev, img_next, pts_prev, guess, valid, ok,
    steps) for the byte and operation counts of the roofline."""
    ip = edge_pad(img_prev, LK_PAD, LK_PAD, LK_PAD, LK_PAD)
    inx = edge_pad(img_next, LK_PAD, LK_PAD, LK_PAD, LK_PAD)
    pos = pts_guess + LK_PAD
    p = extract_patch(ip, pts_prev + LK_PAD, LK_WIN_HALF + 1)
    tpl = p[:, 1:-1, 1:-1]
    gx = 0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
    gy = 0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])
    gxx, gyy, gxy = (torch.sum(a * b, dim=(-2, -1)) for a, b in ((gx, gx), (gy, gy), (gx, gy)))
    det = gxx * gyy - gxy * gxy
    n_px = (2 * LK_WIN_HALF + 1) ** 2
    min_eig = 0.5 * ((gxx + gyy) - torch.sqrt((gxx - gyy) * (gxx - gyy) + 4 * gxy * gxy)) / n_px
    ok = (min_eig > LK_MIN_EIG) & (torch.abs(det) > 1e-12) & valid
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, torch.zeros_like(det))
    active = torch.ones_like(ok)
    steps = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    for _ in range(LK_MAX_ITERS):
        diff = extract_patch(inx, pos, LK_WIN_HALF) - tpl
        bx = torch.sum(diff * gx, dim=(-2, -1))
        by = torch.sum(diff * gy, dim=(-2, -1))
        step = torch.stack([-(gyy * bx - gxy * by) * inv_det, -(gxx * by - gxy * bx) * inv_det], dim=-1)
        moving = active & ok
        pos = pos + step.to(pos.dtype) * moving[:, None]
        steps += moving.to(torch.int32)
        active = active & (torch.linalg.vector_norm(step.float(), dim=-1) >= LK_EPS)
    if log is not None:
        log.append((img_prev, img_next, pts_prev, pts_guess, valid, ok, steps))
    return pos - LK_PAD, ok


def _lk_one_way(pyr_prev, pyr_next, pts_prev, pts_init, valid, log):
    guess = pts_init / 2.0 ** (LK_LEVELS - 1)
    status = valid
    for lvl in range(LK_LEVELS - 1, -1, -1):
        guess, ok = lk_level(pyr_prev[lvl], pyr_next[lvl], pts_prev / 2.0**lvl, guess, valid, log)
        status = status & ok
        if lvl > 0:
            guess = guess * 2.0
    H, W = pyr_next[0].shape
    inb = (guess[:, 0] >= 0) & (guess[:, 0] <= W - 1) & (guess[:, 1] >= 0) & (guess[:, 1] <= H - 1)
    return guess, status & inb


def lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid, fb_threshold=0.5, border=5, log=None):
    """Bidirectional pyramidal LK with the forward-backward check: (forward
    points (N, 2) float32, ok (N,))."""
    pts_prev, pts_pred = pts_prev.float(), pts_pred.float()
    fwd, st_f = _lk_one_way(pyr_prev, pyr_next, pts_prev, pts_pred, valid, log)
    bwd, st_b = _lk_one_way(pyr_next, pyr_prev, fwd, pts_prev, valid & st_f, log)
    H, W = pyr_next[0].shape
    on_border = (fwd[:, 0] < border) | (fwd[:, 1] < border) | (fwd[:, 0] > W - border) | (fwd[:, 1] > H - border)
    ok = st_f & st_b & (torch.linalg.vector_norm(bwd - pts_prev, dim=-1) < fb_threshold) & ~on_border & valid
    return fwd, ok


def subpix(img, corners, valid):
    """cv::cornerSubPix (11x11 window, 20 steps, eps 0.01) with the
    divergence guard: (refined corners (N, 2) float32, steps (N,) int32)."""
    d = torch.arange(2 * SUBPIX_HALF + 1, device=img.device).to(img.dtype) - SUBPIX_HALF
    w1 = torch.exp(-((d / SUBPIX_HALF) * (d / SUBPIX_HALF)))
    wgt = w1[:, None] * w1[None, :]
    dxg, dyg = d[None, None, :], d[None, :, None]
    pos = corners.float()
    active = torch.ones(corners.shape[0], dtype=torch.bool, device=img.device)
    taken = torch.zeros(corners.shape[0], dtype=torch.int32, device=img.device)
    for _ in range(SUBPIX_ITERS):
        patch = extract_patch(img, pos, SUBPIX_HALF + 1)
        gx = 0.5 * (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2])
        gy = 0.5 * (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1])
        wxx, wyy, wxy = wgt * gx * gx, wgt * gy * gy, wgt * gx * gy
        gxx, gyy, gxy = (torch.sum(a, dim=(-2, -1)) for a in (wxx, wyy, wxy))
        bx = torch.sum(wxx * dxg, dim=(-2, -1)) + torch.sum(wxy * dyg, dim=(-2, -1))
        by = torch.sum(wxy * dxg, dim=(-2, -1)) + torch.sum(wyy * dyg, dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        safe = torch.abs(det) > 1e-12
        den = torch.where(safe, det, torch.ones_like(det))
        zero = torch.zeros_like(det)
        step = torch.stack([torch.where(safe, (gyy * bx - gxy * by) / den, zero),
                            torch.where(safe, (gxx * by - gxy * bx) / den, zero)], dim=-1)
        step = torch.clamp(step, -1.0, 1.0).float()
        pos = torch.where(active[:, None], pos + step, pos)
        taken += active.to(torch.int32)
        active = active & (torch.linalg.vector_norm(step, dim=-1) >= SUBPIX_EPS)
    moved = torch.linalg.vector_norm(pos - corners, dim=-1)
    out = torch.where((moved < SUBPIX_HALF)[:, None], pos, corners.float())
    return torch.where(valid[:, None], out, corners.float()), torch.where(valid, taken, torch.zeros_like(taken))
