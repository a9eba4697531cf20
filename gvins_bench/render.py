"""The camera's frames of a world, rendered in bulk with plain torch ops.

Each frame sees the street's points from the true body pose through the
configuration's camera (``q_b_c``, ``t_b_c``: the camera in the body frame,
z its optical axis): a Gaussian blob of alternating sign (+-``amplitude``
gray, ``sigma_px``, cut at ``half_px``) at the distorted projection of every
point between 1 m and ``max_range_m`` in front, over a flat background,
clipped to [0, 255] and rounded to 8 bits as a camera delivers them. The
blobs add with ``index_put_(accumulate=True)``, whose CUDA form sorts the
indices, so a seed gives the same bytes in every run.
"""

import numpy as np
import torch

from . import world as wd


def frame_poses(world):
    """(R_wb (F, 3, 3), t_wb (F, 3)) at the frame times: the truth at the IMU
    sample each frame falls on."""
    i = np.clip(np.round(world["frame_times"] * world["rate"]).astype(int) - 1, 0, len(world["p"]) - 1)
    return wd.qmatrix(world["q"][i]), world["p"][i]


def render(world, camera, blob, device, chunk=16):
    """uint8 frames (F, H, W) on the host. ``camera``: the configuration's
    camera dict (intrinsic fx fy cx cy, distortion k1 k2 p1 p2, resolution
    W H); ``blob``: the traffic's blob dict."""
    fx, fy, cx, cy = camera["intrinsic"]
    k1, k2, p1, p2 = camera["distortion"]
    W, H = camera["resolution"]
    sigma, half, amp, bg = blob["sigma_px"], blob["half_px"], blob["amplitude"], blob["background"]
    dev = torch.device(device)
    R_all, t_all = frame_poses(world)
    # camera in the world: R_wc = R_wb R_bc, t_wc = t_wb + R_wb t_bc
    R_bc = wd.qmatrix(np.asarray(camera["q_b_c"], np.float64))
    t_all = t_all + np.einsum("fij,j->fi", R_all, np.asarray(camera["t_b_c"], np.float64))
    R_all = R_all @ R_bc
    pts = torch.tensor(world["points"], dtype=torch.float64, device=dev)
    sign = torch.where(torch.arange(len(pts), device=dev) % 2 == 0, 1.0, -1.0).to(torch.float32)
    off = torch.arange(-half, half + 1, device=dev)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    oy, ox = oy.reshape(-1), ox.reshape(-1)
    out = np.empty((len(t_all), H, W), np.uint8)
    for c0 in range(0, len(t_all), chunk):
        R = torch.tensor(R_all[c0:c0 + chunk], device=dev)
        t = torch.tensor(t_all[c0:c0 + chunk], device=dev)
        B = len(t)
        pc = torch.einsum("bnj,bjk->bnk", pts[None] - t[:, None, :], R)   # R^T (p - t), per frame
        z = pc[..., 2]
        front = (z > 1.0) & (z < blob["max_range_m"])
        x = pc[..., 0] / torch.where(front, z, 1.0)
        y = pc[..., 1] / torch.where(front, z, 1.0)
        r2 = x * x + y * y
        rr = 1.0 + k1 * r2 + k2 * r2 * r2
        u = fx * (x * rr + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)) + cx
        v = fy * (y * rr + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y) + cy
        keep = front & (u > -5) & (u < W + 5) & (v > -5) & (v < H + 5)
        b, n = torch.nonzero(keep, as_tuple=True)
        u, v = u[b, n], v[b, n]
        px = torch.floor(u).long()[:, None] + ox[None, :]
        py = torch.floor(v).long()[:, None] + oy[None, :]
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        val = (amp * sign[n])[:, None] * torch.exp(
            -(((px - u[:, None]) ** 2 + (py - v[:, None]) ** 2) / (2 * sigma**2))).to(torch.float32)
        img = torch.full((B, H, W), float(bg), dtype=torch.float32, device=dev)
        flat = (b[:, None] * (H * W) + py * W + px)[inside]
        img.view(-1).index_put_((flat,), val[inside], accumulate=True)
        out[c0:c0 + B] = torch.round(img.clamp(0.0, 255.0)).to(torch.uint8).cpu().numpy()
    return out
