"""Pinhole camera with radial-tangential distortion.

Twin of ``ic_gvins_tpu/vision/camera.py`` (parity target: IC-GVINS
``tracking/camera.{h,cc}``). The point math is elementwise algebra, so each
function dispatches on its input: numpy in, numpy out (the host-side graph
bookkeeping), torch tensor in, torch tensor out (the device stages of the
tracker, called with f64 tensors). Camera parameters are python floats so
they combine with either. The image-scale remap (``undistort_rectify_map``,
``undistort_image``) is torch only: that work belongs on the device.
"""

from typing import NamedTuple

import numpy as np
import torch


def _ns(x):
    """torch for tensors, numpy for everything else."""
    return torch if isinstance(x, torch.Tensor) else np


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    skew: float
    k1: float
    k2: float
    k3: float
    p1: float
    p2: float
    width: int
    height: int

    @staticmethod
    def from_config(intrinsic, distortion, resolution):
        """intrinsic [fx,fy,cx,cy(,skew)], distortion [k1,k2,p1,p2(,k3)]
        (camera.cc:48-70)."""
        skew = intrinsic[4] if len(intrinsic) > 4 else 0.0
        k3 = distortion[4] if len(distortion) > 4 else 0.0
        return PinholeCamera(
            fx=float(intrinsic[0]), fy=float(intrinsic[1]),
            cx=float(intrinsic[2]), cy=float(intrinsic[3]), skew=float(skew),
            k1=float(distortion[0]), k2=float(distortion[1]),
            k3=float(k3), p1=float(distortion[2]), p2=float(distortion[3]),
            width=int(resolution[0]), height=int(resolution[1]),
        )

    @property
    def focal_length(self):
        return (self.fx + self.fy) / 2.0


def pixel2cam(cam: PinholeCamera, px):
    """Pixel -> normalized plane (z=1), skew-aware (camera.cc:123-127)."""
    xp = _ns(px)
    y = (px[..., 1] - cam.cy) / cam.fy
    x = (px[..., 0] - cam.cx - cam.skew * y) / cam.fx
    return xp.stack([x, y, xp.ones_like(x)], axis=-1)


def cam2pixel(cam: PinholeCamera, pc):
    """Normalized/camera point -> pixel (camera.cc:129-131)."""
    xp = _ns(pc)
    u = (cam.fx * pc[..., 0] + cam.skew * pc[..., 1]) / pc[..., 2] + cam.cx
    v = cam.fy * pc[..., 1] / pc[..., 2] + cam.cy
    return xp.stack([u, v], axis=-1)


def distort_normalized(cam: PinholeCamera, xy):
    """Apply radtan distortion on normalized coords (camera.cc:76-117)."""
    xp = _ns(xy)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rr = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * rr + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * rr + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return xp.stack([xd, yd], axis=-1)


def distort_points(cam: PinholeCamera, px):
    """Undistorted pixel -> distorted pixel (Camera::distortPoints)."""
    xp = _ns(px)
    pc = pixel2cam(cam, px)
    xy = distort_normalized(cam, pc[..., :2])
    return cam2pixel(cam, xp.concatenate([xy, xp.ones_like(xy[..., :1])], axis=-1))


def undistort_points(cam: PinholeCamera, px, iters=5):
    """Distorted pixel -> undistorted pixel via fixed-point inversion (the
    cv::undistortPoints iteration, camera.cc:72-74; cv runs 5 iterations).
    Called with f64 tensors on the device stages, as the reference runs it
    in f64."""
    xp = _ns(px)
    pd = pixel2cam(cam, px)[..., :2]
    pdx, pdy = pd[..., 0], pd[..., 1]
    x, y = pdx, pdy
    for _ in range(iters):
        x2 = x * x
        y2 = y * y
        r2 = x2 + y2
        rr = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy2 = 2.0 * x * y
        dx = cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x2)
        dy = cam.p1 * (r2 + 2.0 * y2) + cam.p2 * xy2
        x = (pdx - dx) / rr
        y = (pdy - dy) / rr
    xy = xp.stack([x, y], axis=-1)
    return cam2pixel(cam, xp.concatenate([xy, xp.ones_like(xy[..., :1])], axis=-1))


def world2cam(R, t, pw):
    """pc = R^T (pw - t) (camera.cc:145-147)."""
    return _ns(pw).einsum("...ji,...j->...i", R, pw - t)


def cam2world(R, t, pc):
    return _ns(pc).einsum("...ij,...j->...i", R, pc) + t


def world2pixel(cam: PinholeCamera, R, t, pw):
    return cam2pixel(cam, world2cam(R, t, pw))


def reprojection_error(cam: PinholeCamera, R, t, pw, px_undistorted):
    """Pixel reprojection error of an undistorted observation (camera.cc:153-157)."""
    return world2pixel(cam, R, t, pw) - px_undistorted


def pixel2unitcam(cam: PinholeCamera, px):
    """Pixel -> unit-norm camera ray (camera.cc:135-137)."""
    pc = pixel2cam(cam, px)
    if isinstance(pc, torch.Tensor):
        return pc / torch.linalg.norm(pc, dim=-1, keepdim=True)
    return pc / np.linalg.norm(pc, axis=-1, keepdims=True)


def pixel2world(cam: PinholeCamera, R, t, px):
    """Pixel -> world-frame point of the z=1 camera ray (camera.cc:139-143)."""
    return cam2world(R, t, pixel2cam(cam, px))


def undistort_rectify_map(cam: PinholeCamera, device="cuda"):
    """(H, W, 2) float32 sampling map: for each undistorted output pixel, the
    source pixel in the distorted image (the initUndistortRectifyMap table,
    camera.cc:45). Constant per camera: compute once."""
    v, u = torch.meshgrid(torch.arange(cam.height, dtype=torch.float32, device=device),
                          torch.arange(cam.width, dtype=torch.float32, device=device), indexing="ij")
    return distort_points(cam, torch.stack([u, v], dim=-1))


def undistort_image(img, src_map):
    """Bilinear remap of a distorted image onto the undistorted grid with a
    zero border (Camera::undistortImage, camera.cc:119-121). img (H, W),
    src_map from undistort_rectify_map; each of the four taps outside the
    image reads zero."""
    h, w = img.shape
    x, y = src_map[..., 0], src_map[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        val = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inside, val, torch.zeros_like(val))

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy)
            + tap(y0i, x0i + 1) * fx * (1 - fy)
            + tap(y0i + 1, x0i) * (1 - fx) * fy
            + tap(y0i + 1, x0i + 1) * fx * fy)
