"""Carry frontend state across from the JAX package.

The frontend has no learned weights. Its state is the camera (packed by the
reference as a 10-vector, ``ic_gvins_tpu/vision/tracking.py:199-201``), the
config (a plain dataclass, parsed the same way by ``engine/config.py``) and
the image pyramids. Inputs are numpy arrays (for example ``np.asarray`` of
a JAX array), so this module needs no jax.
"""

import numpy as np
import torch

from .vision.camera import PinholeCamera


def camera_from_vec(vec10, width, height):
    """The reference's packed camera [fx, fy, cx, cy, skew, k1, k2, k3, p1, p2]
    -> the port's ``PinholeCamera``."""
    v = [float(x) for x in np.asarray(vec10, np.float64).reshape(10)]
    return PinholeCamera(*v, width=int(width), height=int(height))


def pyramid_from_numpy(levels, device="cuda"):
    """A list of numpy pyramid levels -> the port's pyramid: contiguous f32
    tensors on ``device`` (the card unless the caller asks for the CPU),
    copied (never aliased with the numpy buffers)."""
    return [torch.tensor(np.asarray(lv), dtype=torch.float32, device=device) for lv in levels]
