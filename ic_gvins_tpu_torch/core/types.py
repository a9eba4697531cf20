"""Core data types: sensor and state containers as NamedTuples of tensors.

Port of ``ic_gvins_tpu/core/types.py`` (parity target: IC-GVINS
``common/types.h:32-63``, ``preintegration/integration_state.h:35-99``). An
``ImuBatch`` holds a padded series of samples in increment form; padded
samples have dt = 0. Leading batch dims broadcast. Also
``integration_params_from_config``, which the JAX package keeps in
``engine/config.py`` behind a jax import (the port's ``engine/config.py``
calls this one).
"""

import math
from typing import NamedTuple

import torch

F64 = torch.float64


class ImuBatch(NamedTuple):
    """A padded batch/series of IMU samples in increment form.

    time:   (..., S) sample end-times [s]
    dt:     (..., S) sample intervals [s] (0 for padding => exact no-op)
    dtheta: (..., S, 3) integrated angle increments [rad]
    dvel:   (..., S, 3) integrated velocity increments [m/s]
    odovel: (..., S) odometer distance increment [m] (0 when unused)
    """

    time: torch.Tensor
    dt: torch.Tensor
    dtheta: torch.Tensor
    dvel: torch.Tensor
    odovel: torch.Tensor

    @staticmethod
    def zeros(shape, dtype=F64, device=None):
        s = (shape,) if isinstance(shape, int) else tuple(shape)
        z = lambda *tail: torch.zeros(s + tail, dtype=dtype, device=device)  # noqa: E731
        return ImuBatch(time=z(), dt=z(), dtheta=z(3), dvel=z(3), odovel=z())


class NavState(NamedTuple):
    """Full navigation state (integration_state.h:35-51); q is xyzw.
    sodo/sg/sa cover the odometer-scale and IMU-scale model variants."""

    time: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    sodo: torch.Tensor
    sg: torch.Tensor
    sa: torch.Tensor

    @staticmethod
    def identity(dtype=F64, device=None):
        z3 = torch.zeros(3, dtype=dtype, device=device)
        z = torch.zeros((), dtype=dtype, device=device)
        return NavState(time=z, p=z3, q=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device),
                        v=z3, bg=z3, ba=z3, sodo=z, sg=z3, sa=z3)

    def to_pose_mix(self):
        """Flatten to the optimizer parameter blocks: pose[7] = [p, q_xyzw],
        mix[10] = [v, bg, ba, sodo] (integration_state.h:53-66; the
        NORMAL/EARTH variants use the first 9 mix entries)."""
        pose = torch.cat([self.p, self.q], dim=-1)
        mix = torch.cat([self.v, self.bg, self.ba, self.sodo[..., None]], dim=-1)
        return pose, mix

    @staticmethod
    def from_pose_mix(time, pose, mix):
        """The inverse of ``to_pose_mix`` over leading batch axes; sg and sa
        are zero."""
        return NavState(time=time, p=pose[..., :3], q=pose[..., 3:7], v=mix[..., :3], bg=mix[..., 3:6],
                        ba=mix[..., 6:9], sodo=mix[..., 9], sg=torch.zeros_like(pose[..., :3]),
                        sa=torch.zeros_like(pose[..., :3]))


class GnssData(NamedTuple):
    """One GNSS fix (types.h:32-40); blh may hold local n-frame coords after
    global2local conversion, as GVINS::addNewGnss does (ic_gvins.cc:199-220)."""

    time: torch.Tensor
    blh: torch.Tensor
    std: torch.Tensor
    isyawvalid: torch.Tensor
    yaw: torch.Tensor


class IntegrationParams(NamedTuple):
    """IMU stochastic model + gravity + odometer params
    (integration_state.h:68-89). Random walks in rad/sqrt(s) and m/s^1.5;
    biases first-order Gauss-Markov. Every field a float64 tensor."""

    gyr_arw: torch.Tensor
    acc_vrw: torch.Tensor
    gyr_bias_std: torch.Tensor
    acc_bias_std: torch.Tensor
    corr_time: torch.Tensor
    gravity: torch.Tensor         # scalar magnitude
    odo_std: torch.Tensor         # (3,)
    odo_srw: torch.Tensor
    abv: torch.Tensor             # (3,) body-to-vehicle mounting angles
    lodo: torch.Tensor            # (3,) odometer lever arm
    station: torch.Tensor         # (3,) origin blh (for earth-rotation rate)

    @staticmethod
    def default(device=None):
        t = lambda x: torch.tensor(x, dtype=F64, device=device)  # noqa: E731
        return IntegrationParams(
            gyr_arw=t(0.1 * math.pi / 180.0 / 60.0),
            acc_vrw=t(0.1 / 60.0),
            gyr_bias_std=t(50.0 * math.pi / 180.0 / 3600.0),
            acc_bias_std=t(50.0e-5),
            corr_time=t(3600.0),
            gravity=t(9.80),
            odo_std=t([0.1, 0.1, 0.1]),
            odo_srw=t(1.0e-3),   # 1000 PPM/sqrt(Hz) in 1/sqrt(s)
            abv=t([0.0, 0.0, 0.0]),
            lodo=t([0.0, 0.0, 0.0]),
            station=t([0.0, 0.0, 0.0]),
        )


def integration_params_from_config(cfg, gravity=9.80, device=None):
    """IntegrationParams from a parsed ``GvinsConfig`` (the JAX package's
    ``engine/config.py:146-169``)."""
    t = lambda x: torch.tensor(x, dtype=F64, device=device)  # noqa: E731
    m = cfg.imumodel
    params = IntegrationParams.default(device)._replace(
        gyr_arw=t(m.arw), acc_vrw=t(m.vrw), gyr_bias_std=t(m.gbstd),
        acc_bias_std=t(m.abstd), corr_time=t(m.corrtime), gravity=t(gravity))
    if cfg.odometer is not None:
        o = cfg.odometer
        params = params._replace(odo_std=t(o.std), odo_srw=t(o.srw), abv=t(o.abv), lodo=t(o.lodo))
    return params


# Preintegration model variants (preintegration/preintegration.h:34-45)
PREINT_NORMAL = 0
PREINT_ODO = 1
PREINT_EARTH = 2
PREINT_EARTH_ODO = 3
