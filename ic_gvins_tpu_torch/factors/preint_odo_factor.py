"""Odometer-aided preintegration factor: 19 whitened residuals, 10-dim mix
blocks, analytic local jacobians.

Port of ``ic_gvins_tpu/factors/preint_odo_factor.py`` (parity targets:
IC-GVINS ``preintegration_odo.cc:40-159`` and
``preintegration_earth_odo.cc:41-185``). Mix block = [v(3), bg(3), ba(3),
sodo(1)]. The first 15 rows are the IMU factor of ``preint_factor.py`` on
the same parameters; rows 15-17 are the odometer translation and row 18 the
scale random walk. All functions broadcast over a leading factor-table
axis.
"""

import torch
import torch.nn.functional as F

from ..core import quaternion as quat
from . import preint_factor as pf

NUM_RES = 19
MIX_ODO = 10


def _corrected_ds(summ, bg, sodo):
    return summ.ds + pf._mv(summ.ds_dbg, bg - summ.bg0) + summ.ds_dsodo * (sodo - summ.sodo0)[..., None]


def residual(summ, pose0, mix0, pose1, mix1, *, with_earth: bool):
    """Whitened 19-dim residual for one interval (or a table)."""
    q0, q1 = pose0[..., 3:7], pose1[..., 3:7]
    cp, cv, cq = pf._corrected(summ, mix0[..., 3:6], mix0[..., 6:9])
    dpn, dvn, qb0b1 = pf._deltas(summ, pose0, mix0, pose1, mix1, with_earth)
    r_p = quat.rotate(quat.conj(q0), dpn) - cp
    r_v = quat.rotate(quat.conj(q0), dvn) - cv
    if with_earth:
        r_q = 2.0 * quat.mul(qb0b1, cq)[..., :3]
    else:
        r_q = 2.0 * quat.mul(quat.conj(cq), quat.mul(quat.conj(q0), q1))[..., :3]
    r_s = quat.rotate(quat.conj(q0), pose1[..., :3] - pose0[..., :3]) - _corrected_ds(summ, mix0[..., 3:6],
                                                                                        mix0[..., 9])
    r = torch.cat([r_p, r_v, r_q, mix1[..., 3:6] - mix0[..., 3:6], mix1[..., 6:9] - mix0[..., 6:9], r_s,
                   (mix1[..., 9] - mix0[..., 9])[..., None]], dim=-1)
    return pf._mv(summ.sqrt_info, r)


def jacobians(summ, pose0, mix0, pose1, mix1, *, with_earth: bool):
    """Analytic whitened local jacobians: (19,6), (19,10), (19,6), (19,10).
    The IMU rows are ``preint_factor``'s (its whitener applied after), the
    odometer rows follow preintegration_odo.cc:95-110 for both variants."""
    q0 = pose0[..., 3:7]
    summ15 = summ._replace(sqrt_info=torch.eye(15, dtype=q0.dtype, device=q0.device))
    Jp0, Jm0, Jp1, Jm1 = pf.jacobians(summ15, pose0, mix0[..., :9], pose1, mix1[..., :9], with_earth=with_earth)
    Jp0, Jp1 = F.pad(Jp0, (0, 0, 0, 4)), F.pad(Jp1, (0, 0, 0, 4))
    Jm0, Jm1 = F.pad(Jm0, (0, 1, 0, 4)), F.pad(Jm1, (0, 1, 0, 4))
    cnb0 = quat.to_matrix(quat.conj(q0))
    Jp0[..., 15:18, 0:3] = -cnb0
    Jp0[..., 15:18, 3:6] = quat.skew(pf._mv(cnb0, pose1[..., :3] - pose0[..., :3]))
    Jp1[..., 15:18, 0:3] = cnb0
    Jm0[..., 15:18, 3:6] = -summ.ds_dbg
    Jm0[..., 15:18, 9] = -summ.ds_dsodo
    Jm0[..., 18, 9] = -1.0
    Jm1[..., 18, 9] = 1.0
    U = summ.sqrt_info
    return U @ Jp0, U @ Jm0, U @ Jp1, U @ Jm1
