"""Pure-numpy WGS-84 helpers for the host side of the replay loop.

A carried-over copy of ``ic_gvins_tpu/core/earth_np.py`` (same constants and
formulas, IC-GVINS ``common/earth.h:34-248``). That module imports its
constants from the JAX package's ``earth.py``, which imports jax; this copy
holds them itself, and the port's torch ``earth.py`` imports them from here.
It adds the batched pose transform (``local2global_pose``) and the euler
read-out (``matrix_to_euler``) the output writer needs per chunk of samples.
"""

import numpy as np

WGS84_WIE = 7.2921151467e-5   # earth rotation rate, rad/s
WGS84_F = 0.0033528106647474805
WGS84_RA = 6378137.0
WGS84_RB = 6356752.3142451793
WGS84_GM0 = 398600441800000.0
WGS84_E1 = 0.0066943799901413156  # first eccentricity squared
WGS84_E2 = 0.0067394967422764341  # second eccentricity squared


def gravity(blh):
    """Normal gravity at geodetic blh = (lat, lon, height) (earth.h:70-79)."""
    blh = np.asarray(blh, np.float64)
    sin2 = np.sin(blh[..., 0]) ** 2
    return (
        9.7803267715 * (1 + 0.0052790414 * sin2 + 0.0000232718 * sin2 * sin2)
        + blh[..., 2] * (0.0000000043977311 * sin2 - 0.0000030876910891)
        + 0.0000000000007211 * blh[..., 2] ** 2
    )


def rn(lat):
    sinlat = np.sin(lat)
    return WGS84_RA / np.sqrt(1.0 - WGS84_E1 * sinlat * sinlat)


def cne(blh):
    blh = np.asarray(blh, np.float64)
    sinlat, coslat = np.sin(blh[..., 0]), np.cos(blh[..., 0])
    sinlon, coslon = np.sin(blh[..., 1]), np.cos(blh[..., 1])
    row0 = np.stack([-sinlat * coslon, -sinlon, -coslat * coslon], axis=-1)
    row1 = np.stack([-sinlat * sinlon, coslon, -coslat * sinlon], axis=-1)
    row2 = np.stack([coslat, np.zeros_like(coslat), -sinlat], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def blh2ecef(blh):
    blh = np.asarray(blh, np.float64)
    coslat, sinlat = np.cos(blh[..., 0]), np.sin(blh[..., 0])
    coslon, sinlon = np.cos(blh[..., 1]), np.sin(blh[..., 1])
    rn_ = rn(blh[..., 0])
    rnh = rn_ + blh[..., 2]
    return np.stack(
        [rnh * coslat * coslon, rnh * coslat * sinlon, (rnh - rn_ * WGS84_E1) * sinlat],
        axis=-1,
    )


def ecef2blh(ecef):
    """Iterative ECEF -> geodetic; fixed 10 iterations, as the torch and JAX
    versions (earth.h:132-150)."""
    ecef = np.asarray(ecef, np.float64)
    p = np.sqrt(ecef[..., 0] ** 2 + ecef[..., 1] ** 2)
    lon = 2.0 * np.arctan2(ecef[..., 1], ecef[..., 0] + p)
    lat = np.arctan(ecef[..., 2] / (p * (1.0 - WGS84_E1)))
    h = np.zeros_like(p)
    for _ in range(10):
        rn_ = rn(lat)
        h = p / np.cos(lat) - rn_
        lat = np.arctan(ecef[..., 2] / (p * (1.0 - WGS84_E1 * rn_ / (rn_ + h))))
    return np.stack([lat, lon, h], axis=-1)


def local2global(origin, local):
    ecef0 = blh2ecef(origin)
    cn0e = cne(origin)
    ecef1 = ecef0 + np.einsum("...ij,...j->...i", cn0e, np.asarray(local, np.float64))
    return ecef2blh(ecef1)


def global2local(origin, global_blh):
    ecef0 = blh2ecef(origin)
    cn0e = cne(origin)
    ecef1 = blh2ecef(global_blh)
    return np.einsum("...ji,...j->...i", cn0e, ecef1 - ecef0)


def local2global_pose(origin, R_local, t_local):
    """Local poses (..., 3, 3), (..., 3) -> (blh (..., 3), R_global (..., 3, 3))
    (earth.h:194-208)."""
    cn0e = cne(origin)
    ecef1 = blh2ecef(origin) + np.einsum("ij,...j->...i", cn0e, np.asarray(t_local, np.float64))
    blh1 = ecef2blh(ecef1)
    return blh1, np.swapaxes(cne(blh1), -1, -2) @ cn0e @ np.asarray(R_local, np.float64)


def matrix_to_euler(dcm):
    """C_b^n (..., 3, 3) -> RPY, ZYX, heading in [0, 2pi), with the
    gimbal-lock branches of rotation.h:44-66 (the read-out of the JAX
    package's ``quaternion.matrix_to_euler``)."""
    dcm = np.asarray(dcm, np.float64)
    pitch = np.arctan(-dcm[..., 2, 0] / np.sqrt(dcm[..., 2, 1] ** 2 + dcm[..., 2, 2] ** 2))
    roll = np.arctan2(dcm[..., 2, 1], dcm[..., 2, 2])
    yaw = np.arctan2(dcm[..., 1, 0], dcm[..., 0, 0])
    yaw = np.where(dcm[..., 2, 0] <= -0.999,
                   np.arctan2(dcm[..., 1, 2] - dcm[..., 0, 1], dcm[..., 0, 2] + dcm[..., 1, 1]), yaw)
    yaw = np.where(dcm[..., 2, 0] >= 0.999,
                   np.pi + np.arctan2(dcm[..., 1, 2] + dcm[..., 0, 1], dcm[..., 0, 2] - dcm[..., 1, 1]), yaw)
    yaw = np.where(yaw < 0, 2.0 * np.pi + yaw, yaw)
    return np.stack([roll, pitch, yaw], axis=-1)


def iewn_at_lat(lat):
    lat = np.asarray(lat, np.float64)
    return np.stack(
        [WGS84_WIE * np.cos(lat), np.zeros_like(lat), -WGS84_WIE * np.sin(lat)],
        axis=-1,
    )


def iewn(origin, local):
    g = local2global(origin, local)
    return iewn_at_lat(g[..., 0])
