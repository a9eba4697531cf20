"""WGS-84 earth model: gravity, frames, BLH/ECEF/local-frame transforms.

Port of ``ic_gvins_tpu/core/earth.py`` (parity target:
IC-GVINS ``common/earth.h:34-248``). Torch functions on float64 tensors that
broadcast over leading dims. ``ecef2blh`` runs a fixed 10-iteration loop in
place of the reference's data-dependent one (converged to < 0.1 mm well
before that for |h| < 100 km), as the JAX twin does.
"""

import torch

from .earth_np import WGS84_E1, WGS84_E2, WGS84_F, WGS84_GM0, WGS84_RA, WGS84_RB, WGS84_WIE  # noqa: F401


def gravity(blh):
    """Normal gravity at geodetic position blh = (lat, lon, height)."""
    sin2 = torch.sin(blh[..., 0]) ** 2
    return (
        9.7803267715 * (1 + 0.0052790414 * sin2 + 0.0000232718 * sin2 * sin2)
        + blh[..., 2] * (0.0000000043977311 * sin2 - 0.0000030876910891)
        + 0.0000000000007211 * blh[..., 2] ** 2
    )


def meridian_prime_vertical_radius(lat):
    """(RM, RN): meridian and prime-vertical radii of curvature."""
    tmp = 1.0 - WGS84_E1 * torch.sin(lat) ** 2
    sqrttmp = torch.sqrt(tmp)
    rm = WGS84_RA * (1 - WGS84_E1) / (sqrttmp * tmp)
    rn_ = WGS84_RA / sqrttmp
    return torch.stack([rm, rn_], dim=-1)


def rn(lat):
    sinlat = torch.sin(lat)
    return WGS84_RA / torch.sqrt(1.0 - WGS84_E1 * sinlat * sinlat)


def cne(blh):
    """DCM from n-frame (NED) to e-frame at blh."""
    sinlat, coslat = torch.sin(blh[..., 0]), torch.cos(blh[..., 0])
    sinlon, coslon = torch.sin(blh[..., 1]), torch.cos(blh[..., 1])
    row0 = torch.stack([-sinlat * coslon, -sinlon, -coslat * coslon], dim=-1)
    row1 = torch.stack([-sinlat * sinlon, coslon, -coslat * sinlon], dim=-1)
    row2 = torch.stack([coslat, torch.zeros_like(coslat), -sinlat], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def blh2ecef(blh):
    coslat, sinlat = torch.cos(blh[..., 0]), torch.sin(blh[..., 0])
    coslon, sinlon = torch.cos(blh[..., 1]), torch.sin(blh[..., 1])
    rn_ = rn(blh[..., 0])
    rnh = rn_ + blh[..., 2]
    return torch.stack(
        [rnh * coslat * coslon, rnh * coslat * sinlon, (rnh - rn_ * WGS84_E1) * sinlat], dim=-1
    )


def ecef2blh(ecef):
    """Iterative ECEF -> geodetic, fixed 10 iterations (earth.h:132-150)."""
    p = torch.sqrt(ecef[..., 0] ** 2 + ecef[..., 1] ** 2)
    lon = 2.0 * torch.atan2(ecef[..., 1], ecef[..., 0] + p)
    lat = torch.atan(ecef[..., 2] / (p * (1.0 - WGS84_E1)))
    h = torch.zeros_like(p)
    for _ in range(10):
        rn_ = rn(lat)
        h = p / torch.cos(lat) - rn_
        lat = torch.atan(ecef[..., 2] / (p * (1.0 - WGS84_E1 * rn_ / (rn_ + h))))
    return torch.stack([lat, lon, h], dim=-1)


def local2global(origin, local):
    """n-frame point at `origin` -> geodetic BLH (earth.h:174-183)."""
    ecef1 = blh2ecef(origin) + (cne(origin) @ local[..., None])[..., 0]
    return ecef2blh(ecef1)


def global2local(origin, global_blh):
    """Geodetic BLH -> n-frame point at `origin` (earth.h:185-192)."""
    d = blh2ecef(global_blh) - blh2ecef(origin)
    return (cne(origin).transpose(-1, -2) @ d[..., None])[..., 0]


def local2global_pose(origin, R_local, t_local):
    """Local pose -> (blh, R_global) (earth.h:194-208)."""
    cn0e = cne(origin)
    blh1 = ecef2blh(blh2ecef(origin) + (cn0e @ t_local[..., None])[..., 0])
    return blh1, cne(blh1).transpose(-1, -2) @ cn0e @ R_local


def global2local_pose(origin, R_global, blh):
    """Global pose -> (R_local, t_local) (earth.h:210-223)."""
    cn0t = cne(origin).transpose(-1, -2)
    d = blh2ecef(blh) - blh2ecef(origin)
    return cn0t @ cne(blh) @ R_global, (cn0t @ d[..., None])[..., 0]


def iewn_at_lat(lat):
    """Earth rotation rate in the n-frame at latitude."""
    return torch.stack([WGS84_WIE * torch.cos(lat), torch.zeros_like(lat), -WGS84_WIE * torch.sin(lat)], dim=-1)


def iewn(origin, local):
    """Earth rotation rate at a local position w.r.t. origin (earth.h:233-237)."""
    return iewn_at_lat(local2global(origin, local)[..., 0])


def enwn(origin, local, vel):
    """Transport rate at local position (earth.h:239-248)."""
    g = local2global(origin, local)
    rmn = meridian_prime_vertical_radius(g[..., 0])
    rm, rn_ = rmn[..., 0], rmn[..., 1]
    lat, h = g[..., 0], g[..., 2]
    return torch.stack(
        [vel[..., 1] / (rn_ + h), -vel[..., 0] / (rm + h), -vel[..., 1] * torch.tan(lat) / (rn_ + h)],
        dim=-1,
    )
