"""The seeded world of a replay cell, in plain NumPy: the drive, its IMU
increments and GNSS fixes with their truth, and the textured street the
camera sees.

Nothing here imports the program. The earth model is WGS-84 as IC-GVINS
states it (``common/earth.h``); quaternions are xyzw Hamilton products, the
body frame is front-right-down and the local frame north-east-down.

The drive (the configuration's ``drive``): ``still_s`` seconds at rest, then
``accel_s`` seconds of constant forward acceleration to ``speed_mps``, then a
coordinated turn at ``yaw_rate_rps`` for the rest of the log, with
motion-correlated vibration so the zero-velocity detector sees the vehicle
move (the repo's drive, its vibration in cosine phase so that the speed stays
the configured one). With the earth rate on, the gyro senses it through the true attitude.
The truth is the strapdown mechanization of the bias-free increments
(:func:`mechanize_scan`), so the increments and the truth agree to rounding.
The measured increments add the configured biases and white noise at the
IMU model's densities; GNSS fixes come at whole seconds, at the antenna
through the lever arm, plus white noise.
"""

import numpy as np

# WGS-84 (IC-GVINS common/earth.h)
WGS84_WIE = 7.2921151467e-5
WGS84_RA = 6378137.0
WGS84_E1 = 0.0066943799901413156


# --------------------------------------------------------------------------
# earth
# --------------------------------------------------------------------------

def gravity(blh):
    """Normal gravity at geodetic (lat, lon, height)."""
    sin2 = np.sin(blh[0]) ** 2
    return (9.7803267715 * (1 + 0.0052790414 * sin2 + 0.0000232718 * sin2 * sin2)
            + blh[2] * (0.0000000043977311 * sin2 - 0.0000030876910891) + 0.0000000000007211 * blh[2] ** 2)


def _rn(lat):
    return WGS84_RA / np.sqrt(1.0 - WGS84_E1 * np.sin(lat) ** 2)


def cne(blh):
    """Rotation from the local NED frame at ``blh`` to ECEF."""
    sl, cl = np.sin(blh[0]), np.cos(blh[0])
    so, co = np.sin(blh[1]), np.cos(blh[1])
    return np.array([[-sl * co, -so, -cl * co], [-sl * so, co, -cl * so], [cl, 0.0, -sl]])


def blh2ecef(blh):
    blh = np.asarray(blh, np.float64)
    lat, lon, h = blh[..., 0], blh[..., 1], blh[..., 2]
    rn = _rn(lat)
    return np.stack([(rn + h) * np.cos(lat) * np.cos(lon), (rn + h) * np.cos(lat) * np.sin(lon),
                     (rn * (1 - WGS84_E1) + h) * np.sin(lat)], axis=-1)


def ecef2blh(ecef):
    p = np.hypot(ecef[..., 0], ecef[..., 1])
    lon = np.arctan2(ecef[..., 1], ecef[..., 0])
    lat = np.arctan(ecef[..., 2] / (p * (1.0 - WGS84_E1)))
    for _ in range(10):
        rn = _rn(lat)
        h = p / np.cos(lat) - rn
        lat = np.arctan(ecef[..., 2] / (p * (1.0 - WGS84_E1 * rn / (rn + h))))
    return np.stack([lat, lon, h], axis=-1)


def local2global(origin, local):
    """Local NED positions (..., 3) at ``origin`` -> geodetic (..., 3)."""
    return ecef2blh(blh2ecef(origin) + np.asarray(local, np.float64) @ cne(origin).T)


def earth_rate(blh):
    """The earth rotation rate in the NED frame at ``blh``."""
    return np.array([WGS84_WIE * np.cos(blh[0]), 0.0, -WGS84_WIE * np.sin(blh[0])])


# --------------------------------------------------------------------------
# quaternions (xyzw, Hamilton)
# --------------------------------------------------------------------------

IDENTITY = np.array([0.0, 0.0, 0.0, 1.0])


def qmul(a, b):
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], axis=-1)


def qconj(q):
    return q * np.array([-1.0, -1.0, -1.0, 1.0], q.dtype)


def qnormalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def qmatrix(q):
    x, y, z, w = np.moveaxis(q, -1, 0)
    return np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
                     np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
                     np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)],
                    axis=-2)


def qrotate(q, v):
    return np.einsum("...ij,...j->...i", qmatrix(q), v)


def from_rotvec(rv):
    a2 = np.sum(rv * rv, axis=-1, keepdims=True)
    a = np.sqrt(a2)
    small = a2 < 1e-16
    k = np.where(small, 0.5 - a2 / 48.0, np.sin(0.5 * a) / np.where(small, 1.0, a))
    w = np.where(small, 1.0 - a2 / 8.0, np.cos(0.5 * a))
    return np.concatenate([rv * k, w], axis=-1).astype(rv.dtype)


def skew(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


# --------------------------------------------------------------------------
# strapdown mechanization
# --------------------------------------------------------------------------

def dual_sample(dth, dvl, dth_pre, dvl_pre):
    """Coning and sculling over two samples (IC-GVINS misc.cc:160-173)."""
    dvfb = dvl + 0.5 * np.cross(dth, dvl) + (np.cross(dth_pre, dvl) + np.cross(dvl_pre, dth)) / 12.0
    return dvfb, dth + np.cross(dth_pre, dth) / 12.0


def mechanize_steps(p, q, v, bg, ba, dt, dtheta, dvel, prev, g, iewn, with_earth, dtype=np.float64):
    """The strapdown update one sample at a time (misc.cc:151-206) in
    ``dtype``: the plain reference of the program's INS propagation. ``prev``
    is the (dt, dtheta, dvel) of the sample before the first, raw or None.
    Returns per-sample (p, q, v) arrays."""
    cast = lambda a: np.asarray(a, np.float64).astype(dtype)  # noqa: E731
    p, q, v, bg, ba = (cast(a) for a in (p, q, v, bg, ba))
    gvec, iewn = cast([0.0, 0.0, g]), cast(iewn)
    if prev is None:
        th_pre = vl_pre = np.zeros(3, dtype)
    else:
        th_pre, vl_pre = cast(prev[1]) - cast(prev[0]) * bg, cast(prev[2]) - cast(prev[0]) * ba
    out_p, out_q, out_v = [], [], []
    for dt_k, th, vl in zip(cast(dt), cast(dtheta), cast(dvel)):
        th, vl = th - dt_k * bg, vl - dt_k * ba
        dvfb, dq = dual_sample(th, vl, th_pre, vl_pre)
        if with_earth:
            qnn = from_rotvec(-iewn * dt_k)
            rot = qrotate(q, dvfb)
            dv = 0.5 * (rot + qrotate(qnn, rot)) + (gvec - 2.0 * np.cross(iewn, v)) * dt_k
            q = qnormalize(qmul(qmul(qnn, q), from_rotvec(dq)))
        else:
            dv = qrotate(q, dvfb) + gvec * dt_k
            q = qnormalize(qmul(q, from_rotvec(dq)))
        p = p + dt_k * v + 0.5 * dt_k * dv
        v = v + dv
        th_pre, vl_pre = th, vl
        out_p.append(p)
        out_q.append(q)
        out_v.append(v)
    return np.stack(out_p), np.stack(out_q), np.stack(out_v)


def _scan(combine, elems):
    """Inclusive Hillis-Steele scan along axis 0 of the tuple ``elems``."""
    out, n, k = tuple(elems), len(elems[0]), 1
    while k < n:
        comb = combine(tuple(x[:n - k] for x in out), tuple(x[k:] for x in out))
        out = tuple(np.concatenate([x[:k], c]) for x, c in zip(out, comb))
        k *= 2
    return out


def mechanize_scan(dt, dtheta, dvel, g, iewn, with_earth):
    """The same update from rest at the identity attitude, with no bias and
    no sample before the first, as prefix scans over the whole series (fast
    enough for the truth of minutes of IMU). Returns per-sample (p, q, v)."""
    n = len(dt)
    dt3 = dt[:, None]
    shift = lambda a: np.concatenate([np.zeros_like(a[:1]), a[:-1]])  # noqa: E731
    dvfb, dth = dual_sample(dtheta, dvel, shift(dtheta), shift(dvel))
    gvec = np.array([0.0, 0.0, g])
    R = _scan(lambda a, b: (qmul(a[0], b[0]),), (from_rotvec(dth),))[0]
    if with_earth:
        # q_k = qnn^k (x) q_0 (x) dq_1 ... dq_k, qnn about a fixed axis
        L = from_rotvec(-np.asarray(iewn)[None, :] * np.cumsum(dt)[:, None])
        q = qnormalize(qmul(L, R))
        rot = qrotate(np.concatenate([IDENTITY[None], q[:-1]]), dvfb)
        c = 0.5 * (rot + qrotate(from_rotvec(-np.asarray(iewn)[None, :] * dt3), rot)) + gvec * dt3
        A = np.eye(3)[None] - 2.0 * dt[:, None, None] * skew(iewn)[None]
        _, v = _scan(lambda a, b: (b[0] @ a[0], np.einsum("nij,nj->ni", b[0], a[1]) + b[1]), (A, c))
    else:
        q = qnormalize(R)
        v = np.cumsum(qrotate(np.concatenate([IDENTITY[None], q[:-1]]), dvfb) + gvec * dt3, axis=0)
    p = np.cumsum(0.5 * dt3 * (shift(v) + v), axis=0)
    return p, q, v


# --------------------------------------------------------------------------
# the world
# --------------------------------------------------------------------------

def rng_for(seed, stream):
    """An independent generator for each use of one seed."""
    return np.random.default_rng([abs(int(seed)) & (2**64 - 1), stream])


def drive_rates(cfg, rate, n):
    """Body angular rate and specific force (n, 3) of the drive, without the
    earth rate, and the gravity magnitude of its origin."""
    d = cfg["drive"]
    lat, lon, h = cfg["origin_deg"]
    origin = np.array([np.deg2rad(lat), np.deg2rad(lon), float(h)])
    g = float(gravity(origin))
    t = np.arange(n) / rate
    accel = d["speed_mps"] / d["accel_s"]
    w = np.zeros((n, 3))
    f = np.tile([0.0, 0.0, -g], (n, 1))
    moving = t >= d["still_s"]
    accelerating = moving & (t < d["still_s"] + d["accel_s"])
    turning = t >= d["still_s"] + d["accel_s"]
    f[accelerating, 0] += accel
    w[turning, 2] = d["yaw_rate_rps"]
    f[turning, 1] += d["speed_mps"] * d["yaw_rate_rps"]   # the centripetal force of the turn
    # vibration in cosine phase from the start of motion, so that neither the
    # attitude nor the velocity it adds has a mean: the speed stays the source's
    tm = t[moving] - d["still_s"]
    w[moving] += 0.02 * np.cos(2 * np.pi * 2.0 * tm)[:, None] * np.array([1.0, 0.5, 0.8])
    f[moving] += 0.4 * np.cos(2 * np.pi * 1.3 * tm)[:, None] * np.array([0.6, 1.0, 0.7])
    return w, f, origin, g


def build(cfg, traffic, seed):
    """The world of configuration ``cfg`` (its JSON dict) and traffic mix
    ``traffic`` for ``seed``: a dict with the program's inputs (``imu``,
    ``gnss``, ``frame_times``) and the truth (``time``, ``p``, ``q``, ``v``,
    ``origin``, ``gnss_local``, ``g``, ``iewn``, ``rate``, ``points``)."""
    rate = float(cfg["imu_rate_hz"])
    dt = 1.0 / rate
    n = int(round(traffic["world_s"] * rate))
    w, f, origin, g = drive_rates(cfg, rate, n)
    with_earth = bool(cfg["with_earth"])
    iewn = earth_rate(origin) if with_earth else np.zeros(3)
    dts = np.full(n, dt)

    dth_true, q = w * dt, np.tile(IDENTITY, (n, 1))
    for _ in range(3 if with_earth else 1):   # the sensed earth rate through the truth attitude
        if with_earth:
            dth_true = w * dt + qrotate(qconj(np.concatenate([IDENTITY[None], q[:-1]])), iewn) * dt
        p, q, v = mechanize_scan(dts, dth_true, f * dt, g, iewn, with_earth)

    imu_cfg = cfg["imu"]
    rng = rng_for(seed, 0)
    arw, vrw = imu_cfg["arw_deg_per_sqrt_hr"] * np.pi / 180.0 / 60.0, imu_cfg["vrw_m_per_s_per_sqrt_hr"] / 60.0
    dtheta = dth_true + np.asarray(imu_cfg["gyro_bias_rps"]) * dt + rng.normal(0, arw * np.sqrt(dt), (n, 3))
    dvel = (f + np.asarray(imu_cfg["accel_bias_mps2"])) * dt + rng.normal(0, vrw * np.sqrt(dt), (n, 3))
    time = dt * (np.arange(n) + 1)
    imu = dict(time=time, dt=dts, dtheta=dtheta, dvel=dvel, odovel=np.zeros(n))

    gnss_cfg = cfg["gnss"]
    gt = np.arange(1.0, time[-1], 1.0 / gnss_cfg["rate_hz"])
    i = np.round(gt * rate).astype(int) - 1
    lever = np.asarray(cfg["antlever"], np.float64)
    gnss_local = p[i] + qrotate(q[i], lever) + rng.normal(0, gnss_cfg["noise_m"], (len(i), 3))
    gnss = dict(time=gt, blh=local2global(origin, gnss_local), std=np.full((len(gt), 3), gnss_cfg["std_m"]))

    cam = cfg["camera"]
    period = 1.0 / cam["rate_hz"]
    frame_times = np.arange(0.5 * period, time[-1] - 0.2, period)
    return dict(imu=imu, gnss=gnss, frame_times=frame_times, time=time, p=p, q=q, v=v, origin=origin,
                gnss_local=gnss_local, g=g, iewn=iewn, rate=rate, with_earth=with_earth,
                points=street(p, traffic["street"], seed))


def street(p, spec, seed):
    """Textured points of a street along the path, as a forward-looking
    camera sees an urban road: an anchor every ``spacing_m`` metres of the
    path, and at each the points that give ``density_per_m2`` over that
    stretch of two facades (``offset_m`` to either side of the path,
    ``height_m`` in the local down axis) and of the road (within
    ``road_half_width_m``, ``road_depth_m`` below the path)."""
    rng = rng_for(seed, 1)
    seg = np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    idx = np.searchsorted(s, np.arange(0.0, s[-1] + 1e-9, spec["spacing_m"]))
    anchors = p[idx, :2]
    ahead = p[np.minimum(idx + 1, len(p) - 1), :2] - p[np.maximum(idx - 1, 0), :2]
    ahead /= np.maximum(np.linalg.norm(ahead, axis=1, keepdims=True), 1e-9)
    ahead[np.linalg.norm(ahead, axis=1) < 0.5] = [1.0, 0.0]   # at rest: the start heading, north
    side = np.stack([-ahead[:, 1], ahead[:, 0]], axis=1)
    n, step = len(anchors), spec["spacing_m"]
    (o0, o1), (h0, h1), d = spec["offset_m"], spec["height_m"], spec["density_per_m2"]
    per_wall = int(round(d * step * (h1 - h0)))
    per_road = int(round(d * step * 2 * spec["road_half_width_m"]))

    def place(along, across, down):
        xy = anchors[:, None, :] + along[..., None] * ahead[:, None, :] + across[..., None] * side[:, None, :]
        return np.concatenate([xy, down[..., None]], axis=-1).reshape(-1, 3)

    walls = []
    for sign in (-1.0, 1.0):
        walls.append(place(rng.uniform(0, step, (n, per_wall)), sign * rng.uniform(o0, o1, (n, per_wall)),
                           rng.uniform(h0, h1, (n, per_wall))))
    half = spec["road_half_width_m"]
    road = place(rng.uniform(0, step, (n, per_road)), rng.uniform(-half, half, (n, per_road)),
                 np.full((n, per_road), float(spec["road_depth_m"])))
    return np.concatenate(walls + [road])


def truth_at(world, t):
    """Truth position(s) at time(s) ``t``, linear between IMU samples."""
    return np.stack([np.interp(t, world["time"], world["p"][:, k]) for k in range(3)], axis=-1)
