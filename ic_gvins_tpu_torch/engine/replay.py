"""Deterministic replay substrate: IMU stream slicing + chunked mechanization.

Port of ``ic_gvins_tpu/engine/replay.py``. The full sensor streams are known
up front; IMU propagation between events runs in fixed 256-sample padded
chunks of the log-depth mechanization. ``ImuStream`` is host numpy, carried
over unchanged: endpoint interpolation at node times reproduces
MISC::getImuSeriesFromTo / imuInterpolation (IC-GVINS ``misc.cc:263-361``).
``InsPropagator`` copies the whole stream to the device once and slices its
chunks there; the chunk cursor and times live on the host, so slicing needs
no device read.
"""

import numpy as np
import torch

from ..core.types import ImuBatch, NavState
from ..ins import mechanization as mech
from ..utils import timecost
from .host import fetch

MINIMUM_TIME_INTERVAL = 1.0e-4


def _chunk_inputs(sd: ImuBatch, st: NavState, j0, n, chunk):
    """The ``chunk``-sample window [j0, j0+n) of the device-resident stream,
    masked past n, and the bias-compensated previous sample (j0-1); j0 and n
    are host ints."""
    sl = lambda a: a[j0:j0 + chunk]  # noqa: E731
    mask = torch.arange(chunk, device=sd.dt.device) < n
    imu = ImuBatch(
        time=sl(sd.time),
        dt=torch.where(mask, sl(sd.dt), 0.0),
        dtheta=torch.where(mask[:, None], sl(sd.dtheta), 0.0),
        dvel=torch.where(mask[:, None], sl(sd.dvel), 0.0),
        odovel=torch.where(mask, sl(sd.odovel), 0.0),
    )
    if j0 <= 0:
        z = torch.zeros_like(st.p)
        return imu, (torch.zeros_like(st.time), z, z)
    pdt = sd.dt[j0 - 1]
    return imu, (pdt, sd.dtheta[j0 - 1] - pdt * st.bg, sd.dvel[j0 - 1] - pdt * st.ba)


class ImuStream:
    """Host-side random access into the replayed IMU stream.

    data: dict of numpy arrays: time (T,), dt (T,), dtheta (T,3), dvel (T,3),
    odovel (T,) distance increments. Samples are increment-form; time is the
    sample END time (reference convention)."""

    def __init__(self, data):
        self.time = np.asarray(data["time"], np.float64)
        self.dt = np.asarray(data["dt"], np.float64)
        self.dtheta = np.asarray(data["dtheta"], np.float64)
        self.dvel = np.asarray(data["dvel"], np.float64)
        self.odovel = np.asarray(data.get("odovel", np.zeros_like(self.time)), np.float64)
        self.T = len(self.time)

    def index_after(self, t):
        """First sample index with time > t."""
        return int(np.searchsorted(self.time, t, side="right"))

    def _sample(self, i):
        return dict(time=self.time[i], dt=self.dt[i], dtheta=self.dtheta[i].copy(),
                    dvel=self.dvel[i].copy(), odovel=self.odovel[i])

    def _split(self, i, t):
        """Split sample i at interior time t (imuInterpolation,
        misc.cc:288-305). Returns (first_part, second_part)."""
        s = self._sample(i)
        scale = (s["time"] - t) / s["dt"]
        first = dict(time=t, dt=s["dt"] - (s["time"] - t), dtheta=s["dtheta"] * (1 - scale),
                     dvel=s["dvel"] * (1 - scale), odovel=s["odovel"] * (1 - scale))
        second = dict(time=s["time"], dt=s["time"] - t, dtheta=s["dtheta"] * scale,
                      dvel=s["dvel"] * scale, odovel=s["odovel"] * scale)
        return first, second

    def series(self, start, end):
        """IMU samples covering (start, end] with interpolated endpoints;
        element 0 is the anchor sample (not integrated). Mirrors
        MISC::getImuSeriesFromTo (misc.cc:307-361)."""
        i_s = self.index_after(start)
        out = []

        # start boundary
        if i_s == 0:
            out.append(self._sample(0))
            i_mid = 1
        else:
            prev = self._sample(i_s - 1)
            cur = self._sample(i_s) if i_s < self.T else None
            if abs(prev["time"] - start) < MINIMUM_TIME_INTERVAL or cur is None:
                out.append(prev)
            elif abs(cur["time"] - start) < MINIMUM_TIME_INTERVAL:
                out.append(cur)
                i_s += 1
            else:
                first, second = self._split(i_s, start)
                out.append(first)
                out.append(second)
                i_s += 1
            i_mid = i_s

        # middle whole samples
        while i_mid < self.T and self.time[i_mid] < end - MINIMUM_TIME_INTERVAL:
            out.append(self._sample(i_mid))
            i_mid += 1

        # end boundary
        if i_mid < self.T:
            if abs(self.time[i_mid] - end) < MINIMUM_TIME_INTERVAL:
                out.append(self._sample(i_mid))
            else:
                first, _ = self._split(i_mid, end)
                out.append(first)
        out[-1]["time"] = end
        return {f: np.stack([np.asarray(s[f]) for s in out])
                for f in ("time", "dt", "dtheta", "dvel", "odovel")}


class InsPropagator:
    """Chunked INS mechanization over the replayed stream with per-sample
    trajectory output (the fusion thread's per-sample loop,
    ic_gvins.cc:249-293 + MISC::writeNavResult). Runs on ``device``, the
    card unless the caller asks for the CPU."""

    def __init__(self, stream: ImuStream, gravity, iewn, iswithearth, chunk=256, device="cuda"):
        self.stream = stream
        self.chunk = chunk
        self.iswithearth = iswithearth
        self.device = torch.device(device)
        self.gravity = torch.tensor(np.asarray(gravity, np.float64), device=self.device)
        self.iewn = torch.tensor(np.asarray(iewn, np.float64), device=self.device)
        # the WHOLE stream lives on the device (one copy per episode), padded
        # so every chunk slice is full length
        pad = chunk + 1
        cat = lambda a, *tail: np.concatenate([a, np.zeros((pad,) + tail)])  # noqa: E731
        self._dev = ImuBatch(*[torch.tensor(a, device=self.device) for a in (
            cat(stream.time), cat(stream.dt), cat(stream.dtheta, 3), cat(stream.dvel, 3),
            cat(stream.odovel))])
        self.state = None      # NavState of tensors on the device
        self._time_host = 0.0  # host mirror of state.time (no device reads)
        self.cursor = 0        # next sample index to process

    def _config(self):
        return mech.MechConfig(gravity=self.gravity, iewn=self.iewn, iswithearth=self.iswithearth)

    def set_state(self, state: NavState, restart_time=None):
        """Adopt an (optimized) state given as host numpy or tensors; the next
        propagate re-runs from its time (redoInsMechanization,
        misc.cc:208-261)."""
        self.state = NavState(*[torch.tensor(np.asarray(a, np.float64), device=self.device)
                                if not isinstance(a, torch.Tensor) else a.to(self.device)
                                for a in state])
        t = float(state.time) if restart_time is None else restart_time
        self._time_host = t
        self.cursor = self.stream.index_after(t + MINIMUM_TIME_INTERVAL)

    def update_iewn(self, iewn):
        self.iewn = torch.tensor(np.asarray(iewn, np.float64), device=self.device)

    @timecost.traced("ins.propagate")
    def propagate_to(self, t_end, sample_cb=None):
        """Mechanize through all whole samples with time <= t_end. Calls
        sample_cb(times, p, q, v) (numpy, one device read per chunk) for
        output. The state ends at the last processed sample."""
        end_idx = self.stream.index_after(t_end + MINIMUM_TIME_INTERVAL)
        s = self.stream
        cfg = self._config()
        while self.cursor < end_idx:
            j0 = self.cursor
            j1 = min(j0 + self.chunk, end_idx)
            n = j1 - j0
            imu, prev = _chunk_inputs(self._dev, self.state, j0, n, self.chunk)
            self.state, (p, q, v) = mech.mechanize_scan(cfg, self.state, imu, imu_prev=prev)
            if sample_cb is not None:
                sample_cb(s.time[j0:j1], *fetch(p[:n], q[:n], v[:n]))
            self._time_host = s.time[j1 - 1]
            self.cursor = j1

    def pose_interpolated(self, t):
        """Interpolated (p, q) at time t (MISC::getCameraPoseFromInsWindow /
        statePoseInterpolation, misc.cc:67-100): propagate through samples
        <= t, then one fused peek + interpolation. Does not advance the
        cursor past t. Returns numpy (p, q)."""
        self.propagate_to(t)
        if self.cursor >= self.stream.T or abs(self._time_host - t) < MINIMUM_TIME_INTERVAL:
            return fetch(self.state.p, self.state.q)
        imu, prev = _chunk_inputs(self._dev, self.state, self.cursor, 1, 1)
        st1, _ = mech.mechanize_scan(self._config(), self.state, imu, imu_prev=prev)
        t = torch.tensor(t, dtype=torch.float64, device=self.device)
        return fetch(*mech.interpolate_pose(self.state.p, self.state.q, self.state.time,
                                            st1.p, st1.q, st1.time, t))
