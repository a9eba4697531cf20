"""GINS model: tightly-coupled GNSS/INS sliding-window replay.

Port of ``ic_gvins_tpu/models/gins.py``: the reference's INITIALIZING ->
INITIALIZING_INS pipeline (IC-GVINS ``ic_gvins.cc:297-330, 584-722``) replayed
deterministically: GNSS/INS alignment (zero-velocity gyro bias + leveling,
heading from the GNSS velocity or a dual-antenna yaw), priors, a time node
per GNSS fix with its IMU preintegration, window LM solves, reintegration on
bias jumps, INS feedback re-mechanization, and sliding-window
marginalization. Writes gvins.nav / trajectory.csv / IMU_ERR.bin with the
reference schemas. Runs on ``device``, the card unless the caller asks for
the CPU; nothing falls back.
"""

import math

import numpy as np
import torch

from ..core import earth_np, quaternion as quat
from ..core.types import NavState, integration_params_from_config
from ..engine.config import GvinsConfig
from ..engine.estimator import SlidingWindowEstimator
from ..engine.output import OutputFiles
from ..engine.replay import ImuStream, InsPropagator
from ..ins import mechanization as mech
from ..solver.problem import WindowConfig

D2R = math.pi / 180.0
MINMUM_ALIGN_VELOCITY = 0.5       # ic_gvins.h:128
GYROSCOPE_BIAS_PRIOR_STD = 7200 * D2R / 3600
ACCELEROMETER_BIAS_PRIOR_STD = 20000 * 1.0e-5


class GinsModel:
    """Deterministic GNSS/INS replay engine."""

    def __init__(self, cfg: GvinsConfig, outdir=None, window_nodes=None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        n_window = window_nodes or cfg.optimize_windows_size + 2
        self.wcfg = WindowConfig(N=max(n_window, 4), L=8, G=max(n_window, 4), R=8,
                                 with_earth=cfg.iswithearth, with_odo=cfg.isuseodo)
        self.outdir = outdir
        self.out = None

        self.origin = None
        self.gravity = None
        self.int_params = None
        self.est = None
        self.prop = None
        self.state = "INITIALIZING"

        # init bookkeeping
        self._bg = np.zeros(3)
        self._initatt = np.zeros(3)
        self._has_zero_velocity = False
        self.trajectory = []  # (time, p(3), q(4)) at node times

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def run(self, imu_data, gnss_data):
        """Replay full streams. imu_data: dict (time, dt, dtheta, dvel[,odovel]);
        gnss_data: dict (time (K,), blh (K,3) geodetic rad/m, std (K,3)[, yaw,
        isyawvalid]). Runs in inference mode: no autograd bookkeeping on the
        thousands of small ops an epoch runs."""
        stream = ImuStream(imu_data)
        if self.outdir:
            self.out = OutputFiles(self.outdir)

        try:
            last_gnss = None
            for gnss in self._gnss_fixes(gnss_data):
                if self.state == "INITIALIZING":
                    if last_gnss is not None:
                        self._try_initialize(stream, last_gnss, gnss)
                    last_gnss = gnss
                else:
                    self._process_gnss(stream, gnss)

            # tail: INS output after the last usable GNSS (the fusion thread
            # mechanizes through outages, ic_gvins.cc:281-293)
            if self.prop is not None:
                self.prop.propagate_to(float(stream.time[-1]), sample_cb=self._write_samples if self.out else None)
        finally:
            if self.out:
                self.out.close()
        return np.asarray(self.trajectory) if self.trajectory else np.zeros((0, 8))

    def _gnss_fixes(self, gnss_data):
        """The fixes that pass the ingest gates (fusion_ros.cc:178-198), in
        the order given, as dicts (time, blh, std, yaw, isyawvalid) with blh
        in the local frame. The first sets the world origin and local
        gravity."""
        gtime = np.asarray(gnss_data["time"], np.float64)
        gblh = np.asarray(gnss_data["blh"], np.float64)
        gstd = np.asarray(gnss_data["std"], np.float64)
        gyaw = np.asarray(gnss_data.get("yaw", np.zeros(len(gtime))), np.float64)
        gyawvalid = np.asarray(gnss_data.get("isyawvalid", np.zeros(len(gtime), bool)), bool)
        fixes = []
        for k in range(len(gtime)):
            if (gstd[k] == 0).all() or np.linalg.norm(gstd[k]) > self.cfg.gnssthreshold:
                continue
            if self.cfg.isusegnssoutage and gtime[k] >= self.cfg.gnssoutagetime:
                continue
            if self.origin is None:
                self.origin = gblh[k].copy()
                self.gravity = float(earth_np.gravity(self.origin))
                blh_local = np.zeros(3)
            else:
                blh_local = earth_np.global2local(self.origin, gblh[k])
            fixes.append(dict(time=float(gtime[k]), blh=blh_local, std=gstd[k].copy(),
                              yaw=float(gyaw[k]), isyawvalid=bool(gyawvalid[k])))
        return fixes

    # ------------------------------------------------------------------

    def _try_initialize(self, stream, last_gnss, gnss):
        """gvinsInitialization (ic_gvins.cc:584-692). The alignment's few
        host-side scalars are computed on the CPU, whatever the device."""
        i0 = stream.index_after(last_gnss["time"])
        i1 = stream.index_after(gnss["time"])
        if i1 - i0 < 20:
            return False
        cpu = lambda a: torch.tensor(np.asarray(a, np.float64))  # noqa: E731
        is_zero, mean_th, mean_dv = mech.detect_zero_velocity(
            cpu(stream.dtheta[i0:i1]), cpu(stream.dvel[i0:i1]), torch.ones(i1 - i0, dtype=torch.float64),
            self.cfg.imudatarate)
        if bool(is_zero):
            self._bg = mean_th.numpy() * self.cfg.imudatarate
            fb = mean_dv.numpy() * self.cfg.imudatarate
            self._initatt[0] = -math.asin(np.clip(fb[1] / self.gravity, -1, 1))
            self._initatt[1] = math.asin(np.clip(fb[0] / self.gravity, -1, 1))
            self._has_zero_velocity = True
            return False

        if last_gnss.get("isyawvalid", False):
            self._initatt[2] = last_gnss["yaw"]   # dual-antenna heading (ic_gvins.cc:631-633)
        else:
            vel = gnss["blh"] - last_gnss["blh"]
            if np.linalg.norm(vel) < MINMUM_ALIGN_VELOCITY:
                return False
            if not self._has_zero_velocity:
                self._initatt[0] = 0.0
                self._initatt[1] = math.atan(-vel[2] / math.hypot(vel[0], vel[1]))
            self._initatt[2] = math.atan2(vel[1], vel[0])

        q0 = quat.euler_to_quat(cpu(self._initatt))
        p0 = last_gnss["blh"] - quat.rotate(q0, cpu(self.cfg.antlever)).numpy()
        z3 = np.zeros(3)
        state0 = NavState(time=np.float64(last_gnss["time"]), p=p0, q=q0.numpy(), v=z3, bg=self._bg.copy(),
                          ba=z3, sodo=np.float64(0.0), sg=z3, sa=z3)

        self.int_params = integration_params_from_config(self.cfg, gravity=self.gravity, device=self.device)
        self.est = SlidingWindowEstimator(self.wcfg, self.int_params, preint_samples=self.cfg.preint_samples,
                                          antlever=self.cfg.antlever, origin=self.origin, device=self.device)
        self.est.reset_first_node(last_gnss["time"], state0)
        self.est.add_gnss(last_gnss["time"], last_gnss["blh"], last_gnss["std"])
        self._construct_prior(state0)

        iewn = earth_np.iewn(self.origin, p0) if self.cfg.iswithearth else np.zeros(3)
        self.prop = InsPropagator(stream, gravity=[0.0, 0.0, self.gravity], iewn=iewn,
                                  iswithearth=self.cfg.iswithearth, device=self.device)
        self.prop.set_state(state0)

        self._add_gnss_node(stream, gnss)   # the current GNSS becomes node 1
        self.state = "INITIALIZING_INS"
        return True

    def _construct_prior(self, state0: NavState):
        """constructPrior (ic_gvins.cc:1911-1936)."""
        bg_std = 3.0 * self.cfg.imumodel.gbstd if self._has_zero_velocity else GYROSCOPE_BIAS_PRIOR_STD
        pose_prior = np.concatenate([state0.p, state0.q])
        pose_std = np.array([0.1, 0.1, 0.1, 0.5 * D2R, 0.5 * D2R, 1.5 * D2R])
        mix_prior = np.concatenate([state0.v, state0.bg, state0.ba])
        mix_std = np.concatenate([np.full(3, 0.1), np.full(3, bg_std), np.full(3, ACCELEROMETER_BIAS_PRIOR_STD)])
        if self.cfg.isuseodo:   # sodo prior: 5000 PPM (ic_gvins.cc:1917,1934)
            mix_prior = np.concatenate([mix_prior, [float(state0.sodo)]])
            mix_std = np.concatenate([mix_std, [0.005]])
        self.est.set_prior(pose_prior, pose_std, mix_prior, mix_std)

    # ------------------------------------------------------------------

    def _chain_time_nodes(self, stream, t_target, shed_capacity=None):
        """Insert intermediate time nodes so no preintegration segment spans
        more IMU samples than its fixed capacity (the reference bounds spans
        the same way, MAXIMUM_PREINTEGRATION_LENGTH, ic_gvins.h:134-136 +
        ic_gvins.cc:858-862). ``shed_capacity`` frees node slots when the
        window fills (by default: marginalize the oldest node at the small
        tier; ``GvinsModel`` passes its keyframe-aware shed)."""
        shed = shed_capacity or (lambda: self.est.marginalize(1, wc=self.est.wcfg_small))
        max_dt = (self.cfg.preint_samples - 2) / self.cfg.imudatarate
        t0 = float(self.est.times[self.est.n_nodes - 1])
        while t_target - t0 > max_dt:
            t0 += max_dt
            self.est.add_time_node(t0, stream.series(self.est.times[self.est.n_nodes - 1], t0))
            if self.est.n_nodes >= self.wcfg.N - 1:
                shed()

    def _add_gnss_node(self, stream, gnss):
        self._chain_time_nodes(stream, gnss["time"])
        series = stream.series(self.est.times[self.est.n_nodes - 1], gnss["time"])
        self.est.add_time_node(gnss["time"], series)
        self.est.add_gnss(gnss["time"], gnss["blh"], gnss["std"])

    def _process_gnss(self, stream, gnss):
        """INITIALIZING_INS loop body (ic_gvins.cc:313-330, 395-425)."""
        # propagate + write per-sample nav output up to the node time
        self.prop.propagate_to(gnss["time"], sample_cb=self._write_samples if self.out else None)
        self._add_gnss_node(stream, gnss)
        # no landmark/reprojection rows live in GNSS/INS: the small tier fits
        self.est.optimize(num_iterations=50, wc=self.est.wcfg_small)
        self.est.reintegrate_if_needed()
        # window management: marginalize the oldest node when slots are full
        if self.est.n_nodes >= self.wcfg.N - 1:
            self.est.marginalize(1, wc=self.est.wcfg_small)
        # feedback: re-mechanize forward from the newest optimized node
        st = self.est.latest_state()
        if self.cfg.iswithearth:
            self.prop.update_iewn(earth_np.iewn(self.origin, st.p))
        self.prop.set_state(st)
        self.trajectory.append([st.time, *st.p, *st.q])

    def _write_samples(self, times, p, q, v):
        k = self.est.n_nodes - 1
        self.out.write_nav_chunk(self.origin, times, p, q, v, self.est.mixes[k, 3:6], self.est.mixes[k, 6:9])
