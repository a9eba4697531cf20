"""GVINS model: the tightly-coupled GNSS-visual-inertial replay.

Port of ``ic_gvins_tpu/models/gvins.py``, method for method: the GINS
initialization chain, then the visual pipeline INITIALIZING_VIO ->
TRACKING_INITIALIZING -> TRACKING_NORMAL (IC-GVINS ``ic_gvins.h:47-55``) with
INS-aided tracking (the port's ``Tracker``, its three hand kernels), keyframe
time nodes, GNSS node insertion, the two-pass window solve over GNSS,
preintegration and reprojection factors with chi2 surgery, extrinsic/td
estimation behind sanity gates, landmark depth updates, visual outlier
culling, second-new-frame removal with preintegration merging, and Schur
marginalization.

The reference's four threads become deterministic replay phases per event (a
GNSS fix or a camera frame). The map, the keyframe policy and the table
packing are host numpy; the tracker stages, preintegration, the solve and
marginalization run on ``device``, the card unless the caller asks for the
CPU. The host reads what it needs from the device only through
``engine/host.py:fetch``: one read of the solved parameters, iteration counts
and GNSS stds per optimization episode.
"""

import math

import numpy as np
import torch

from ..core import earth_np, rotation_np
from ..engine.config import GvinsConfig
from ..engine.output import OutputFiles
from ..engine.replay import ImuStream
from ..solver.problem import WindowConfig
from ..utils import timecost
from ..vision import camera as vcam
from ..vision.map import (
    FARTHEST_DEPTH,
    KEYFRAME_NORMAL,
    KEYFRAME_REMOVE_SECOND_NEW,
    NEAREST_DEPTH,
    VFrame,
    VisualMap,
)
from ..vision.tracking import TRACK_FIRST_FRAME, TRACK_LOST, Tracker
from .gins import GinsModel

R2D = 180.0 / math.pi
MINMUM_SYNC_INTERVAL = 0.025          # ic_gvins.h:132
MAXIMUM_PREINTEGRATION_LENGTH = 10.0  # ic_gvins.h:136
MINIMUM_TIME_INTERVAL = 1.0e-4


class GvinsModel(GinsModel):
    """Full GNSS-visual-inertial estimator (extends the GINS backbone)."""

    def __init__(self, cfg: GvinsConfig, outdir=None, device="cuda"):
        super().__init__(cfg, outdir=outdir, window_nodes=None, device=device)
        # the visual pipeline's window: the configured slot capacities
        self.wcfg = WindowConfig(N=cfg.node_slots, L=cfg.landmark_slots, G=cfg.gnss_slots,
                                 R=cfg.reproj_slots, with_earth=cfg.iswithearth, with_odo=cfg.isuseodo)

        assert cfg.cam0 is not None, "GVINS needs cam0 configuration"
        self.camera = vcam.PinholeCamera.from_config(cfg.cam0.intrinsic, cfg.cam0.distortion,
                                                     cfg.cam0.resolution)
        self.vmap = VisualMap(cfg.optimize_windows_size)
        self.tracker = Tracker(self.camera, self.vmap, cfg, device=self.device)

        q = np.asarray(cfg.cam0.q_b_c, np.float64)
        self.pose_b_c_R = rotation_np.to_matrix(q / np.linalg.norm(q))
        self.pose_b_c_t = np.asarray(cfg.cam0.t_b_c, np.float64)
        self.td_b_c = float(cfg.cam0.td_b_c)
        self.reproj_sqrt_info = float(self.camera.focal_length) / cfg.reprojection_error_std

        self.pending_gnss = []
        self.keyframe_queue = []
        self.unused_time_nodes = []
        self.initlength_count = 0
        self.iterations = [0, 0]
        self.timecosts = [0.0, 0.0, 0.0]
        self.tier_counts = {"small": 0, "full": 0}       # solver-tier usage
        self.tier_counts_marg = {"small": 0, "full": 0}  # marg-tier usage
        self.outlier_counts = [0, 0]
        self._lm_slots = {}

        # offline Drawer/DrawerRviz equivalent (drawer.cc:25-69,
        # drawer_rviz.cc:100-195): tracking overlays + path/cloud figure
        self.drawer = None
        if cfg.is_use_visualization and outdir is not None:
            from ..vision.drawer import OfflineDrawer

            self.drawer = OfflineDrawer(outdir)

    # ------------------------------------------------------------------
    # replay loop
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def run(self, imu_data, gnss_data, frame_times, image_provider):
        """Replay all streams. frame_times: (F,) stamps; image_provider(k)
        returns the (H, W) grayscale image of frame k (numpy or a tensor).
        Returns the (nodes, 8) trajectory [t, p, q] at node times."""
        stream = ImuStream(imu_data)
        ftime = np.asarray(frame_times, np.float64)
        events = [("gnss", g["time"], g) for g in self._gnss_fixes(gnss_data)]
        events += [("frame", ftime[k], k) for k in range(len(ftime))]
        events.sort(key=lambda e: (e[1], e[0] == "frame"))
        if self.outdir:
            self.out = OutputFiles(self.outdir)

        try:
            last_gnss = None
            for kind, t, item in events:
                if kind == "gnss":
                    if self.state == "INITIALIZING":
                        if last_gnss is not None:
                            self._try_initialize(stream, last_gnss, item)
                        last_gnss = item
                    elif self.state == "INITIALIZING_INS":
                        self._process_gnss_ins(stream, item)
                    else:
                        self.pending_gnss.append(item)
                        self._drain_pending_gnss(stream)
                elif self.state not in ("INITIALIZING", "INITIALIZING_INS") \
                        and t + self.td_b_c < stream.time[-1] - 0.02:
                    image = image_provider(item)
                    with timecost.span("frame", frame=item):
                        self._process_frame(stream, t, image)

            if self.prop is not None:
                self.prop.propagate_to(float(stream.time[-1]), sample_cb=self._write_samples if self.out else None)
            if self.drawer is not None:
                self.drawer.finalize(self.trajectory)
        finally:
            if self.out:
                self.out.close()
        return np.asarray(self.trajectory) if self.trajectory else np.zeros((0, 8))

    def _process_gnss_ins(self, stream, gnss):
        """INITIALIZING_INS: GNSS/INS integration (ic_gvins.cc:313-330,
        411-425); switch to the visual stage after initlength preints."""
        self.prop.propagate_to(gnss["time"], sample_cb=self._write_samples if self.out else None)
        self._add_gnss_node(stream, gnss)
        # GNSS/INS phase: no landmark/reprojection rows, the small tier fits
        self.est.optimize(num_iterations=50, wc=self.est.wcfg_small)
        self.est.reintegrate_if_needed()
        if self.est.n_nodes >= self.wcfg.N - 1:
            self.est.marginalize(1, wc=self.est.wcfg_small)
        self.initlength_count = self.est.n_nodes - 1
        st = self.est.latest_state()
        self.prop.set_state(st)
        self.trajectory.append([st.time, *st.p, *st.q])
        if self.initlength_count >= self.cfg.initlength:
            self.state = "INITIALIZING_VIO"

    # ------------------------------------------------------------------
    # frame path
    # ------------------------------------------------------------------

    def _process_frame(self, stream, stamp, image):
        td = self.td_b_c
        t_frame = stamp + td
        if t_frame <= self.est.times[self.est.n_nodes - 1]:
            return

        frame = VFrame(t_frame)
        frame.td = td

        # mechanize + per-sample nav output up to the frame (the reference's
        # fusion thread writes nav results at IMU rate, misc.cc:417-499)
        self.prop.propagate_to(t_frame, sample_cb=self._write_samples if self.out else None)

        # INS prior pose -> camera pose (runTracking, ic_gvins.cc:525-533)
        p, q = self.prop.pose_interpolated(t_frame)
        Rwb = rotation_np.to_matrix(q)
        frame.R = Rwb @ self.pose_b_c_R
        frame.t = p + Rwb @ self.pose_b_c_t

        state = self.tracker.track(frame, image)

        if self.drawer is not None and frame.features:
            # drawTrackingImage: flow line prev->cur + type-colored marker
            fp = self.tracker.frame_pre
            prev, cur, types = [], [], []
            for lm_id, obs in frame.features.items():
                lm = self.vmap.landmarks.get(lm_id)
                p_obs = fp.features.get(lm_id) if fp is not None else None
                prev.append((p_obs.dis if p_obs is not None else obs.dis))
                cur.append(obs.dis)
                types.append(lm.lmtype if lm is not None else 0)
            self.drawer.update_frame(image, prev, cur, types)

        if self.tracker.is_new_keyframe or state in (TRACK_FIRST_FRAME, TRACK_LOST):
            self.keyframe_queue.append(frame)
        else:
            return

        if self.state == "INITIALIZING_VIO":
            self._add_keyframe_nodes(stream)
            self.state = "TRACKING_INITIALIZING"
            self._drain_pending_gnss(stream)
            return

        # TRACKING_INITIALIZING / TRACKING_NORMAL
        self._add_keyframe_nodes(stream)
        self._drain_pending_gnss(stream)

        if self.vmap.is_maximum_keyframes():
            self.state = "TRACKING_NORMAL"

        self._optimize_visual()
        self._remove_second_new_frames()
        while self.vmap.is_maximum_keyframes():
            self._marginalize_visual()
        with timecost.span("stats.write"):
            self._write_statistics()

        # feedback to INS (isoptimized_ path)
        st = self.est.latest_state()
        if self.cfg.iswithearth:
            self.prop.update_iewn(earth_np.iewn(self.origin, st.p))
        self.prop.set_state(st)
        self.trajectory.append([st.time, *st.p, *st.q])
        if self.tracker.logging_row is not None and self.out:
            with timecost.span("stats.write"):
                row = self.tracker.logging_row + [len(self.tracker.frame_cur.features), self.tracker.track_ms]
                self.out.write_tracking(row)

    @timecost.traced("nodes.add")
    def _add_keyframe_nodes(self, stream):
        """addNewKeyFrameTimeNode (ic_gvins.cc:724-752)."""
        while self.keyframe_queue:
            frame = self.keyframe_queue.pop(0)
            if frame.stamp <= self.est.times[self.est.n_nodes - 1] + MINIMUM_TIME_INTERVAL:
                continue
            if frame.kf_id is None:
                frame.set_keyframe(KEYFRAME_NORMAL)
            self.vmap.insert_keyframe(frame)
            self._ensure_node_capacity()
            # vision blackouts can leave keyframe gaps longer than the fixed
            # preintegration segment capacity: chain intermediate nodes
            self._chain_time_nodes(stream, frame.stamp, shed_capacity=self._ensure_node_capacity)
            series = stream.series(self.est.times[self.est.n_nodes - 1], frame.stamp)
            self.est.add_time_node(frame.stamp, series)
        self._merge_unused_nodes()

    def _ensure_node_capacity(self):
        """Graceful degradation when node slots run out (the reference's
        deques are unbounded; the fixed window sheds the oldest nodes, an
        early marginalization)."""
        while self.est.n_nodes >= self.wcfg.N - 1:
            oldest_time = self.est.times[0]
            oldest_kf = None
            for kf_id in self.vmap.ordered_keyframes():
                f = self.vmap.keyframes[kf_id]
                if abs(f.stamp - oldest_time) < MINIMUM_TIME_INTERVAL:
                    oldest_kf = f
                    break
            tables, params, wcm = self._fresh_tables_and_params()
            self.est.marginalize(1, oldest_kf_node=0, tables=tables, params=params, wc=wcm)
            if oldest_kf is not None:
                self.vmap.remove_keyframe(oldest_kf, remove_mappoints=True)

    def _mergeable(self, k):
        """Whether intervals k-1 and k exist and fit one segment once merged
        (the reference gates on the combined span, ic_gvins.cc:760; with
        fixed-shape segments the binding limit is the sample capacity)."""
        na, nb = self.est.segment_samples(k - 1), self.est.segment_samples(k)
        return na is not None and nb is not None and na + nb - 1 <= self.cfg.preint_samples

    def _merge_unused_nodes(self):
        """removeUnusedTimeNode (ic_gvins.cc:754-789)."""
        for t in self.unused_time_nodes:
            k = self.est._node_index_of_time(t)
            # interior nodes only; times already marginalized away resolve
            # to -1/0 and are skipped
            if 1 <= k < self.est.n_nodes - 1 and self._mergeable(k):
                self.est.merge_node(k)
        self.unused_time_nodes = []

    # ------------------------------------------------------------------
    # GNSS node insertion (ic_gvins.cc:791-888)
    # ------------------------------------------------------------------

    @timecost.traced("gnss.drain")
    def _drain_pending_gnss(self, stream):
        self.pending_gnss = [g for g in self.pending_gnss if not self._insert_gnss_node(stream, g)]

    def _insert_gnss_node(self, stream, gnss):
        """Returns False to keep the fix pending (it lies past the newest
        node), True once it is used or dropped."""
        est = self.est
        n = est.n_nodes
        if gnss["time"] > est.times[n - 1]:
            return False  # wait for a later keyframe node

        # find bracketing interval
        index = -1
        for k in range(n - 1, 1, -1):
            if est.times[k - 1] < gnss["time"] <= est.times[k]:
                index = k
                break
        if index < 0:
            return True  # too old; drop

        sta, end = est.times[index - 1], est.times[index]

        # the bracketing end node must be a NORMAL keyframe
        is_need = False
        for kf_id in self.vmap.ordered_keyframes():
            f = self.vmap.keyframes[kf_id]
            if abs(f.stamp - end) < MINIMUM_TIME_INTERVAL and f.keyframe_state != KEYFRAME_REMOVE_SECOND_NEW:
                is_need = True
        if not is_need:
            return True  # unused GNSS (non-normal keyframe)

        if gnss["time"] - sta < MINMUM_SYNC_INTERVAL:
            dt = gnss["time"] - sta
            est.add_gnss(sta, gnss["blh"] - est.mixes[index - 1, :3] * dt, gnss["std"] * 1.2)
        elif end - gnss["time"] < MINMUM_SYNC_INTERVAL:
            dt = end - gnss["time"]
            est.add_gnss(end, gnss["blh"] + est.mixes[index, :3] * dt, gnss["std"] * 1.2)
        else:
            # insert a node mid-interval: rebuild the tail
            if float(est.preint_table.summ.dt[index - 1]) > MAXIMUM_PREINTEGRATION_LENGTH:
                return True
            dropped = est.truncate_to(index)
            est.add_time_node(gnss["time"], stream.series(est.times[index - 1], gnss["time"]))
            est.add_gnss(gnss["time"], gnss["blh"], gnss["std"])
            for t in dropped:
                est.add_time_node(t, stream.series(est.times[est.n_nodes - 1], t))
            # every re-added tail node moved one slot up: the prior's node
            # columns must follow (marg.insert_node_slot_into_prior)
            est.insert_prior_slot(index)
        return True

    # ------------------------------------------------------------------
    # optimization episode (gvinsOptimization, ic_gvins.cc:1130-1239)
    # ------------------------------------------------------------------

    def _assign_landmark_slots(self, count_optimized=True):
        """addReprojectionParameters (ic_gvins.cc:1697-1761): a compact slot
        per live landmark whose reference keyframe is in the map."""
        slots = {}
        invdepths = np.full(self.wcfg.L, 0.1)
        lm_valid = np.zeros(self.wcfg.L)
        slot = 0
        for lm_id in sorted(self.vmap.landmarks.keys()):
            lm = self.vmap.landmarks[lm_id]
            if lm.outlier or slot >= self.wcfg.L:
                continue
            if not self.vmap.is_keyframe_in_map(lm.ref_frame):
                continue
            inv = 1.0 / lm.depth if lm.depth > 0 else np.nan
            if not np.isfinite(inv):
                lm.outlier = True
                continue
            slots[lm_id] = slot
            invdepths[slot] = inv
            lm_valid[slot] = 1.0
            if count_optimized:
                lm.optimized_times += 1
            slot += 1
        self._lm_slots = slots
        return slots, invdepths, lm_valid

    def _tier(self, slots, nrows, reproj, invdepths, lm_valid):
        """The fill-selected tier: slot assignment is compact (0..n-1), so
        when the landmarks and rows fit the half-size tier the tables simply
        truncate to it (the solve and the reprojection assembly are linear
        in R and L). Returns (wc, reproj, invdepths, lm_valid)."""
        wc_small = self.est.wcfg_small
        if len(slots) <= wc_small.L and nrows <= wc_small.R:
            return wc_small, reproj[:wc_small.R], invdepths[:wc_small.L], lm_valid[:wc_small.L]
        return self.est.wcfg, reproj, invdepths, lm_valid

    @timecost.traced("marg.tables")
    def _fresh_tables_and_params(self):
        """Rebuild factor tables + params from the CURRENT window structure.
        Node indices shift whenever second-new nodes merge or the window
        slides, so marginalization never reuses the tables of the last
        optimization episode (the reference rebuilds all marginalization
        factors from the live lists, ic_gvins.cc:1482-1610). Returns
        (tables, params, wc) at the fill-selected tier."""
        slots, invdepths, lm_valid = self._assign_landmark_slots(count_optimized=False)
        reproj, nrows = self._build_reproj_table(slots)
        wc, reproj, invdepths, lm_valid = self._tier(slots, nrows, reproj, invdepths, lm_valid)
        self.tier_counts_marg["small" if wc is self.est.wcfg_small else "full"] += 1
        tables = self.est.build_tables(ext_active=False, td_active=False, reproj_table=reproj,
                                       reproj_sqrt_info=self.reproj_sqrt_info, lm_valid=lm_valid, wc=wc)
        return tables, self.est.build_params(invdepths=invdepths, wc=wc), wc

    def _build_reproj_table(self, slots):
        """addReprojectionFactors (ic_gvins.cc:1763-1837): one packed
        (R, 18) numpy table, columns [ref_idx, obs_idx, lm_idx, pts0(3),
        pts1(3), vel0(3), vel1(3), td0, td1, valid], the layout
        ``estimator.build_tables`` unpacks on the device. Frame-major: one
        pass over the assigned landmarks for their reference observation,
        then one over the window keyframes, whose feature dicts are matched
        against the landmark set with searchsorted. Returns (table, rows)."""
        est = self.est
        R = self.wcfg.R
        times = est.times[:est.n_nodes]

        # ---- landmark-side reference info (one entry per assigned slot) ----
        lm_ids, l_slots, l_stamps, l_p0, l_v0, l_td0 = [], [], [], [], [], []
        for lm_id, slot in slots.items():
            lm = self.vmap.landmarks[lm_id]
            ref = lm.ref_frame
            ref_obs = ref.features.get(lm_id)
            if ref_obs is None:
                continue
            lm_ids.append(lm_id)
            l_slots.append(slot)
            l_stamps.append(ref.stamp)
            l_p0.append(ref_obs.undis)
            l_v0.append(ref_obs.velocity)
            l_td0.append(ref.td)

        parts = []
        if lm_ids:
            lm_ids_a = np.asarray(lm_ids, np.int64)
            l_slots_a = np.asarray(l_slots, np.int32)
            l_p0_a = np.asarray(l_p0)
            l_v0_a = np.asarray(l_v0)
            l_td0_a = np.asarray(l_td0)
            d = np.abs(times[None, :] - np.asarray(l_stamps)[:, None])
            l_refnode = d.argmin(axis=1).astype(np.int32)
            l_refok = d[np.arange(len(lm_ids)), l_refnode] < MINIMUM_TIME_INTERVAL
            order = np.argsort(lm_ids_a, kind="stable")
            sorted_ids = lm_ids_a[order]

            # ---- frame-major walk over the window keyframes ----
            for kf_id in sorted(self.vmap.keyframes.keys()):
                f = self.vmap.keyframes[kf_id]
                nf = len(f.features)
                if not f.is_keyframe or nf == 0:
                    continue
                dn = np.abs(times - f.stamp)
                node = int(dn.argmin())
                if dn[node] >= MINIMUM_TIME_INTERVAL:
                    continue
                ids = np.fromiter(f.features.keys(), np.int64, nf)
                pos = np.searchsorted(sorted_ids, ids)
                ok = pos < len(sorted_ids)
                loc = order[np.minimum(pos, len(order) - 1)]
                # matched, live, and not the landmark's own reference node
                # (f is ref implies the same stamp hence the same node)
                ok &= (lm_ids_a[loc] == ids) & l_refok[loc]
                ok &= np.fromiter((not o.outlier for o in f.features.values()), bool, nf)
                ok &= l_refnode[loc] != node
                if not ok.any():
                    continue
                sel = np.nonzero(ok)[0]
                und = np.asarray([o.undis for o in f.features.values()])
                vel = np.asarray([o.velocity for o in f.features.values()])
                parts.append((loc[sel], node, und[sel], vel[sel], float(f.td)))

        nrows = min(sum(len(p[0]) for p in parts), R)
        packed = np.zeros((R, 18))
        packed[:, 1] = 1.0   # obs_idx padding
        packed[:, 5] = 1.0   # pts0 z
        packed[:, 8] = 1.0   # pts1 z
        if nrows:
            loc_all = np.concatenate([p[0] for p in parts])[:nrows]
            obs_all = np.concatenate([np.full(len(p[0]), p[1]) for p in parts])[:nrows]
            und_all = np.concatenate([p[2] for p in parts])[:nrows]
            vel_all = np.concatenate([p[3] for p in parts])[:nrows]
            td1_all = np.concatenate([np.full(len(p[0]), p[4]) for p in parts])[:nrows]
            packed[:nrows, 0] = l_refnode[loc_all]
            packed[:nrows, 1] = obs_all
            packed[:nrows, 2] = l_slots_a[loc_all]
            packed[:nrows, 3:6] = vcam.pixel2cam(self.camera, l_p0_a[loc_all])
            packed[:nrows, 6:9] = vcam.pixel2cam(self.camera, und_all)
            packed[:nrows, 9:11] = l_v0_a[loc_all]
            packed[:nrows, 12:14] = vel_all
            packed[:nrows, 15] = l_td0_a[loc_all]
            packed[:nrows, 16] = td1_all
            packed[:nrows, 17] = 1.0
        return packed, nrows

    @timecost.traced("ep.optimize")
    def _optimize_visual(self):
        est = self.est
        # sync extrinsic into the estimator parameters
        est.ext = np.concatenate([self.pose_b_c_t, rotation_np.from_matrix(self.pose_b_c_R)])
        est.td = self.td_b_c

        with timecost.span("ep.tables"):
            slots, invdepths, lm_valid = self._assign_landmark_slots()
            reproj, nrows = self._build_reproj_table(slots)
            wc, reproj, invdepths, lm_valid = self._tier(slots, nrows, reproj, invdepths, lm_valid)
            self.tier_counts["small" if wc is est.wcfg_small else "full"] += 1

            estimating = self.state == "TRACKING_NORMAL"
            tables = est.build_tables(ext_active=self.cfg.optimize_estimate_extrinsic and estimating,
                                      td_active=self.cfg.optimize_estimate_td and estimating,
                                      reproj_table=reproj, reproj_sqrt_info=self.reproj_sqrt_info,
                                      lm_valid=lm_valid, wc=wc)
            params = est.build_params(invdepths=invdepths, wc=wc)
        # the solved poses, mixes, ext, td, invdepths and each pass's
        # iterations come back to the host mirrors in one read
        est.optimize(num_iterations=self.cfg.optimize_num_iterations, two_pass=True, tables=tables,
                     params=params, wc=wc)
        self.iterations = list(est.last_iterations)
        # measured per-pass wall times (ic_gvins.cc:1019-1022 logs the same
        # two columns)
        self.timecosts[0] = est.last_solve_times[0] * 1000.0
        self.timecosts[1] = est.last_solve_times[1] * 1000.0

        with timecost.span("ep.update"):
            if not self.vmap.is_maximum_keyframes():
                est.reintegrate_if_needed()
            self._update_from_optimizer(slots)
        with timecost.span("ep.cull"):
            self._visual_outlier_culling(slots)

    def _update_from_optimizer(self, slots):
        """updateParametersFromOptimizer (ic_gvins.cc:1299-1389), from the
        host mirrors the episode's read filled (``est.td``, ``est.ext``,
        ``est.invdepths``)."""
        est = self.est
        if self.cfg.optimize_estimate_td and self.state == "TRACKING_NORMAL":
            td_new = float(est.td)
            # sanity gate analogous to the extrinsic gates below (the
            # reference adopts td unconditionally, ic_gvins.cc:1308): td is
            # only weakly observable through pixel velocities, and one
            # faulted episode (GNSS outage + track loss) can step it past
            # the frame interval, after which the td-shifted frame
            # timestamps corrupt every later node insertion
            if abs(td_new - self.td_b_c) <= 0.02 and abs(td_new) <= 0.08:
                self.td_b_c = td_new

        if self.cfg.optimize_estimate_extrinsic and self.state == "TRACKING_NORMAL":
            ext = np.asarray(est.ext, np.float64)
            t_new = ext[:3]
            R_new = rotation_np.to_matrix(ext[3:7] / np.linalg.norm(ext[3:7]))
            dt = np.linalg.norm(t_new - self.pose_b_c_t)
            dq = rotation_np.from_matrix(R_new @ self.pose_b_c_R.T)
            dr = np.linalg.norm(dq[:3]) * 2.0 * R2D
            if dt <= 1.0 and dr <= 5.0:
                self.pose_b_c_R, self.pose_b_c_t = R_new, t_new
            if self.out:
                euler = rotation_np.matrix_to_euler(R_new) * R2D
                self.out.write_extrinsic(est.times[est.n_nodes - 1], t_new, euler, self.td_b_c)

        # keyframe poses from node states
        for kf in self.vmap.keyframes.values():
            k = est._node_index_of_time(kf.stamp)
            if k < 0:
                continue
            p, q = est.poses[k, :3], est.poses[k, 3:7]
            Rwb = rotation_np.to_matrix(q)
            kf.R = Rwb @ self.pose_b_c_R
            kf.t = p + Rwb @ self.pose_b_c_t

        # landmark depths (ic_gvins.cc:1362-1388)
        inv = est.invdepths
        for lm_id, slot in slots.items():
            lm = self.vmap.landmarks.get(lm_id)
            if lm is None or lm.outlier:
                continue
            if not self.vmap.is_keyframe_in_map(lm.ref_frame):
                continue
            invdepth = inv[slot]
            if not np.isfinite(invdepth) or invdepth == 0:
                continue
            depth = 1.0 / invdepth
            pc = vcam.pixel2cam(self.camera, np.asarray(lm.ref_undis)) * depth
            lm.pos = lm.ref_frame.R @ pc + lm.ref_frame.t
            lm.update_depth(depth)

    def _visual_outlier_culling(self, slots):
        """gvinsOutlierCulling (ic_gvins.cc:1035-1128). The per-observation
        math (projection, depth gate, pixel error) runs as ONE vectorized
        numpy pass; the decision replay below keeps the reference's
        sequential semantics (a bad reference observation kills the landmark
        and skips the rest)."""
        n_lm_out, n_feat_out = 0, 0
        to_remove = []

        # pass 1: gather all candidate (landmark, observation) rows
        items = []  # (lm, [obs...])
        Rs, ts, pws, unds = [], [], [], []
        for lm_id in slots:
            lm = self.vmap.landmarks.get(lm_id)
            if lm is None or lm.outlier:
                continue
            obs_list = [obs for obs in lm.observations
                        if not obs.outlier and obs.frame.is_keyframe and self.vmap.is_keyframe_in_map(obs.frame)]
            items.append((lm, obs_list))
            for obs in obs_list:
                Rs.append(obs.frame.R)
                ts.append(obs.frame.t)
                pws.append(lm.pos)
                unds.append(obs.undis)
        if Rs:
            pc = np.einsum("nji,nj->ni", np.stack(Rs), np.stack(pws) - np.stack(ts))
            depth_ok = (pc[:, 2] > NEAREST_DEPTH) & (pc[:, 2] < FARTHEST_DEPTH)
            with np.errstate(divide="ignore", invalid="ignore"):
                errs = np.linalg.norm(vcam.cam2pixel(self.camera, pc) - np.stack(unds), axis=-1)
            good = depth_ok & np.isfinite(errs) & (errs <= self.cfg.reprojection_error_std * 3.0)
        row = 0
        for lm, obs_list in items:
            errors = []
            killed = False
            for obs in obs_list:
                err, ok = errs[row], good[row]
                row += 1
                if killed:
                    continue
                if not ok:
                    obs.outlier = True
                    lm.used_times -= 1
                    if obs.frame.id == lm.ref_frame.id:
                        lm.outlier = True
                        to_remove.append(lm)
                        n_lm_out += 1
                        killed = True
                        continue
                    n_feat_out += 1
                else:
                    errors.append(err)
            if killed:
                continue
            if len(errors) < 2 or np.mean(errors) > self.cfg.reprojection_error_std:
                lm.outlier = True
                to_remove.append(lm)
                n_lm_out += 1
        for lm in to_remove:
            self.vmap.remove_mappoint(lm)
        self.outlier_counts = [n_lm_out, n_feat_out]

    # ------------------------------------------------------------------
    # window maintenance
    # ------------------------------------------------------------------

    @timecost.traced("ep.remove")
    def _remove_second_new_frames(self):
        """gvinsRemoveAllSecondNewFrame (ic_gvins.cc:1391-1410)."""
        ordered = self.vmap.ordered_keyframes()
        for kf_id in ordered:
            f = self.vmap.keyframes.get(kf_id)
            if f is None:
                continue
            if f.keyframe_state == KEYFRAME_REMOVE_SECOND_NEW or (not f.features and kf_id != ordered[-1]):
                # the merge is DEFERRED to the next keyframe insertion: the
                # removed node may still be the newest (no successor interval
                # to merge into yet), the reference's unused_time_nodes_
                # consumption site (ic_gvins.cc:751)
                self.unused_time_nodes.append(f.stamp)
                f.reset_keyframe()
                self.vmap.remove_keyframe(f, remove_mappoints=False)

    def _marginalize_visual(self):
        """gvinsMarginalization (ic_gvins.cc:1412-1678). Wall time of its
        ``marg`` span (table rebuild + Schur complement) recorded in
        timecosts[2] (statistics.txt col 12)."""
        whole = timecost.Span("marg")
        try:
            with whole:
                self._marginalize_visual_impl()
        finally:
            self.timecosts[2] = whole.ms

    def _marginalize_visual_impl(self):
        ordered = self.vmap.ordered_keyframes()
        latest = self.vmap.keyframes[ordered[-1]]
        latest.keyframe_state = KEYFRAME_NORMAL

        second = self.vmap.keyframes[ordered[1]]
        num_marg = self.est._node_index_of_time(second.stamp)
        oldest = self.vmap.keyframes[ordered[0]]
        oldest_node = self.est._node_index_of_time(oldest.stamp)
        if num_marg <= 0:
            # degenerate: nothing before the second keyframe
            self.vmap.remove_keyframe(oldest, remove_mappoints=True)
            return

        # bound num_marg by CONSTRUCTION: a long keyframe gap with 1 Hz GNSS
        # nodes can put the second keyframe beyond marg_cap (the structured
        # Schur factors only the leading marg_cap node blocks). Pre-merge
        # surplus interior GNSS nodes below the cut: their measurements at
        # already-converged nodes carry negligible information against the
        # prior that absorbs their neighbours; the reference never hits this
        # because Ceres marginalizes any count (marginalization_info.h:232).
        while num_marg > self.est.wcfg.marg_cap:
            k = next((k for k in range(1, num_marg) if self._mergeable(k)), None)
            if k is None:
                break  # estimator.marginalize raises with a clear message
            self.est.merge_node(k)
            num_marg = self.est._node_index_of_time(second.stamp)
            oldest_node = self.est._node_index_of_time(oldest.stamp)

        # factor tables rebuilt at the CURRENT structure (node indices may
        # have shifted since the optimization episode's tables)
        tables, params, wcm = self._fresh_tables_and_params()
        self.est.marginalize(num_marg, oldest_kf_node=oldest_node, tables=tables, params=params, wc=wcm)

        # persist the marginalized landmarks (mappoint.txt) + drop keyframe
        for lm_id in list(oldest.features.keys()):
            lm = self.vmap.landmarks.get(lm_id)
            if lm is None or lm.outlier or lm.ref_frame is not oldest:
                continue
            if self.out:
                self.out.write_mappoint(lm.pos)
            if self.drawer is not None:
                # addNewFixedMappoint at marginalization (ic_gvins.cc:1665)
                self.drawer.add_fixed_mappoint(lm.pos)
        self.vmap.remove_keyframe(oldest, remove_mappoints=True)

    def _write_statistics(self):
        """parametersStatistic (ic_gvins.cc:930-1033): one vectorized pass
        over all (landmark, keyframe-observation) rows."""
        if self.out is None:
            return
        ordered = self.vmap.ordered_keyframes()
        if len(ordered) < 2:
            return
        cur = self.vmap.keyframes[ordered[-1]]
        pre = self.vmap.keyframes[ordered[-2]]

        Rs, ts, pws, unds, groups = [], [], [], [], []
        for gi, lm_id in enumerate(self._lm_slots):
            lm = self.vmap.landmarks.get(lm_id)
            if lm is None or lm.outlier:
                continue
            for obs in lm.observations:
                f = obs.frame
                if obs.outlier or not f.is_keyframe or not self.vmap.is_keyframe_in_map(f):
                    continue
                Rs.append(f.R)
                ts.append(f.t)
                pws.append(lm.pos)
                unds.append(obs.undis)
                groups.append(gi)
        if Rs:
            pc = np.einsum("nji,nj->ni", np.stack(Rs), np.stack(pws) - np.stack(ts))
            with np.errstate(divide="ignore", invalid="ignore"):
                proj = vcam.cam2pixel(self.camera, pc)
            e = np.linalg.norm(proj - np.stack(unds), axis=-1)
            _, inv = np.unique(np.asarray(groups), return_inverse=True)
            errors = np.bincount(inv, weights=e) / np.bincount(inv)
        else:
            errors = np.asarray([0.0])
        self.out.write_statistics([
            cur.stamp, cur.stamp - pre.stamp, float(cur.id - pre.id), float(len(cur.features)),
            errors.min(), errors.max(), errors.mean(), float(np.sqrt(np.mean(errors**2))),
            self.iterations[0], self.iterations[1], self.timecosts[0], self.timecosts[1], self.timecosts[2],
            self.outlier_counts[0], self.outlier_counts[1],
        ])
