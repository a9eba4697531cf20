"""INS-aided visual tracking frontend.

Twin of ``ic_gvins_tpu/vision/tracking.py``. Behavioral parity with Tracking
(tracking/tracking.{h,cc}): CLAHE preprocess + optional histogram gate,
landmark tracking with pose-prior prediction, rotation-compensated
reference-frame tracking, forward/backward LK consistency, fundamental-RANSAC
culling, parallax-driven keyframe policy (min parallax 20 px weighted across
landmark/reference tracks; observation frames on >0.475 s gaps), two-view
DLT triangulation with depth/reprojection gating, blockwise masked
Shi-Tomasi replenishment.

Architecture: the per-frame image math runs as a handful of fixed-shape
torch stages on ``Tracker.device`` over padded feature tables, at the
shapes of the reference's jitted stages (CLAHE + pyramid, bidirectional LK
+ undistortion, RANSAC, triangulation, occupancy mask + detection + subpix
+ undistortion). The feature/landmark bookkeeping is the reference's host
numpy code, carried over. Host tables cross to the device as copies
(``torch.tensor``), never aliased and never ``non_blocking``; each stage's
results come back as numpy arrays of the dtypes the reference returns.

Constants (tracking.h:112-115): 200 px detection blocks, 3+1 pyramid levels,
10 px triangulation parallax, 0.08 s min observation interval.
"""

import math
import time

import numpy as np
import torch

from ..core import rotation_np
from . import camera as cam
from . import features as feat
from . import lk, pyramid, ransac
from .map import (
    KEYFRAME_NONE,
    KEYFRAME_NORMAL,
    KEYFRAME_REMOVE_OLDEST,
    KEYFRAME_REMOVE_SECOND_NEW,
    MAPPOINT_TRIANGULATED,
    FARTHEST_DEPTH,
    NEAREST_DEPTH,
    Landmark,
    Observation,
    VFrame,
    VisualMap,
)

TRACK_BLOCK_SIZE = 200.0
TRACK_MIN_PARALLAX = 10.0
TRACK_MIN_INTERVAL = 0.08

# track() return states (tracking.h:38-44)
TRACK_FIRST_FRAME = 0
TRACK_INITIALIZING = 1
TRACK_TRACKING = 2
TRACK_PASSED = 3
TRACK_LOST = 4

# --------------------------------------------------------------------------
# device stages (twins of the reference's module-level jits)
# --------------------------------------------------------------------------


def _pyr_body(img):
    """CLAHE + 4-level pyramid + the image mean (the histogram-gate
    centroid, tracking.cc:88-105, equals mean/256)."""
    img32 = img.to(torch.float32)
    return pyramid.build_pyramid(pyramid.clahe(img32), lk.PYRAMID_LEVELS), torch.mean(img32)


def _lk_stage(camera, pyr_prev, pyr_next, pts_prev, pts_pred, valid):
    """Bidirectional LK + f64 undistortion of the tracked endpoints."""
    nxt, ok = lk.track_bidirectional(pyr_prev, pyr_next, pts_prev, pts_pred, valid)
    und = cam.undistort_points(camera, nxt.to(torch.float64))
    return nxt, ok, und


def _detect_body(camera, img, mask, counts, block_rows, block_cols, per_block, min_distance):
    corners, _resp, valid = feat.detect_blockwise(
        img, mask, counts, block_rows=block_rows, block_cols=block_cols,
        per_block=per_block, min_distance=min_distance)
    corners = feat.corner_subpix(img, corners, valid)
    und = cam.undistort_points(camera, corners.to(torch.float64))
    return corners, valid, und


def _detect_stage(camera, img, pts, wts, counts, block_rows, block_cols, per_block,
                  min_distance):
    """Occupancy mask + blockwise Shi-Tomasi + subpixel refine +
    undistortion of the new corners."""
    mask = feat.occupancy_mask(pts, wts, img.shape, min_distance)
    return _detect_body(camera, img, mask, counts, block_rows, block_cols, per_block,
                        min_distance)


def _detect_nomask_stage(camera, img, counts, block_rows, block_cols, per_block,
                         min_distance):
    return _detect_body(camera, img, torch.ones_like(img), counts,
                        block_rows, block_cols, per_block, min_distance)


def _np(t, dtype=None):
    """Device tensor -> host numpy array (a copy)."""
    a = t.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype, copy=False)


class Tracker:
    def __init__(self, camera: cam.PinholeCamera, vmap: VisualMap, cfg, F_MAX=None,
                 device="cuda"):
        """cfg: GvinsConfig (track_* + reprojection_error_std fields);
        device: where the image stages run, the card unless the caller asks
        for "cpu". Nothing is allocated here; without CUDA the first device
        op of ``track`` raises."""
        self.cam = camera
        self.map = vmap
        self.device = torch.device(device)

        self.check_histogram = cfg.track_check_histogram
        self.min_parallax = cfg.track_min_parallax
        self.max_features = cfg.track_max_features
        # feature-slot table sized to the configured budget (power-of-two
        # padding): LK cost is linear in slots
        if F_MAX is None:
            F_MAX = 64
            while F_MAX < cfg.track_max_features * 1.25:
                F_MAX *= 2
        self.F_MAX = F_MAX
        self.max_interval = cfg.track_max_interval * 0.95
        self.reproj_std = cfg.reprojection_error_std

        self.block_cols = max(int(round(camera.width / TRACK_BLOCK_SIZE)), 1)
        self.block_rows = max(int(round(camera.height / TRACK_BLOCK_SIZE)), 1)
        blocks = self.block_cols * self.block_rows
        self.per_block = max(int(round(self.max_features / blocks)), 1)
        self.min_pixel_distance = int(round(TRACK_BLOCK_SIZE / math.sqrt(self.per_block * 1.5)))

        self.frame_cur = None
        self.frame_pre = None
        self.frame_ref = None
        self.last_keyframe = None
        self.pyr_cur = None
        self.pyr_pre = None

        self.initializing = True
        self.is_new_keyframe = False
        self.histogram = 0.0
        self.passed_cnt = 0

        # reference-track feature table (host): struct-of-arrays numpy, one
        # row per live feature. und_* mirror pts_* with cached undistorted
        # pixels; ref_ids mirrors ref_frames[k].id so per-feature "is newer
        # than the reference keyframe" checks are vectorized compares
        self.pts_ref = np.zeros((0, 2))   # distorted px in the ref frame
        self.pts_new = np.zeros((0, 2))   # distorted px at latest tracked frame
        self.und_ref = np.zeros((0, 2))   # undistorted px of pts_ref (cache)
        self.und_new = np.zeros((0, 2))   # undistorted px of pts_new (cache)
        self.und_cur = np.zeros((0, 2))   # undistorted px of pts_cur (cache)
        self.ref_frames = np.zeros(0, object)  # VFrame the feature was created in
        self.ref_ids = np.zeros(0, np.int64)   # ref_frames[k].id mirror
        self.vel_ref = np.zeros((0, 2))   # normalized-plane velocity at ref

        self.parallax_map = 0.0
        self.parallax_map_counts = 0
        self.parallax_ref = 0.0
        self.parallax_ref_counts = 0
        self.tracked_mappoints = []
        self.logging_row = None
        self.track_ms = 0.0
        self._detect_static = (self.block_rows, self.block_cols,
                               self.per_block, self.min_pixel_distance)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _dev(self, a, dtype):
        """Host array -> device tensor, always a copy: a host mirror is
        mutated in place later, so it is never aliased by a queued copy."""
        return torch.tensor(a, dtype=dtype, device=self.device)

    def _dis(self, pts):
        if len(pts) == 0:
            return np.zeros((0, 2))
        return cam.distort_points(self.cam, np.asarray(pts, np.float64))

    def _pixel2cam(self, pts):
        return cam.pixel2cam(self.cam, np.asarray(pts, np.float64))

    def _pad(self, pts, n=None):
        n = n or self.F_MAX
        out = np.zeros((n, 2))
        v = np.zeros(n)
        k = min(len(pts), n)
        if k:
            out[:k] = pts[:k]
            v[:k] = 1.0
        return out, v

    def _keypoint_parallax(self, und0, und1, R0, R1):
        """Rotation-compensated pixel parallax (tracking.cc:861-871).
        und0/und1: (...,2) undistorted pixels; R0 may be batched (n,3,3)."""
        pc0 = self._pixel2cam(np.atleast_2d(und0))
        pc1 = self._pixel2cam(np.atleast_2d(und1))
        if np.ndim(R0) == 3:
            pc01 = np.einsum("ij,njk,nk->ni", R1.T, R0, pc0)
        else:
            pc01 = pc0 @ (R1.T @ R0).T
        d = pc01[:, :2] / pc01[:, 2:3] - pc1[:, :2]
        return np.linalg.norm(d, axis=1) * float(self.cam.focal_length)

    def _lk_fused(self, sets):
        """ONE bidirectional LK over several feature sets packed into a
        single padded table (landmark tracks + reference tracks,
        tracking.cc:385-393, 528-536; the union is bounded by
        track_max_features).

        sets: [(pts_prev (n,2), pts_pred (n,2)), ...] with sum(n) <= F_MAX
        (overflow slots are shed as failed tracks).
        Returns [(next (n,2) f64, ok (n,) bool, und (n,2) f64), ...] where
        und is the undistorted next point."""
        n = self.F_MAX
        pp = np.zeros((n, 2), np.float32)
        pd = np.zeros((n, 2), np.float32)
        v = np.zeros(n, bool)
        offs = []
        off = 0
        for p, q in sets:
            k = min(len(p), n - off)
            offs.append((off, k))
            if k:
                pp[off : off + k] = p[:k]
                pd[off : off + k] = q[:k]
                v[off : off + k] = True
            off += k
        nxt, ok, und = _lk_stage(self.cam, self.pyr_pre, self.pyr_cur,
                                 self._dev(pp, torch.float32), self._dev(pd, torch.float32),
                                 self._dev(v, torch.bool))
        nxt = _np(nxt, np.float64)
        okn = _np(ok)
        undn = _np(und, np.float64)
        out = []
        for (off, k), (p, _q) in zip(offs, sets):
            m = len(p)
            nx = np.zeros((m, 2))
            good = np.zeros(m, bool)
            un = np.zeros((m, 2))
            nx[:k] = nxt[off : off + k]
            good[:k] = okn[off : off + k]
            un[:k] = undn[off : off + k]
            out.append((nx, good, un))
        return out

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------

    def track(self, frame: VFrame, image):
        """image: (H,W) grayscale (0..255), a numpy array or a tensor. Wall
        time of the whole call is recorded in ``track_ms`` (tracking.txt
        col 7, tracking.cc:309-315); every stage ends in a host read, so the
        device work of the frame is inside it."""
        t0 = time.perf_counter()
        try:
            return self._track_impl(frame, image)
        finally:
            self.track_ms = (time.perf_counter() - t0) * 1000.0

    def _track_impl(self, frame: VFrame, image):
        self.is_new_keyframe = False
        self.logging_row = None

        if isinstance(image, torch.Tensor):
            img = image.to(self.device)
        else:
            img = self._dev(np.ascontiguousarray(image), torch.float32)
        pyr_new, img_mean = _pyr_body(img)

        if self.check_histogram:
            # the reference's histogram centroid sum(h_k * k/256)/N equals
            # mean(image)/256 exactly (tracking.cc:88-105)
            hist = float(img_mean) / 256.0
            if self.histogram != 0.0:
                rate = abs((hist - self.histogram) / self.histogram)
                if rate > 0.1:
                    self.passed_cnt += 1
                    if self.passed_cnt > 1:
                        self.histogram = 0.0
                    return TRACK_PASSED
            self.histogram = hist

        self.frame_pre = self.frame_cur
        self.frame_cur = frame
        self.pyr_pre = self.pyr_cur
        self.pyr_cur = pyr_new
        frame.pyr = self.pyr_cur  # frames own their pyramid for re-detection

        if self.initializing:
            return self._track_initializing()
        return self._track_normal()

    def _track_initializing(self):
        if self.frame_ref is None:
            self._reset_tracking_state()
            self.frame_ref = self.frame_cur
            self.features_detection(self.frame_ref, ismask=False)
            return TRACK_FIRST_FRAME

        if len(self.pts_ref) == 0:
            # nothing detected on the previous reference: re-reference to
            # the LIVE frame (the reference always detects on the newest
            # image, tracking.cc:115-133). Detecting on the stale frame_ref
            # image could fail forever — e.g. a featureless loss frame —
            # and permanently wedge re-initialization.
            self._reset_tracking_state()
            self.frame_ref = self.frame_cur
            self.features_detection(self.frame_ref, ismask=False)
            return TRACK_FIRST_FRAME

        self.track_reference_frame()

        if self.parallax_ref < self.min_parallax:
            return TRACK_INITIALIZING

        self.triangulation()

        if self._do_reset_tracking():
            self._make_new_frame(KEYFRAME_NORMAL)
            return TRACK_FIRST_FRAME

        self.frame_ref.set_keyframe(KEYFRAME_NORMAL)
        self._make_new_frame(KEYFRAME_NORMAL)
        self.last_keyframe = self.frame_cur
        self.initializing = False
        return TRACK_TRACKING

    def _track_normal(self):
        # ONE fused LK batch for both stages (see _lk_fused)
        map_prep = self._prepare_mappoint_tracking()
        ref_prep = self._prepare_reference_tracking()
        sets = []
        if map_prep is not None:
            sets.append((map_prep[1], map_prep[3]))
        if ref_prep is not None:
            sets.append(ref_prep)
        results = self._lk_fused(sets) if sets else []
        i = 0
        if map_prep is not None:
            self._finish_mappoint_tracking(map_prep, *results[i])
            i += 1
        if ref_prep is not None:
            self._finish_reference_tracking(ref_prep[0], *results[i])
            i += 1

        kf_state = self.check_keyframe_state()

        if kf_state in (KEYFRAME_NORMAL, KEYFRAME_REMOVE_OLDEST):
            self.triangulation()
        else:
            self.features_detection(self.frame_cur, ismask=True)

        if self._do_reset_tracking():
            self._make_new_frame(KEYFRAME_NORMAL)
            return TRACK_LOST

        if kf_state != KEYFRAME_NONE:
            self._make_new_frame(kf_state)

        return TRACK_TRACKING

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    def track_mappoints(self):
        """tracking.cc:351-455 (standalone path; the normal frame loop runs
        the fused prepare/finish halves around one LK batch)."""
        prep = self._prepare_mappoint_tracking()
        if prep is None:
            return False
        [(nxt, ok, und)] = self._lk_fused([(prep[1], prep[3])])
        return self._finish_mappoint_tracking(prep, nxt, ok, und)

    def _prepare_mappoint_tracking(self):
        """tracking.cc:351-455, the half before the fused LK batch."""
        self.tracked_mappoints = []
        self.parallax_map = 0.0
        self.parallax_map_counts = 0

        prev_feats = [
            (lm_id, obs)
            for lm_id, obs in self.frame_pre.features.items()
            if lm_id in self.map.landmarks and not self.map.landmarks[lm_id].outlier
        ]
        if not prev_feats:
            return None

        lms = [self.map.landmarks[lm_id] for lm_id, _ in prev_feats]
        pts_prev_dis = np.stack([obs.dis for _, obs in prev_feats])
        pts_prev_und = np.stack([obs.undis for _, obs in prev_feats])

        # predict from landmark positions through the frame's INS prior pose
        pos_w = np.stack([lm.pos for lm in lms])
        pc = (pos_w - self.frame_cur.t) @ self.frame_cur.R
        pred_und = cam.cam2pixel(self.cam, pc)
        pred_dis = self._dis(pred_und)
        return lms, pts_prev_dis, pts_prev_und, pred_dis

    def _finish_mappoint_tracking(self, prep, nxt, ok, und):
        lms, pts_prev_dis, pts_prev_und, _pred = prep
        if not ok.any():
            return False

        matched_dis = nxt[ok]
        matched_und = und[ok]
        kept_lms = [lm for lm, o in zip(lms, ok) if o]
        kept_prev_und = pts_prev_und[ok]

        dt = self.frame_cur.stamp - self.frame_pre.stamp
        pc_cur = self._pixel2cam(matched_und)
        pc_prev = self._pixel2cam(kept_prev_und)
        vel = (pc_cur[:, :2] - pc_prev[:, :2]) / dt

        self.frame_cur.features = {}
        for lm, und, dis, v in zip(kept_lms, matched_und, matched_dis, vel):
            obs = Observation(self.frame_cur, lm.id, und, dis, v, 0)
            lm.add_observation(obs)
            self.frame_cur.features[lm.id] = obs
            self.tracked_mappoints.append(lm)
        # undistorted rows of frame_cur.features in dict order — lets
        # features_detection's per-block count skip the ~200-object dict
        # walk on non-keyframe frames (guarded by a length check there)
        self._cur_feat_und = matched_und

        self.parallax_map_counts = self._parallax_from_ref_mappoints()
        return True

    def _parallax_from_ref_mappoints(self):
        """tracking.cc:873-905: average parallax between each landmark's
        observation in frame_ref and its newest observation in frame_cur."""
        und0, und1 = [], []
        for lm_id, obs_ref in self.frame_ref.features.items():
            lm = self.map.landmarks.get(lm_id)
            if lm is None or lm.outlier or not lm.observations:
                continue
            newest = lm.observations[-1]
            if newest.frame is self.frame_cur and not newest.outlier:
                und0.append(obs_ref.undis)
                und1.append(newest.undis)
        if not und0:
            self.parallax_map = 0.0
            return 0
        par = self._keypoint_parallax(
            np.stack(und0), np.stack(und1), self.frame_ref.R, self.frame_cur.R
        )
        self.parallax_map = float(par.mean())
        return len(und0)

    def track_reference_frame(self):
        """tracking.cc:457-574 (standalone path; the normal frame loop runs
        the fused prepare/finish halves around one LK batch)."""
        prep = self._prepare_reference_tracking()
        if prep is None:
            return False
        [(nxt, ok, und)] = self._lk_fused([prep])
        return self._finish_reference_tracking(prep[0], nxt, ok, und)

    def _prepare_reference_tracking(self):
        self.parallax_ref = 0.0
        self.parallax_ref_counts = 0
        if len(self.pts_new) == 0:
            return None

        pts_new = self.pts_new
        # rotation-compensated prediction (cached undistortion)
        r_cur_pre = self.frame_cur.R.T @ self.frame_pre.R
        pc_pre = self._pixel2cam(self.und_new)
        pc_cur = pc_pre @ r_cur_pre.T
        xy = cam.distort_normalized(self.cam, pc_cur[:, :2] / pc_cur[:, 2:3])
        pred = cam.cam2pixel(self.cam, np.concatenate([xy, np.ones((len(xy), 1))], axis=1))
        return pts_new, pred

    def _finish_reference_tracking(self, pts_new, nxt, ok, und):
        self._reduce(ok)
        if len(self.pts_new) == 0:
            return False
        pts_cur = nxt[ok]

        und_new = self.und_new
        und_cur = und[ok]

        dt = self.frame_cur.stamp - self.frame_pre.stamp
        pc_new = self._pixel2cam(und_new)
        pc_c = self._pixel2cam(und_cur)
        vel_cur = (pc_c[:, :2] - pc_new[:, :2]) / dt
        newer = self.ref_ids > self.frame_ref.id
        if newer.any():
            self.vel_ref[newer] = vel_cur[newer]

        # parallax over features referenced to the tracking reference keyframe
        sel = self.ref_ids == self.frame_ref.id
        nsel = int(sel.sum())
        if nsel:
            par = self._keypoint_parallax(
                self.und_ref[sel], und_cur[sel], self.frame_ref.R, self.frame_cur.R
            )
            self.parallax_ref = float(par.mean())
            self.parallax_ref_counts = nsel

        # fundamental RANSAC (tracking.cc:547-555)
        if len(pts_cur) >= 15:
            p0, v0 = self._pad(und_new)
            p1, _ = self._pad(und_cur)
            inl, _ = ransac.fundamental_ransac(
                self._dev(p0, torch.float64), self._dev(p1, torch.float64),
                self._dev(v0, torch.float64), float(self.reproj_std))
            keep = _np(inl)[: len(pts_cur)]
            pts_cur = pts_cur[keep]
            und_cur = und_cur[keep]
            vel_cur = vel_cur[keep]
            self._reduce(keep)

        if len(pts_cur) == 0:
            return False

        self.vel_cur = vel_cur
        self.pts_cur = pts_cur
        self.und_cur = und_cur
        self.pts_new = pts_cur.copy()
        self.und_new = und_cur.copy()
        return True

    def check_keyframe_state(self):
        """tracking.cc:263-307."""
        state = KEYFRAME_NONE
        dt = self.frame_cur.stamp - self.last_keyframe.stamp
        if dt < TRACK_MIN_INTERVAL:
            return state

        cnt = self.parallax_map_counts + self.parallax_ref_counts
        parallax = (
            (self.parallax_map * self.parallax_map_counts + self.parallax_ref * self.parallax_ref_counts) / cnt
            if cnt
            else 0.0
        )
        if parallax > self.min_parallax:
            state = KEYFRAME_REMOVE_OLDEST if self.map.is_window_full else KEYFRAME_NORMAL
        elif dt > self.max_interval:
            state = KEYFRAME_REMOVE_SECOND_NEW

        if state != KEYFRAME_NONE:
            self.last_keyframe = self.frame_cur
            for lm in self.tracked_mappoints:
                lm.used_times += 1
            rel_t = float(np.linalg.norm(self.frame_cur.t - self.frame_ref.t))
            R = self.frame_cur.R.T @ self.frame_ref.R
            euler = rotation_np.matrix_to_euler(R)
            rel_r = abs(float(euler[1])) * 180.0 / math.pi
            self.logging_row = [self.frame_cur.stamp, dt, parallax, rel_t, rel_r]
        return state

    def triangulation(self):
        """tracking.cc:690-798."""
        pts_cur = getattr(self, "pts_cur", None)
        if pts_cur is None or len(pts_cur) == 0:
            return False
        if len(self.ref_frames) != len(self.pts_cur):
            # pts_cur is stale: reference tracking early-returned this frame
            # (e.g. every track lost in a blackout) after _reduce emptied
            # the per-feature lists — nothing coherent to triangulate.
            # pts_ref/pts_new/ref_frames/vel_ref remain mutually consistent.
            self.pts_cur = np.zeros((0, 2))
            return False

        n = len(self.pts_cur)
        und_ref = self.und_ref
        und_cur = self.und_cur

        # batched rotation-compensated parallax for ALL candidates
        ref_R = np.stack([f.R for f in self.ref_frames])
        par_all = self._keypoint_parallax(und_ref, und_cur, ref_R, self.frame_cur.R)

        # classify every feature in vectorized passes:
        #   newer than the reference keyframe -> re-reference to current
        #   reference keyframe dropped from the map -> cull
        #   below the triangulation parallax -> keep as-is
        #   else -> triangulation candidate
        newer = self.ref_ids > self.frame_ref.id
        dropped = np.zeros(n, bool)
        if self.map.is_window_normal():
            old_idx = np.nonzero(~newer)[0]
            if len(old_idx):
                uids, first = np.unique(self.ref_ids[old_idx], return_index=True)
                bad = []
                for u, fi in zip(uids, first):
                    f = self.ref_frames[old_idx[fi]]
                    if f.kf_id is not None and not self.map.is_keyframe_in_map(f):
                        bad.append(u)
                if bad:
                    dropped = np.isin(self.ref_ids, np.asarray(bad))
        low_par = par_all < TRACK_MIN_PARALLAX

        keep = newer | (~newer & ~dropped & low_par)
        if newer.any():
            # features added mid-stream: re-reference to the current frame
            self.ref_frames[newer] = self.frame_cur
            self.ref_ids[newer] = self.frame_cur.id
            self.pts_ref[newer] = self.pts_cur[newer]
            self.und_ref[newer] = und_cur[newer]
        tri_idx = list(np.nonzero(~newer & ~dropped & ~low_par)[0])

        created = 0
        if tri_idx:
            idx = np.asarray(tri_idx)
            R0 = np.stack([self.ref_frames[k].R for k in tri_idx])
            t0 = np.stack([self.ref_frames[k].t for k in tri_idx])
            pc0 = self._pixel2cam(und_ref[idx])
            pc1 = self._pixel2cam(und_cur[idx])
            # padded to the feature-slot table (the reference's fixed shape)
            m, F = len(idx), self.F_MAX
            R0p = np.tile(np.eye(3), (F, 1, 1)); R0p[:m] = R0
            t0p = np.zeros((F, 3)); t0p[:m] = t0
            pcp = np.zeros((F, 3)); pcp[:, 2] = 1.0
            pc0p = pcp.copy(); pc0p[:m] = pc0
            pc1p = pcp.copy(); pc1p[:m] = pc1
            f64 = torch.float64
            pw = _np(ransac.triangulate_batch(
                self._dev(R0p, f64), self._dev(t0p, f64), self._dev(self.frame_cur.R, f64),
                self._dev(self.frame_cur.t, f64), self._dev(pc0p, f64), self._dev(pc1p, f64)))[:m]
            # batched two-view depth/reprojection gating (tracking.cc:813-829)
            good = self._good_to_track_batch(und_ref[idx], R0, t0, pw, 1.0, 3.0)
            good &= self._good_to_track_batch(
                und_cur[idx], self.frame_cur.R, self.frame_cur.t, pw, 1.0, 3.0
            )
            for j, k in enumerate(tri_idx):
                fref = self.ref_frames[k]
                if not good[j]:
                    keep[k] = False
                    continue
                keep[k] = False
                created += 1
                pc = fref.R.T @ (pw[j] - fref.t)
                lm = Landmark(fref, pw[j], und_ref[k], pc[2], MAPPOINT_TRIANGULATED)

                obs_cur = Observation(self.frame_cur, lm.id, und_cur[k], self.pts_cur[k], self.vel_cur[k], 1)
                lm.add_observation(obs_cur)
                self.frame_cur.features[lm.id] = obs_cur
                lm.used_times += 1

                obs_ref = Observation(fref, lm.id, und_ref[k], self.pts_ref[k], self.vel_ref[k], 1)
                lm.add_observation(obs_ref)
                fref.features[lm.id] = obs_ref
                lm.used_times += 1

                self.frame_cur.unupdated_mappoints.append(lm)

        self._reduce(keep)
        self.pts_cur = self.pts_cur[keep]
        self.und_cur = und_cur[keep]
        self.pts_new = self.pts_cur.copy()
        self.und_new = self.und_cur.copy()
        return True

    def _good_to_track_batch(self, und_px, R, t, pw, scale, depth_scale):
        """tracking.cc:813-829 over (m,) points: depth gate + reprojection
        gate; R/t may be per-point (m,3,3)/(m,3) or shared (3,3)/(3,)."""
        if np.ndim(R) == 3:
            pc = np.einsum("nji,nj->ni", R, pw - t)
        else:
            pc = (pw - t) @ R
        depth_ok = (pc[:, 2] > NEAREST_DEPTH) & (pc[:, 2] < FARTHEST_DEPTH * depth_scale)
        with np.errstate(divide="ignore", invalid="ignore"):
            proj = cam.cam2pixel(self.cam, pc)
            err = np.linalg.norm(proj - und_px, axis=-1)
        return depth_ok & np.isfinite(err) & (err <= self.reproj_std * scale)

    def features_detection(self, frame, ismask=True):
        """tracking.cc:576-688."""
        num_features = len(frame.features) + len(self.pts_ref)
        if num_features > self.max_features - 5:
            return

        # per-block existing-feature counts (vectorized)
        bw = self.cam.width // self.block_cols
        bh = self.cam.height // self.block_rows
        counts = np.zeros(self.block_rows * self.block_cols, np.int32)
        cache = getattr(self, "_cur_feat_und", None)
        if (frame is self.frame_cur and cache is not None
                and len(cache) == len(frame.features)):
            # non-keyframe path: features are exactly the rows cached by
            # _finish_mappoint_tracking this frame (keyframes add
            # triangulations first -> length differs -> dict walk below)
            feat_arr = cache
        elif frame.features:
            feat_arr = np.asarray(
                [obs.undis for obs in frame.features.values()]).reshape(-1, 2)
        else:
            feat_arr = np.zeros((0, 2))
        existing = (
            np.concatenate([feat_arr, self.pts_new])
            if len(feat_arr) else self.pts_new
        )
        if len(existing):
            col = np.clip((existing[:, 0] // bw).astype(np.int64), 0, self.block_cols - 1)
            row = np.clip((existing[:, 1] // bh).astype(np.int64), 0, self.block_rows - 1)
            np.add.at(counts, row * self.block_cols + col, 1)

        if not ismask:
            # fresh start on this frame (tracking.cc:662-667)
            self._reset_tracking_state()

        img = getattr(frame, "pyr", self.pyr_cur)[0]
        counts_d = self._dev(counts, torch.int32)
        if ismask and len(existing):
            pts, wts = self._pad(existing)
            corners, valid, und_all = _detect_stage(
                self.cam, img, self._dev(pts, torch.float64), self._dev(wts, torch.float64),
                counts_d, *self._detect_static)
        else:
            corners, valid, und_all = _detect_nomask_stage(self.cam, img, counts_d,
                                                           *self._detect_static)
        vmask = _np(valid)
        cn = _np(corners)[vmask]
        und_v = _np(und_all, np.float64)[vmask]

        budget = self.max_features - num_features
        cn = np.asarray(cn[:budget], np.float64)
        und_cn = und_v[:budget]
        m = len(cn)
        if m:
            self.pts_ref = np.concatenate([self.pts_ref, cn])
            self.pts_new = np.concatenate([self.pts_new, cn.copy()])
            self.und_ref = np.concatenate([self.und_ref, und_cn])
            self.und_new = np.concatenate([self.und_new, und_cn.copy()])
            self.ref_frames = np.concatenate(
                [self.ref_frames, np.full(m, frame, object)])
            self.ref_ids = np.concatenate(
                [self.ref_ids, np.full(m, frame.id, np.int64)])
            self.vel_ref = np.concatenate([self.vel_ref, np.zeros((m, 2))])

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------

    def _reduce(self, keep):
        keep = np.asarray(keep, bool)
        self.pts_ref = self.pts_ref[keep]
        self.pts_new = self.pts_new[keep]
        self.und_ref = self.und_ref[keep]
        self.und_new = self.und_new[keep]
        self.ref_frames = self.ref_frames[keep]
        self.ref_ids = self.ref_ids[keep]
        self.vel_ref = self.vel_ref[keep]

    def _make_new_frame(self, state):
        self.frame_cur.set_keyframe(state)
        self.is_new_keyframe = True
        if state in (KEYFRAME_NORMAL, KEYFRAME_REMOVE_OLDEST):
            self.frame_ref = self.frame_cur
            self.features_detection(self.frame_ref, ismask=True)

    def _do_reset_tracking(self):
        if not self.frame_cur.features:
            self.initializing = True
            self.frame_ref = self.frame_cur
            self._reset_tracking_state()
            return True
        return False

    def _reset_tracking_state(self):
        self.pts_ref = np.zeros((0, 2))
        self.pts_new = np.zeros((0, 2))
        self.und_ref = np.zeros((0, 2))
        self.und_new = np.zeros((0, 2))
        self.und_cur = np.zeros((0, 2))
        self.ref_frames = np.zeros(0, object)
        self.ref_ids = np.zeros(0, np.int64)
        self.vel_ref = np.zeros((0, 2))
        self.pts_cur = np.zeros((0, 2))
        self.vel_cur = np.zeros((0, 2))
