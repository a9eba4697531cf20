"""Sliding-window visual map: frames, landmarks, observations.

Host-side graph bookkeeping replacing Frame/Feature/MapPoint/Map
(tracking/frame.h, feature.h, mappoint.{h,cc}, map.{h,cc}). The graph is
O(window * features) small — the numerics that touch it (projection,
triangulation, BA) run on device through the padded factor tables built by
the engine layer.

Conventions kept from the reference: monotonically increasing frame /
keyframe / landmark ids, keyframe states (NONE / NORMAL / REMOVE_SECOND_NEW /
REMOVE_OLDEST), landmark types, depth clamps (1..200 m, default 10), the
window-full flags driving keyframe policy and marginalization.

A carried-over copy of ``ic_gvins_tpu/vision/map.py`` (pure numpy): the
JAX package's copy cannot be imported where jax is absent.
"""

import numpy as np

# keyframe states (frame.h:36-41)
KEYFRAME_NONE = 0
KEYFRAME_REMOVE_SECOND_NEW = 1
KEYFRAME_NORMAL = 2
KEYFRAME_REMOVE_OLDEST = 3

# landmark types (mappoint.h:38-44)
MAPPOINT_TRIANGULATED = 0
MAPPOINT_DEPTH_ASSOCIATED = 1
MAPPOINT_DEPTH_INITIALIZED = 2
MAPPOINT_FIXED = 3

DEFAULT_DEPTH = 10.0
NEAREST_DEPTH = 1.0
FARTHEST_DEPTH = 200.0


class Observation:
    """One landmark observation in one frame (Feature, feature.h:41-120)."""

    __slots__ = ("frame", "lm_id", "undis", "dis", "velocity", "outlier", "ftype")

    def __init__(self, frame, lm_id, undis, dis, velocity, ftype):
        # contract: undis/dis/velocity are f64 numpy rows owned by the caller
        # and never mutated afterwards (the tracker builds them as fresh
        # per-frame arrays). The per-field np.asarray conversions cost ~0.4 ms
        # per frame at 100+ observations on the host path.
        self.frame = frame
        self.lm_id = lm_id
        self.undis = undis
        self.dis = dis
        self.velocity = velocity
        self.outlier = False
        self.ftype = ftype


class VFrame:
    """A camera frame (Frame, frame.h). Pose is camera-to-world (R, t)."""

    _next_id = 0
    _next_kf_id = 0

    def __init__(self, stamp):
        self.id = VFrame._next_id
        VFrame._next_id += 1
        self.kf_id = None
        self.stamp = float(stamp)
        self.td = 0.0
        self.R = np.eye(3)
        self.t = np.zeros(3)
        self.keyframe_state = KEYFRAME_NONE
        self.features = {}          # lm_id -> Observation
        self.unupdated_mappoints = []

    def set_keyframe(self, state):
        if self.kf_id is None:
            self.kf_id = VFrame._next_kf_id
            VFrame._next_kf_id += 1
        self.keyframe_state = state

    def reset_keyframe(self):
        self.keyframe_state = KEYFRAME_NONE

    @property
    def is_keyframe(self):
        return self.kf_id is not None and self.keyframe_state != KEYFRAME_NONE


class Landmark:
    """A 3D map point (MapPoint, mappoint.h)."""

    _next_id = 0

    def __init__(self, ref_frame, pos_w, ref_undis, depth, lmtype):
        self.id = Landmark._next_id
        Landmark._next_id += 1
        self.ref_frame = ref_frame
        self.pos = np.asarray(pos_w, np.float64)
        self.ref_undis = np.asarray(ref_undis, np.float64)
        self.depth = float(np.clip(depth, NEAREST_DEPTH, FARTHEST_DEPTH))
        self.lmtype = lmtype
        self.outlier = False
        self.used_times = 0
        self.optimized_times = 0
        self.observations = []  # list[Observation] in insertion order

    def update_depth(self, depth):
        if NEAREST_DEPTH < depth < FARTHEST_DEPTH:
            self.depth = depth
        else:
            self.depth = DEFAULT_DEPTH
            self.outlier = True

    def add_observation(self, obs):
        self.observations.append(obs)


class VisualMap:
    """Keyframe + landmark registries with window bookkeeping (map.{h,cc})."""

    def __init__(self, window_size):
        self.window_size = int(window_size)
        self.keyframes = {}      # kf_id -> VFrame
        self.landmarks = {}      # lm_id -> Landmark
        self.latest_keyframe = None
        self.is_window_full = False

    def insert_keyframe(self, frame: VFrame):
        self.latest_keyframe = frame
        self.keyframes[frame.kf_id] = frame
        for lm in frame.unupdated_mappoints:
            self.landmarks[lm.id] = lm
        frame.unupdated_mappoints = []
        if len(self.keyframes) > self.window_size:
            self.is_window_full = True

    def ordered_keyframes(self):
        return sorted(self.keyframes.keys())

    def oldest_keyframe(self):
        return self.keyframes[self.ordered_keyframes()[0]]

    def is_maximum_keyframes(self):
        return len(self.keyframes) > self.window_size

    def is_window_normal(self):
        return len(self.keyframes) == self.window_size

    def is_keyframe_in_map(self, frame):
        return frame is not None and frame.kf_id in self.keyframes

    def remove_mappoint(self, lm: Landmark):
        lm.outlier = True
        for obs in lm.observations:
            obs.outlier = True
            obs.frame.features.pop(lm.id, None)
        lm.observations = []
        self.landmarks.pop(lm.id, None)

    def remove_keyframe(self, frame: VFrame, remove_mappoints: bool):
        if remove_mappoints:
            for lm_id in list(frame.features.keys()):
                lm = self.landmarks.get(lm_id)
                if lm is None or lm.ref_frame is not frame:
                    continue
                self.remove_mappoint(lm)
            frame.features = {}
        self.keyframes.pop(frame.kf_id, None)
