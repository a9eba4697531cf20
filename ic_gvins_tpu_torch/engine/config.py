"""gvins.yaml configuration: accepted verbatim, reference unit conversions.

Parity: the reference parses the same file in three places (fusion_ros.cc:
67-97, ic_gvins.cc:51-144, tracking.cc:49-60) with unit conversions at parse
time (deg/sqrt(hr) -> rad/sqrt(s), deg/hr -> rad/s, mGal -> m/s^2, hr -> s).
This module is the single parse point; every consumer reads the dataclass.

A carried-over copy of ``ic_gvins_tpu/engine/config.py``: the GPU machine has
neither jax (which any ``ic_gvins_tpu`` import pulls in) nor pyyaml, so
``yaml`` is imported only inside ``load_config`` and ``parse_config(dict)``
works without it.
"""

import dataclasses
import math
from typing import List, Optional

D2R = math.pi / 180.0
NORMAL_GRAVITY = 9.80


@dataclasses.dataclass
class CameraConfig:
    intrinsic: List[float]          # fx, fy, cx, cy (, skew)
    distortion: List[float]         # k1, k2, p1, p2 (, k3)
    resolution: List[int]           # width, height
    q_b_c: List[float]              # x, y, z, w
    t_b_c: List[float]
    td_b_c: float = 0.0


@dataclasses.dataclass
class ImuModel:
    arw: float       # rad/sqrt(s)
    vrw: float       # m/s/sqrt(s)
    gbstd: float     # rad/s
    abstd: float     # m/s^2
    corrtime: float  # s


@dataclasses.dataclass
class OdometerConfig:
    """Wheel odometer (ODO/EARTH_ODO preintegration variants). SI units."""

    std: List[float] = dataclasses.field(default_factory=lambda: [0.1, 0.1, 0.1])
    srw: float = 1.0e-3                 # scale random walk [1/sqrt(s)] (from PPM/sqrt(Hz))
    abv: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    lodo: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclasses.dataclass
class GvinsConfig:
    outputpath: str = ""
    is_make_outputdir: bool = True
    initlength: int = 1
    imudatarate: float = 200.0
    iswithearth: bool = True
    antlever: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    imumodel: ImuModel = None
    isusegnssoutage: bool = False
    gnssoutagetime: float = 0.0
    gnssthreshold: float = 20.0
    is_use_visualization: bool = False
    track_check_histogram: bool = False
    track_min_parallax: float = 20.0
    track_max_interval: float = 0.5
    track_max_features: int = 200
    reprojection_error_std: float = 1.5
    optimize_windows_size: int = 10
    optimize_num_iterations: int = 20
    optimize_estimate_extrinsic: bool = True
    optimize_estimate_td: bool = True
    # wheel odometer (the reference hard-disables it, ic_gvins.cc:100-101;
    # this framework exposes the capability for odometer-equipped setups)
    isuseodo: bool = False
    odometer: Optional[OdometerConfig] = None
    cam0: Optional[CameraConfig] = None

    # framework-specific capacity knobs (absent from the reference yaml;
    # defaulted so reference configs run unchanged)
    node_slots: int = 24           # sliding-window time-node capacity
    landmark_slots: int = 512
    gnss_slots: int = 24
    reproj_slots: int = 2048
    preint_samples: int = 512      # max IMU samples per preintegration

    @property
    def imudatadt(self):
        return 1.0 / self.imudatarate


def load_config(path) -> GvinsConfig:
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return parse_config(raw)


def parse_config(raw: dict) -> GvinsConfig:
    cfg = GvinsConfig()
    simple = [
        "outputpath", "is_make_outputdir", "initlength", "imudatarate", "iswithearth",
        "antlever", "isusegnssoutage", "gnssoutagetime", "gnssthreshold",
        "is_use_visualization", "track_check_histogram", "track_min_parallax",
        "track_max_interval", "track_max_features", "reprojection_error_std",
        "optimize_windows_size", "optimize_num_iterations",
        "optimize_estimate_extrinsic", "optimize_estimate_td", "isuseodo",
        "node_slots", "landmark_slots", "gnss_slots", "reproj_slots", "preint_samples",
    ]
    for key in simple:
        if key in raw and raw[key] is not None:
            setattr(cfg, key, raw[key])

    # IMU noise: unit conversions as ic_gvins.cc:92-96
    m = raw.get("imumodel", {})
    cfg.imumodel = ImuModel(
        arw=m.get("arw", 0.1) * D2R / 60.0,
        vrw=m.get("vrw", 0.1) / 60.0,
        gbstd=m.get("gbstd", 50.0) * D2R / 3600.0,
        abstd=m.get("abstd", 50.0) * 1.0e-5,
        corrtime=m.get("corrtime", 1.0) * 3600.0,
    )

    if "odometer" in raw and raw["odometer"]:
        o = raw["odometer"]
        cfg.odometer = OdometerConfig(
            std=list(o.get("std", [0.1, 0.1, 0.1])),
            # yaml srw is PPM/sqrt(Hz) (integration_state.h:83)
            srw=float(o.get("srw", 1000.0)) * 1.0e-6,
            abv=[v * D2R for v in o.get("abv", [0.0, 0.0, 0.0])],  # deg -> rad
            lodo=list(o.get("lodo", [0.0, 0.0, 0.0])),
        )
    elif cfg.isuseodo:
        cfg.odometer = OdometerConfig()

    if "cam0" in raw and raw["cam0"]:
        c = raw["cam0"]
        cfg.cam0 = CameraConfig(
            intrinsic=list(c["intrinsic"]),
            distortion=list(c["distortion"]),
            resolution=list(c["resolution"]),
            q_b_c=list(c["q_b_c"]),
            t_b_c=list(c["t_b_c"]),
            td_b_c=float(c.get("td_b_c", 0.0)),
        )
    return cfg
