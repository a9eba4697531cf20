"""The benchmark's world generator against its own increments, and its
determinism in the seed."""

import copy

import numpy as np

from gvins_bench import run
from gvins_bench import world as wd

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]]


def _spec(name="urban38.replay", world_s=30.0):
    spec = run.cell_spec(name)
    return spec["cfg"], dict(spec["traffic"], world_s=world_s)


def test_truth_is_the_mechanization_of_the_noise_free_increments():
    cfg, traffic = _spec()
    cfg = copy.deepcopy(cfg)
    cfg["imu"].update(arw_deg_per_sqrt_hr=0.0, vrw_m_per_s_per_sqrt_hr=0.0)
    w = wd.build(cfg, traffic, 7)
    imu = w["imu"]
    bg, ba = np.asarray(cfg["imu"]["gyro_bias_rps"]), np.asarray(cfg["imu"]["accel_bias_mps2"])
    for j0 in (1, 700, 2500):
        j1 = j0 + 40
        prev = (imu["dt"][j0 - 1], imu["dtheta"][j0 - 1], imu["dvel"][j0 - 1])
        p, q, v = wd.mechanize_steps(w["p"][j0 - 1], w["q"][j0 - 1], w["v"][j0 - 1], bg, ba, imu["dt"][j0:j1],
                                     imu["dtheta"][j0:j1], imu["dvel"][j0:j1], prev, w["g"], w["iewn"], True)
        assert np.abs(p - w["p"][j0:j1]).max() < 1e-9
        assert np.abs(v - w["v"][j0:j1]).max() < 1e-9
        assert np.abs(q - w["q"][j0:j1]).max() < 1e-12


def test_drive_speed_and_fixes():
    for name in CELLS:
        cfg, traffic = _spec(name)
        w = wd.build(cfg, traffic, 11)
        moving = w["time"] > cfg["drive"]["still_s"] + cfg["drive"]["accel_s"] + 1.0
        speed = np.linalg.norm(w["v"][moving], axis=1)
        assert abs(speed.mean() - cfg["drive"]["speed_mps"]) < 0.02 * cfg["drive"]["speed_mps"]
        # the fixes are the antenna through the lever arm, at the configured noise
        i = np.round(w["gnss"]["time"] * w["rate"]).astype(int) - 1
        antenna = w["p"][i] + wd.qrotate(w["q"][i], np.asarray(cfg["antlever"]))
        assert np.abs(w["gnss_local"] - antenna).max() < 6 * cfg["gnss"]["noise_m"]
        back = wd.blh2ecef(w["gnss"]["blh"]) - wd.blh2ecef(w["origin"])
        assert np.allclose(back @ wd.cne(w["origin"]), w["gnss_local"], atol=1e-6)
        assert len(w["frame_times"]) == int((w["time"][-1] - 0.2) * cfg["camera"]["rate_hz"])


def test_seed_changes_the_noise_not_the_sizes():
    cfg, traffic = _spec()
    a, b, c = wd.build(cfg, traffic, 2**31 + 3), wd.build(cfg, traffic, 2**31 + 3), wd.build(cfg, traffic, 5)
    assert np.array_equal(a["imu"]["dtheta"], b["imu"]["dtheta"]) and np.array_equal(a["points"], b["points"])
    assert not np.array_equal(a["imu"]["dtheta"], c["imu"]["dtheta"])
    assert a["points"].shape == c["points"].shape and len(a["frame_times"]) == len(c["frame_times"])
    assert np.array_equal(a["p"], c["p"])


def test_configurations_agree_with_their_gvins_yaml():
    """The world's JSON and the gvins.yaml the program reads state the same
    rates, camera and lever arm."""
    from ic_gvins_tpu_torch.engine.config import load_config

    for name in CELLS:
        spec = run.cell_spec(name)
        cfg, yaml = spec["cfg"], load_config(spec["yaml"])
        assert yaml.imudatarate == cfg["imu_rate_hz"] and yaml.iswithearth == cfg["with_earth"]
        assert list(yaml.antlever) == cfg["antlever"]
        assert yaml.cam0.intrinsic == cfg["camera"]["intrinsic"]
        assert yaml.cam0.distortion == cfg["camera"]["distortion"]
        assert yaml.cam0.resolution == cfg["camera"]["resolution"]
        assert list(yaml.cam0.q_b_c) == cfg["camera"]["q_b_c"] and list(yaml.cam0.t_b_c) == cfg["camera"]["t_b_c"]
        assert abs(yaml.imumodel.arw - cfg["imu"]["arw_deg_per_sqrt_hr"] * np.pi / 180 / 60) < 1e-15


def test_the_street_lies_beside_the_path():
    """Every facade point lies its offset to the side of the path, and the
    road's points lie on the road."""
    cfg, traffic = _spec(world_s=20.0)
    w = wd.build(cfg, traffic, 2**31 + 9)
    st = traffic["street"]
    pts = w["points"]
    d = np.min(np.linalg.norm(pts[:, None, :2] - w["p"][None, ::20, :2], axis=-1), axis=1)
    road = pts[:, 2] == st["road_depth_m"]
    assert road.any() and (~road).any()
    assert d[road].max() <= st["road_half_width_m"] + st["spacing_m"]
    walls = d[~road]
    assert walls.min() >= st["offset_m"][0] - st["spacing_m"] and walls.max() <= st["offset_m"][1] + st["spacing_m"]
