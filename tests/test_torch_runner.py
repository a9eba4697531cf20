"""The KAIST real-data recipe through the port, end to end on the CPU:
raw-layout fixture -> scripts/convert_kaist.py -> the port's loaders ->
scripts/run_gvins_torch.py --device cpu, both CLIs as subprocesses.

The port's twin of tests/test_kaist_recipe_e2e.py (slow there, and red for
ROADMAP R2: the reference loses the image names of the 'stamp relpath'
frame index). The fixture is that test's, written with the port's rotation
and renderer (chip_smoke.py's jax-free copies of tests/gins_data.py and
tests/test_gvins_e2e.py's renderer, held equal to them in
tests/test_torch_gins.py and tests/test_torch_gvins.py), so nothing here
imports jax. Gates: both CLIs exit 0; the 'replay finished' line with
> 0 nodes and a tracking state; gvins.yaml, ic_gvins_tpu.log and
trajectory.csv (8 columns) in the output directory; the seven result files
written."""

import os
import re
import subprocess
import sys

import numpy as np
from PIL import Image

import chip_smoke
from ic_gvins_tpu_torch.core import rotation_np
from ic_gvins_tpu_torch.vision import camera as tcam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH_NS = 1544582648_000_000_000  # urban38-era epoch
FRAME_DT = 0.25                    # 4 Hz keeps the CPU replay short
W, H, FX = 320, 240, 250.0
RESULT_FILES = ("gvins.nav", "trajectory.csv", "IMU_ERR.bin", "statistics.txt", "extrinsic.txt",
                "mappoint.txt", "tracking.txt")


def write_kaist_fixture(root, imu, gnss, truth, frame_times, camera):
    """Lay the synthetic world out like a raw KAIST sequence (the layout of
    tests/test_kaist_recipe_e2e.py:_write_kaist_fixture)."""
    sd = os.path.join(root, "sensor_data")
    img_dir = os.path.join(root, "image", "stereo_left")
    os.makedirs(sd)
    os.makedirs(img_dir)

    # xsens_imu.csv: ns stamps, rates in the raw x-fwd/y-left/z-up mount
    t_ns = EPOCH_NS + np.round(np.asarray(imu["time"]) * 1e9).astype(np.int64)
    dt = np.asarray(imu["dt"])
    flip = np.array([1.0, -1.0, -1.0])
    gyro = np.asarray(imu["dtheta"]) / dt[:, None] * flip
    acc = np.asarray(imu["dvel"]) / dt[:, None] * flip
    with open(os.path.join(sd, "xsens_imu.csv"), "w") as f:
        for k in range(len(t_ns)):
            g, a = gyro[k], acc[k]
            f.write(f"{t_ns[k]},0,0,0,1,0,0,0,{g[0]:.9f},{g[1]:.9f},{g[2]:.9f},"
                    f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f},0,0,0\n")

    # vrs_gps.csv: lat/lon deg, alt m, stds in columns 9-11
    with open(os.path.join(sd, "vrs_gps.csv"), "w") as f:
        for k in range(len(gnss["time"])):
            tg = EPOCH_NS + int(round(gnss["time"][k] * 1e9))
            lat, lon = np.rad2deg(gnss["blh"][k][:2])
            sn, se, sd_ = gnss["std"][k]
            f.write(f"{tg},{lat:.12f},{lon:.12f},0.0,0.0,{gnss['blh'][k][2]:.6f},2,11,1.0,"
                    f"{sn:.4f},{se:.4f},{sd_:.4f},0,0.0,0.0,0.0,A\n")

    # frames: data_stamp.csv + rendered 8-bit PNGs
    rng = np.random.default_rng(7)
    pts_w = np.stack([rng.uniform(-10, 55, 600), rng.uniform(-25, 25, 600), rng.uniform(9, 13, 600)], axis=1)
    with open(os.path.join(sd, "data_stamp.csv"), "w") as f:
        for tf in frame_times:
            s = EPOCH_NS + int(round(tf * 1e9))
            f.write(f"{s},stereo\n")
            i = min(int(round(tf * 200.0)) - 1, len(truth["p"]) - 1)
            img = chip_smoke.ground_frame(tcam, camera, pts_w, rotation_np.to_matrix(truth["q"][i]), truth["p"][i],
                                          *chip_smoke.SMALL_BLOB)
            Image.fromarray(img.astype(np.uint8), "L").save(os.path.join(img_dir, f"{s}.png"))


def test_kaist_recipe_through_the_port(tmp_path):
    imu, gnss, truth = chip_smoke.gins_world(with_earth=True)
    cut = int(11.0 * 200)
    imu = {k: np.asarray(v)[:cut] for k, v in imu.items()}
    gnss = {k: np.asarray(v)[:10] for k, v in gnss.items()}
    camera = tcam.PinholeCamera.from_config([FX, FX, 160.0, 120.0], [-0.05, 0.01, 0.0, 0.0], [W, H])
    frame_times = np.arange(0.25, imu["time"][-1] - 0.3, FRAME_DT)

    seq, out = str(tmp_path / "seq"), str(tmp_path / "txt")
    os.makedirs(out)
    write_kaist_fixture(seq, imu, gnss, truth, frame_times, camera)
    env = dict(os.environ, OMP_NUM_THREADS="2")

    # 1) the converter CLI (the recipe's first step)
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "convert_kaist.py"), "--seq", seq,
                        "--out", out], capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert f"frames: {len(frame_times)}" in r.stdout
    with open(os.path.join(out, "frames.txt")) as f:
        assert all(len(line.split()) == 2 for line in f)     # 'stamp relpath' lines (R2/P5)

    # 2) gvins.yaml in raw (reference) units: tests/test_kaist_recipe_e2e.py's
    cfgpath = str(tmp_path / "gvins.yaml")
    lever = truth["lever"]
    with open(cfgpath, "w") as f:
        f.write(f"""
outputpath: {tmp_path / 'outdir'}
is_make_outputdir: false
initlength: 3
imudatarate: 200
iswithearth: true
antlever: [{lever[0]}, {lever[1]}, {lever[2]}]
gnssthreshold: 20
imumodel: {{arw: 0.1, vrw: 0.1, gbstd: 400.0, abstd: 400.0, corrtime: 1.0}}
optimize_windows_size: 8
optimize_num_iterations: 15
optimize_estimate_extrinsic: false
optimize_estimate_td: false
track_min_parallax: 20
track_max_interval: 0.5
track_max_features: 120
reprojection_error_std: 1.5
node_slots: 14
landmark_slots: 256
gnss_slots: 16
reproj_slots: 1024
cam0:
  intrinsic: [{FX}, {FX}, 160.0, 120.0]
  distortion: [-0.05, 0.01, 0.0, 0.0]
  resolution: [{W}, {H}]
  q_b_c: [0.0, 0.0, 0.0, 1.0]
  t_b_c: [0.0, 0.0, 0.0]
  td_b_c: 0.0
""")

    # 3) the port's replay CLI, as the converter's printed recipe says
    outdir = str(tmp_path / "outdir")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "run_gvins_torch.py"), "--config", cfgpath,
         "--device", "cpu", "--imu", os.path.join(out, "imu.txt"), "--imu-mode", "rate",
         "--gnss", os.path.join(out, "gnss.txt"), "--frames", os.path.join(out, "frames.txt"),
         "--imagedir", seq, "--output", outdir],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    log = r.stderr + r.stdout
    m = re.search(r"replay finished: (\d+) trajectory nodes, state=(\S+)", log)
    assert m, log[-2000:]
    assert int(m.group(1)) > 0
    assert m.group(2) in ("TRACKING_NORMAL", "TRACKING_INITIALIZING")
    for fname in ("gvins.yaml", "ic_gvins_tpu.log", *RESULT_FILES):
        assert os.path.exists(os.path.join(outdir, fname)), fname
    assert "replay finished" in open(os.path.join(outdir, "ic_gvins_tpu.log")).read()
    traj = np.loadtxt(os.path.join(outdir, "trajectory.csv"), ndmin=2)
    assert traj.shape[1] == 8 and len(traj) > 0
