"""The port's input path on the CPU: its copy of the dataset loaders against
the JAX package's (the six cases of tests/test_dataset_io.py, through the
native C++ parser and the numpy path), the two-column ``stamp relpath``
frame index (ROADMAP P5), and its yaml-free gvins.yaml reader against
``yaml.safe_load``."""

import dataclasses
import os

import numpy as np
import pytest
import yaml
from PIL import Image

import test_dataset_io as ref
from ic_gvins_tpu.engine import config as jconfig
from ic_gvins_tpu.io import dataset as jdata
from ic_gvins_tpu_torch.engine import config as tconfig
from ic_gvins_tpu_torch.io import dataset as tdata

imu_file = ref.imu_file


@pytest.fixture(params=["native", "numpy"])
def parser(request, monkeypatch):
    """Both packages on the same parser: the native loader, or the numpy path
    (the library hidden from both)."""
    if request.param == "native":
        if not (jdata._find_lib() and tdata._find_lib()):
            pytest.fail("native/libicgvins_loader.so is in the repository but did not load")
    else:
        monkeypatch.setattr(jdata, "_LIB", False)
        monkeypatch.setattr(tdata, "_LIB", False)
    assert tdata.parser() == request.param
    return request.param


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_imu(imu_file, parser):
    """test_imu_native / test_imu_fallback: gap filled at the nominal dt."""
    imu = tdata.load_imu(imu_file, 200.0)
    ref._check_imu(imu)
    _same(imu, jdata.load_imu(imu_file, 200.0))


def test_native_matches_fallback(imu_file):
    native = tdata.load_imu(imu_file, 200.0)
    arr = tdata._numpy_imu(imu_file, 200.0, 0)
    np.testing.assert_allclose(native["time"], arr[:, 0], atol=1e-12)
    np.testing.assert_allclose(native["dtheta"], arr[:, 2:5], atol=1e-15)
    np.testing.assert_array_equal(arr, jdata._numpy_imu(imu_file, 200.0, 0))


def test_rate_mode(tmp_path, parser):
    p = tmp_path / "imu_rate.txt"
    np.savetxt(p, [[0.005, 0.2, -0.4, 0.1, 2.0, -9.8, -9.8], [0.010, 0.2, -0.4, 0.1, 2.0, -9.8, -9.8]], fmt="%.9f")
    imu = tdata.load_imu(str(p), 200.0, mode="rate")
    np.testing.assert_allclose(imu["dtheta"][1], np.array([0.2, -0.4, 0.1]) * 0.005, atol=1e-12)
    _same(imu, jdata.load_imu(str(p), 200.0, mode="rate"))


def test_odometer_column(tmp_path, parser):
    """An 8th column is the wheel increment (odovel), gap-filled like the rest."""
    rows = [[0.005 * (k + 1) + (0.01 if k >= 3 else 0.0), 0.001, 0.0, 0.0, 0.0, 0.0, -0.049, 0.01 * k]
            for k in range(6)]
    p = tmp_path / "imu_odo.txt"
    np.savetxt(p, rows, fmt="%.9f")
    imu = tdata.load_imu(str(p), 200.0)
    assert len(imu["odovel"]) == 8 and imu["odovel"][-1] == pytest.approx(0.05)
    _same(imu, jdata.load_imu(str(p), 200.0))


def test_gnss(tmp_path, parser):
    p = tmp_path / "gnss.txt"
    np.savetxt(p, [[1.0, 30.5, 114.3, 40.0, 0.05, 0.05, 0.1]], fmt="%.9f")
    g = tdata.load_gnss(str(p))
    np.testing.assert_allclose(g["blh"][0, 0], np.deg2rad(30.5), atol=1e-12)
    np.testing.assert_allclose(g["std"][0], [0.05, 0.05, 0.1], atol=1e-12)
    _same(g, jdata.load_gnss(str(p)))


def test_gnss_dual_antenna_yaw(tmp_path, parser):
    p = tmp_path / "gnss_yaw.txt"
    np.savetxt(p, [[1.0, 30.5, 114.3, 40.0, 0.05, 0.05, 0.1, 95.0, 1.0],
                   [2.0, 30.5, 114.3, 40.0, 0.05, 0.05, 0.1, 0.0, 0.0]], fmt="%.9f")
    g = tdata.load_gnss(str(p))
    assert bool(g["isyawvalid"][0]) and not bool(g["isyawvalid"][1])
    np.testing.assert_allclose(g["yaw"][0], np.deg2rad(95.0), atol=1e-12)
    _same(g, jdata.load_gnss(str(p)))
    p2 = tmp_path / "gnss_plain.txt"
    np.savetxt(p2, [[1.0, 30.5, 114.3, 40.0, 0.05, 0.05, 0.1]], fmt="%.9f")
    g2 = tdata.load_gnss(str(p2))
    assert not g2["isyawvalid"].any()
    _same(g2, jdata.load_gnss(str(p2)))


def _frames(tmp_path, two_columns):
    """Three 8-bit frames and their index: 'stamp relpath' lines (the form
    scripts/convert_kaist.py writes) or bare stamps naming '<stamp>.png'."""
    rng = np.random.default_rng(5)
    stamps = [1544582648.25, 1544582648.5, 1544582648.75]
    os.makedirs(tmp_path / "image" / "stereo_left")
    imgs, lines = [], []
    for t in stamps:
        img = rng.integers(0, 256, (12, 16), dtype=np.uint8)
        rel = os.path.join("image", "stereo_left", f"{int(round(t * 1e9))}.png") if two_columns else f"{t:.6f}.png"
        Image.fromarray(img, "L").save(tmp_path / rel)
        imgs.append(img)
        lines.append(f"{t:.9f} {rel}" if two_columns else f"{t:.9f}")
    path = tmp_path / "frames.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path), stamps, imgs


def test_frame_index_stamp_relpath(tmp_path, parser):
    """P5: the port reads the name column of 'stamp relpath' lines, whichever
    parser read the stamps; the reference leaves the names out (R2) and
    looks for '<stamp>.png', which does not exist."""
    path, stamps, imgs = _frames(tmp_path, True)
    times, provider = tdata.load_frame_index(path, str(tmp_path))
    jtimes, jprovider = jdata.load_frame_index(path, str(tmp_path))
    np.testing.assert_array_equal(times, jtimes)
    np.testing.assert_allclose(times, stamps, atol=1e-6)
    for k, img in enumerate(imgs):
        got = provider(k)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, img.astype(np.float64))
    with pytest.raises(FileNotFoundError, match=f"{stamps[0]:.6f}.png"):
        jprovider(0)


def test_frame_index_one_column(tmp_path, parser):
    """Bare stamps name '<stamp>.png' beside the index, in both packages."""
    path, stamps, imgs = _frames(tmp_path, False)
    times, provider = tdata.load_frame_index(path)
    jtimes, jprovider = jdata.load_frame_index(path)
    np.testing.assert_array_equal(times, jtimes)
    for k, img in enumerate(imgs):
        np.testing.assert_array_equal(provider(k), img.astype(np.float64))
        np.testing.assert_array_equal(provider(k), jprovider(k))


# ---------------------------------------------------------------------------
# gvins.yaml without pyyaml
# ---------------------------------------------------------------------------

# the file tests/test_kaist_recipe_e2e.py writes (its values filled in)
KAIST_YAML = """
outputpath: /tmp/run/outdir
is_make_outputdir: false
initlength: 3
imudatarate: 200
iswithearth: true
antlever: [-0.3, 0.01, 0.35]
gnssthreshold: 20
imumodel: {arw: 0.1, vrw: 0.1, gbstd: 400.0, abstd: 400.0, corrtime: 1.0}
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
  intrinsic: [125.0, 125.0, 160.0, 120.0]
  distortion: [-0.05, 0.01, 0.0, 0.0]
  resolution: [320, 240]
  q_b_c: [0.0, 0.0, 0.0, 1.0]
  t_b_c: [0.0, 0.0, 0.0]
  td_b_c: 0.0
"""

# every key of SURVEY.md 5.6 plus odometer:, in the reference's layout, with
# comments, a block map for imumodel, a list over two lines, quoted strings
# and CRLF line ends
FULL_YAML = """---
# IC-GVINS configuration
outputpath: "/data/urban38 out"   # quoted, with a space
is_make_outputdir: true
initlength: 3
imudatarate: 100
iswithearth: True

antlever: [ -0.37, 0.008, 0.353 ]   # antenna lever arm, m
imumodel:
    arw: 0.24      # deg/sqrt(hr)
    vrw: 0.24
    gbstd: 50.0
    abstd: 250.0
    corrtime: 1.0
isusegnssoutage: false
gnssoutagetime: 1.0e+3
gnssthreshold: .5
is_use_visualization: false
track_check_histogram: true
track_min_parallax: 20
track_max_interval: 0.5
track_max_features: 200
reprojection_error_std: 1.5
optimize_windows_size: 10
optimize_num_iterations: 20
optimize_estimate_extrinsic: true
optimize_estimate_td: true
isuseodo: yes
odometer:
  std: [0.02, 0.5, 0.5]
  srw: 1000
  abv: [0.0, 0.5, -1.0]
  lodo: [0.1, 0.0, -0.2]
cam0:
    intrinsic: [ 787.16, 787.39,
                 664.40, 519.51 ]
    distortion: [ -0.0917, 0.0813, 0.000176, 0.000167 ]
    resolution: [ 1278, 1022 ]
    q_b_c: [ 0.0, 0.0, 0.0, 1.0 ]
    t_b_c: [ 1.0, -0.5, 0.2 ]
    td_b_c: -0.01
note: 'it''s # not a comment'
empty: ~
""".replace("\n", "\r\n")

MALFORMED = [
    ("outputpath: x\ncam0:\n  intrinsic: [1, 2]\n    resolution: [3, 4]\n", 4),   # a second indent level
    ("imumodel: {arw: 0.1, vrw: {x: 1}}\n", 1),                                   # nested flow map
    ("initlength: 3\n- 4\n", 2),                                                  # block list
    ("antlever: [0.1, 0.2\n", 1),                                                 # unterminated list
    ("initlength: 3\ninitlength: 4\n", 2),                                        # duplicate key
    ("imudatarate: 0200\n", 1),                                                   # YAML 1.1 octal
    ("cam0:\n\tintrinsic: [1, 2]\n", 2),                                          # tab indentation
]


@pytest.mark.parametrize("text", [KAIST_YAML, FULL_YAML], ids=["kaist_recipe", "every_key"])
def test_config_parser_equals_safe_load(text, tmp_path):
    raw = tconfig.parse_yaml(text)
    assert raw == yaml.safe_load(text)
    path = tmp_path / "gvins.yaml"
    path.write_bytes(text.encode())
    # the port's load_config equals the JAX load_config (pyyaml) on the file
    assert dataclasses.asdict(tconfig.load_config(str(path))) == dataclasses.asdict(jconfig.load_config(str(path)))


def test_config_every_key_parsed():
    cfg = tconfig.parse_config(tconfig.parse_yaml(FULL_YAML))
    assert cfg.outputpath == "/data/urban38 out" and cfg.imudatarate == 100 and cfg.gnssthreshold == 0.5
    assert cfg.isuseodo is True and cfg.odometer.srw == pytest.approx(1e-3)
    assert cfg.cam0.intrinsic == [787.16, 787.39, 664.40, 519.51] and cfg.cam0.td_b_c == -0.01
    assert cfg.imumodel.arw == pytest.approx(0.24 * np.pi / 180 / 60)
    assert cfg.track_check_histogram and cfg.gnssoutagetime == 1000.0


def test_config_numbers_as_yaml_cpp_reads_them():
    """Exponents without a dot or sign and signed leading-dot floats are
    numbers, as the reference's yaml-cpp reads them (pyyaml's YAML 1.1
    resolver keeps these strings, and its load_config would then fail)."""
    raw = tconfig.parse_yaml("a: 1e-5\nb: -.5\nc: 2E3\n")
    assert raw == {"a": 1e-5, "b": -0.5, "c": 2000.0}
    assert all(isinstance(v, str) for v in yaml.safe_load("a: 1e-5\nb: -.5\nc: 2E3\n").values())


@pytest.mark.parametrize("text,line", MALFORMED)
def test_config_malformed_raises_with_line(text, line):
    with pytest.raises(tconfig.YamlSubsetError, match=f"gvins.yaml:{line}:"):
        tconfig.parse_yaml(text)
