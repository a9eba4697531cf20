"""The port's four measurement scripts (scripts/*_torch.py) on the CPU: their
worlds against the JAX scripts' worlds, the section timer's arithmetic, and
each script's JSON record at a reduced size (schema only; their times are
the card's, in PERF.md).

- the replay benches' world (profile_replay_sections_torch.replay_world):
  the drive, GNSS fixes, frame times and rendered frames of
  scripts/bench_replay_host.py, built from tests/gins_data.py and
  tests/test_gvins_e2e.render_frame (1e-9; GNSS heights 1e-8 m);
- the production envelope's drive (gins_world(turn_duration=duration - 6,
  with_earth=True), at a 24 s duration) against make_gins_dataset, and its
  ``_render`` against scripts/bench_production.py's at 1278x1022 (1e-9);
- SectionProf's exclusive times on a toy call tree with a fake clock (exact);
- main(["--device", "cpu"]) of bench_frontend_stages_torch,
  profile_replay_sections_torch and bench_replay_host_torch, cut through
  their function arguments."""

import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gins_data import make_gins_dataset
from test_gvins_e2e import render_frame
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.vision import camera as jcam

torch.set_num_threads(2)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


frontend = _load("bench_frontend_stages_torch")
sections = _load("profile_replay_sections_torch")
host = _load("bench_replay_host_torch")
production = _load("bench_production_torch")
JAX_PRODUCTION = _load("bench_production")


def _close_world(port, ref):
    for a, b in zip(port, ref):
        assert a.keys() <= b.keys()
        for k in a:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            if k == "blh":   # heights pass through ECEF coordinates of ~6.4e6 m
                np.testing.assert_allclose(x[:, 2], y[:, 2], atol=1e-8, rtol=0, err_msg="height")
                x, y = x[:, :2], y[:, :2]
            np.testing.assert_allclose(x, y, atol=1e-9, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def jax_world():
    """make_gins_dataset(with_earth=True): the 24 s drive both replay
    benches cut, and the production drive at a 24 s duration (its turn
    lasts duration - 6 = 18 s, the default)."""
    return make_gins_dataset(turn_duration=18.0, with_earth=True)


def test_replay_world_matches_bench_replay_host(jax_world):
    """bench_replay_host.py: make_gins_dataset(with_earth=True) cut to
    15.2 s and 14 fixes, frames at 10 Hz to 0.2 s before the cut, each
    rendered by test_gvins_e2e.render_frame at the true pose."""
    imu, gnss, truth, times, images, cfg = sections.replay_world()
    jimu, jgnss, jtruth = jax_world
    n = int(15.2 * 200)
    _close_world((imu, gnss), ({k: np.asarray(v)[:n] for k, v in jimu.items()},
                               {k: np.asarray(v)[:14] for k, v in jgnss.items()}))
    jtimes = np.arange(0.05, np.asarray(jimu["time"])[:n][-1] - 0.2, 0.1)
    np.testing.assert_array_equal(times, jtimes)
    assert (cfg.node_slots, cfg.landmark_slots, cfg.gnss_slots, cfg.reproj_slots) == (20, 512, 24, 2048)
    assert cfg.optimize_num_iterations == 20 and cfg.track_max_features == 200 and cfg.iswithearth
    camera = jcam.PinholeCamera.from_config([250.0, 250.0, 160.0, 120.0], [-0.05, 0.01, 0.0, 0.0], [320, 240])
    rng = np.random.default_rng(42)
    pts_w = np.stack([rng.uniform(-10, 55, 800), rng.uniform(-25, 25, 800), rng.uniform(9, 13, 800)], axis=1)
    for k in (0, 60, len(times) - 1):
        i = min(int(round(times[k] * 200.0)) - 1, len(jtruth["p"]) - 1)
        Rwb = np.asarray(jquat.to_matrix(jnp.asarray(jtruth["q"][i])))
        np.testing.assert_allclose(images[k], render_frame(camera, pts_w, Rwb, jtruth["p"][i]), atol=1e-9, rtol=0)


def test_production_world_and_render_match_bench_production(jax_world):
    """bench_production.py's drive (turn_duration = duration - 6, earth
    rate on) at a 24 s duration, and its ``_render`` at 1278x1022 on 50
    ground points seen from a turned pose."""
    duration = 24.0
    _close_world(chip_smoke.gins_world(turn_duration=duration - 6.0, with_earth=True), jax_world)
    W, H = JAX_PRODUCTION.W, JAX_PRODUCTION.H
    assert (production.W, production.H, production.FX) == (W, H, JAX_PRODUCTION.FX)
    args = ([production.FX, production.FX, W / 2.0, H / 2.0], [-0.05, 0.01, 0.0, 0.0], [W, H])
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-9, 9, 50), rng.uniform(-7, 7, 50), rng.uniform(9, 13, 50)], axis=1)
    R = np.asarray(jquat.to_matrix(jnp.asarray([0.0, 0.0, np.sin(0.2), np.cos(0.2)])))
    t = np.array([0.4, -0.3, 0.0])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    want = JAX_PRODUCTION._render(jcam.PinholeCamera.from_config(*args), pts, R, t, xx, yy)
    from ic_gvins_tpu_torch.vision import camera as tcam
    got = production._render(tcam.PinholeCamera.from_config(*args), pts, R, t)
    assert (want != 90.0).sum() > 50 * 60
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


def test_section_timer_exclusive_times(monkeypatch):
    """a -> (b, c -> b); with a fake clock each section's exclusive time is
    its own ticks: a 1 + 2, b 3 a call, c 5; the dev: leaf c synchronizes
    (a no-op on the CPU)."""
    clock = [0.0]
    monkeypatch.setattr(sections, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    prof = sections.SectionProf(torch, "cpu")
    owner = types.SimpleNamespace()

    def tick(n):
        clock[0] += n

    owner.b = lambda: tick(3)
    owner.c = lambda: (tick(5), owner.b())
    owner.a = lambda: (tick(1), owner.b(), tick(2), owner.c())
    plain = dict(vars(owner))
    for name, label in (("a", "host.a"), ("b", "host.b"), ("c", "dev:c")):
        assert prof.wrap(owner, name, label)
    assert not prof.wrap(owner, "missing", "host.missing")
    prof.mode = "time"
    owner.a()
    owner.a()
    assert prof.excl == {"host.a": 6.0, "host.b": 12.0, "dev:c": 10.0}
    assert prof.calls == {"host.a": 2, "host.b": 4, "dev:c": 2}
    prof.mode = "annotate"   # only dev: calls are annotated, nothing accumulates
    owner.a()
    assert prof.calls == {"host.a": 2, "host.b": 4, "dev:c": 2}
    prof.restore()
    assert vars(owner) == plain


def _card_fields(rec):
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None and rec["torch"] == torch.__version__
    assert set(rec["launches"]) == {"clahe_apply", "lk_pyr", "subpix"}


def test_frontend_stages_schema():
    rec = frontend.main(["--device", "cpu", "--reps", "2"], size=(160, 128), frames=2)
    _card_fields(rec)
    assert set(rec["stages"]) == set(frontend.STAGES)
    for st in rec["stages"].values():
        assert st["as_issued_ms"]["median"] > 0 and st["as_issued_ms"]["p90"] >= st["as_issued_ms"]["median"]
        assert st["device_ms"] is None          # no device time on the CPU
    fr = rec["frontend_frames"]
    assert fr["frames"] == 2 and len(fr["states"]) == 4 and fr["busy_share"] is None
    one = frontend.main(["--device", "cpu", "--reps", "2", "--stage", "occ"], size=(160, 128))
    assert set(one["stages"]) == {"occ"} and "frontend_frames" not in one


def test_replay_sections_and_host_schema():
    """Both replay benches on a 9 s cut of the world, no warm replay."""
    rec = sections.main(["--device", "cpu"], seconds=9.0, warm=False, window=(4, 6))
    _card_fields(rec)
    assert rec["window_frames"] == 2 and rec["timed_frames"] > 10 and rec["wall_ms_per_frame"] > 0
    secs = rec["sections_ms_per_frame"]
    excl = [v["excl_ms"] for v in secs.values()]
    assert excl == sorted(excl, reverse=True)
    for name in ("dev:_pyr_body", "dev:_lk_stage", "dev:lm.solve", "dev:prop.propagate_to", "gvins._process_frame",
                 "trk._track_impl", "est.optimize"):
        assert secs[name]["calls"] > 0, name
    assert all("host_ms" in v for k, v in secs.items() if k.startswith("dev:"))
    assert rec["not_in_port"] == ["trk._undis"]

    rec = host.main(["--device", "cpu"], seconds=9.0, warm=False)
    _card_fields(rec)
    assert rec["frames"] > 10 and rec["episodes"] > 0 and rec["host_s"] is None
    assert rec["kf_ratio"] == pytest.approx(rec["episodes"] / rec["frames"])
    assert rec["fps_e2e"] > 0 and rec["margs"] >= 0
