"""The port's tracer (``ic_gvins_tpu_torch/utils/timecost.py``) on the CPU.

Off it records nothing and opens no profiler annotation; on, its records
nest (parent indices, frame ids), self time is a span less its children,
and under ``torch.profiler`` every span is also a record-function event of
its name, its duration within microseconds of the span's. The span names the port's call sites use are exactly
``NAMES``. A short replay (chip_smoke's jax-free 24 s world cut to 12 s,
seen by the 160x120 camera of tests/test_gvins_long_e2e.py, a window of 3
keyframes so that it marginalizes) runs with the tracer off, then switched
on at a frame: the three stopwatch sites (``track_ms``, ``last_solve_times``,
``timecosts[2]``) time themselves either way, the statistics.txt columns
10-12 and tracking.txt column 7 are positive throughout, and with the
tracer on each value equals its span's duration.
"""

import re
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ic_gvins_tpu_torch.core import rotation_np
from ic_gvins_tpu_torch.engine import estimator as estimator_mod
from ic_gvins_tpu_torch.engine.config import parse_config
from ic_gvins_tpu_torch.engine.host import fetch
from ic_gvins_tpu_torch.models import gvins as gvins_mod
from ic_gvins_tpu_torch.solver import lm
from ic_gvins_tpu_torch.utils import timecost
from ic_gvins_tpu_torch.vision import camera as cam
from ic_gvins_tpu_torch.vision import tracking as tracking_mod

torch.set_num_threads(1)

PACKAGE = Path(__file__).resolve().parents[1] / "ic_gvins_tpu_torch"
HARNESS_LABELS = ("episode", "track", "ins", "loop")
DRIVE_S = 12.0
TRACE_FROM = 100          # the frame from which the replay runs traced


@pytest.fixture
def tracer():
    timecost.enable()
    try:
        yield timecost
    finally:
        timecost.disable()


def _annotations(prof):
    """(name, duration ns) of every event the profiler recorded, in the
    order they started (what a trace reader sees: nested events of one name
    are kept apart)."""
    events = sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
    return [(e.name(), e.duration_ns()) for e in events]


def test_off_records_nothing_and_opens_no_annotation():
    assert not timecost.enabled()
    assert timecost.span("ep.optimize") is timecost.span("marg")     # one shared object
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timecost.span("ep.optimize"):
            with timecost.span("lm.pass1"):
                torch.ones(3).sum()
        timecost.traced("marg")(lambda: None)()
    assert timecost.records() == []
    names = {name for name, _ in _annotations(prof)}
    assert not {"ep.optimize", "lm.pass1", "marg"} & set(names), names


def test_nesting_gives_parents_and_frames(tracer):
    with tracer.span("gnss.drain"):
        pass
    with tracer.span("frame", frame=7):
        with tracer.span("track.frame"):
            with tracer.span("track.lk"):
                pass
            with tracer.span("track.detect"):
                pass
        with tracer.span("ep.optimize"):
            with tracer.span("host.fetch"):
                pass
    with tracer.span("frame", frame=8):
        pass
    with tracer.span("gnss.drain"):
        pass
    recs = tracer.records()
    assert [r[0] for r in recs] == ["gnss.drain", "frame", "track.frame", "track.lk", "track.detect",
                                    "ep.optimize", "host.fetch", "frame", "gnss.drain"]
    assert [r[3] for r in recs] == [-1, -1, 1, 2, 2, 1, 5, -1, -1]
    # spans carry the frame being processed; between frames, the last one's
    assert [r[4] for r in recs] == [-1, 7, 7, 7, 7, 7, 7, 8, 8]
    for name, s, e, parent, _ in recs:
        assert s <= e
        if parent >= 0:
            assert recs[parent][1] <= s and e <= recs[parent][2], name


def test_self_time_is_the_span_less_its_children(tracer):
    with tracer.span("ep.optimize"):
        with tracer.span("ep.tables"):
            torch.linalg.inv(torch.eye(64) * 2)
        with tracer.span("lm.pass1"):
            with tracer.span("host.fetch"):
                torch.ones(8).numpy()
        torch.ones(1000).cumsum(0)
    recs = tracer.records()
    own = tracer.self_ns(recs)
    dur = [e - s for _, s, e, _, _ in recs]
    assert own[0] == dur[0] - dur[1] - dur[2]
    assert own[1] == dur[1] and own[2] == dur[2] - dur[3] and own[3] == dur[3]
    assert all(x >= 0 for x in own)


def test_every_span_is_mirrored_into_the_profiler(tracer):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k, name in enumerate(timecost.NAMES):
            with tracer.span("frame", frame=k):
                with tracer.span(name):
                    torch.ones(16).sum()
    recs = tracer.records()
    mirrored = [(name, ns) for name, ns in _annotations(prof) if name in timecost.NAMES]
    assert [name for name, _ in mirrored] == [r[0] for r in recs]
    # each annotation brackets its span: the same durations to the clocks' grain
    gaps = [abs(ns - (e - s)) for (_, ns), (_, s, e, _, _) in zip(mirrored, recs)]
    assert statistics.median(gaps) < 5e4       # ns


def _call_site_names():
    pattern = re.compile(r"""(?:span|Span|traced)\(\s*["']([^"']+)["']""")
    used = {}
    for path in PACKAGE.rglob("*.py"):
        if path.name == "timecost.py":
            continue
        for name in pattern.findall(path.read_text()):
            used.setdefault(name, []).append(path.relative_to(PACKAGE).as_posix())
    return used


def test_the_call_sites_use_exactly_the_names():
    used = _call_site_names()
    assert set(used) == set(timecost.NAMES), sorted(set(used) ^ set(timecost.NAMES))
    assert len(set(timecost.NAMES)) == len(timecost.NAMES)
    assert not set(timecost.NAMES) & set(HARNESS_LABELS)


def _short_replay(outdir, on_frame):
    imu, gnss, truth = chip_smoke.gins_world(with_earth=False, seed=0)
    cut = int(DRIVE_S * 200)
    imu = {k: np.asarray(v)[:cut] for k, v in imu.items()}
    gnss = {k: np.asarray(v)[np.asarray(gnss["time"]) < DRIVE_S] for k, v in gnss.items()}
    camera = cam.PinholeCamera.from_config(*chip_smoke.LONG_CAMERA)
    times, images = chip_smoke.gvins_frames(cam, rotation_np, camera, dict(truth, time=imu["time"]),
                                            chip_smoke.e2e_scene(), chip_smoke.LONG_BLOB)
    raw = dict(chip_smoke.SMALL_RAW, track_max_features=40, optimize_windows_size=3)
    cfg = chip_smoke.gvins_config(parse_config, truth, raw, chip_smoke.LONG_CAMERA)
    model = gvins_mod.GvinsModel(cfg, outdir=str(outdir), device="cpu")

    def provider(k):
        on_frame(k)
        return images[k]
    model.run(imu, gnss, times, provider)
    return model


def test_stopwatch_sites_time_themselves_off_and_equal_their_spans_on(tmp_path, monkeypatch):
    seen = {"track": [], "solve": [], "marg": []}     # (tracer on, value) per call

    def spy(owner, name, kind, value):
        fn = getattr(owner, name)

        def wrapped(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            v = value(self, *args, **kwargs)
            if v is not None:
                seen[kind].append((timecost.enabled(), v))
            return out
        monkeypatch.setattr(owner, name, wrapped)

    spy(tracking_mod.Tracker, "track", "track", lambda t, *a: t.track_ms)
    spy(estimator_mod.SlidingWindowEstimator, "optimize", "solve",
        lambda e, *a, two_pass=False, **kw: e.last_solve_times if two_pass else None)
    spy(gvins_mod.GvinsModel, "_marginalize_visual", "marg", lambda m: m.timecosts[2])

    counts = {}

    def on_frame(k):
        if k == TRACE_FROM:
            counts.update(reads=fetch.reads, steps=lm.solve.steps)
            timecost.enable()
    try:
        model = _short_replay(tmp_path, on_frame)
    finally:
        timecost.disable()
    recs = timecost.records()
    assert model.state == "TRACKING_NORMAL"

    # each kind ran both off and on, and off it still timed itself
    for kind, calls in seen.items():
        off = [v for on, v in calls if not on]
        on = [v for on, v in calls if on]
        assert off and on, (kind, len(off), len(on))
        assert all(np.all(np.asarray(v) > 0) for v in off), (kind, off)

    # on, each value is its span's duration
    spans = {}
    for name, s, e, _, _ in recs:
        spans.setdefault(name, []).append(e - s)
    assert [v for on, v in seen["track"] if on] == [ns / 1e6 for ns in spans["track.frame"]]
    assert [v for on, v in seen["marg"] if on] == [ns / 1e6 for ns in spans["marg"]]
    assert [v for on, v in seen["solve"] if on] == [
        (p1 / 1e9, sg / 1e9 + p2 / 1e9) for p1, sg, p2 in zip(spans["lm.pass1"], spans["lm.surgery"],
                                                              spans["lm.pass2"])]

    # the traced part reaches every call site; frames are numbered from run
    assert set(spans) == set(timecost.NAMES), sorted(set(timecost.NAMES) - set(spans))
    frames = [f for name, _, _, _, f in recs if name == "frame"]
    assert frames[0] == TRACE_FROM and frames == sorted(frames)
    # the counters: one host.fetch span a read, at least one step an accepted one
    assert fetch.reads - counts["reads"] == len(spans["host.fetch"])
    assert lm.solve.steps - counts["steps"] >= len(spans["lm.pass1"]) + len(spans["lm.pass2"])

    # the files: statistics.txt columns 10-12 and tracking.txt column 7, off and on
    stats = np.loadtxt(tmp_path / "statistics.txt", ndmin=2)
    first_marg = np.argmax(stats[:, 12] > 0)
    assert stats[:, 12].any() and np.all(stats[:, 10:12] > 0) and np.all(stats[first_marg:, 12] > 0)
    track = np.loadtxt(tmp_path / "tracking.txt", ndmin=2)
    assert len(track) and np.all(track[:, 6] > 0)
