"""The port's tracer in the harness, on the tiny world with the port on the
CPU. ``program_trace.run_traced`` (a traced run with the tracer on) reports
the six metrics of the program's spans and counters, consistent with the
harness's own: an episode's LM iterations at most the configured count, and
together, like the episode's host bookkeeping, within the episode's time.
The harness's own runs, untraced and traced, leave the tracer off and add
no record."""

import pytest

from gvins_bench import program_trace, run
from gvins_bench.tests import tiny

SEED = 2**31 + 23
NEW = [name for name, _ in program_trace.METRICS]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    spec = tiny.spec(tmp_path_factory.mktemp("tiny"))
    return spec, program_trace.run_traced(spec, SEED, 5.0, "cpu", log=lambda *a: None)


def _iterations(spec):
    return next(int(line.split(":")[1]) for line in spec["yaml"].read_text().splitlines()
                if line.strip().startswith("optimize_num_iterations:"))


def test_the_six_metrics_are_read_and_consistent(traced):
    spec, rec = traced
    assert rec["correct"] is True
    m = {name: v["value"] for name, v in rec["metrics"].items()}
    assert set(NEW) <= set(m), sorted(m)
    assert all(m[name] > 0 for name in NEW), m
    assert m["lm_step_ms"] * m["lm_steps_per_episode"] <= m["episode_ms"]
    assert m["episode_host_ms"] < m["episode_ms"]
    assert m["lm_steps_per_episode"] <= _iterations(spec)


def test_the_program_section(traced):
    _, rec = traced
    p = rec["program"]
    assert p["tracer"] is True and p["ms_per_frame"] > 0
    assert {"frame", "ep.optimize", "lm.pass1", "lm.pass2", "host.fetch", "track.frame"} <= set(p["stages"])
    for count, total, own in p["stages"].values():
        assert count > 0 and 0 <= own <= total + 1e-9
    # every span opened in the profiled sub-window has its annotation there
    assert p["mirrors"]["spans"] > 0 and p["mirrors"]["spans"] == p["mirrors"]["annotations"]
    cost = p["span_cost_us"]
    assert 0 < cost["off"] < cost["on"] < cost["on_profiled"], cost
    assert list(rec)[-1] == "checks"


@pytest.mark.parametrize("trace", [False, True])
def test_the_harness_leaves_the_tracer_off(tmp_path, trace):
    from ic_gvins_tpu_torch.utils import timecost

    before = timecost.records()
    rec = run.run_cell(tiny.spec(tmp_path), SEED + 1, 3.0, trace, "cpu", log=lambda *a: None)
    assert rec["correct"] is True
    assert not timecost.enabled() and timecost.records() == before
    assert not set(NEW) & set(rec["metrics"])
