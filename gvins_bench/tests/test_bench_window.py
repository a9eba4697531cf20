"""The harness's window, result line and check on a tiny world, with the
port on the CPU (its plain kernels): the run skips only the look for a card."""

import json

import pytest

from gvins_bench import check, run
from gvins_bench.tests import tiny

SEED = 2**31 + 17


@pytest.fixture(scope="module")
def untraced(tmp_path_factory):
    spec = tiny.spec(tmp_path_factory.mktemp("tiny"))
    return spec, run.run_cell(spec, SEED, 5.0, False, "cpu", control=True, log=lambda *a: None)


def test_result_line(untraced):
    spec, rec = untraced
    keys = list(rec)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert rec["correct"] is True and rec["failed"] == 0 and rec["attempted"] >= 3
    assert set(rec["metrics"]) == {"frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in rec["metrics"].values())
    assert set(rec["checks"]) == set(check.NAMES)
    assert rec["device"]["platform"] == "cpu"
    json.dumps(rec)


def test_the_control_is_not_correct(untraced):
    """The reference one precision lower in the program's place fails a
    number that it reads, at the cell's limits."""
    spec, rec = untraced
    control = rec["control"]
    over = [n for n, v in control.items() if v is not None and v > spec["limits"][n]]
    assert over, control
    assert not check.verdict(control, spec["limits"])[0]


def test_traced_run_reads_the_spans(tmp_path):
    spec = tiny.spec(tmp_path)
    rec = run.run_cell(spec, SEED + 1, 5.0, True, "cpu", log=lambda *a: None)
    assert rec["correct"] is True
    names = set(rec["metrics"])
    assert {"episodes_per_frame", "episode_ms", "track_ms", "ins_ms_per_frame"} <= names
    # no device, so nothing is read from a device trace, and nothing reads 0
    assert not names & {"kernel_roofline_pct", "kernels_per_frame", "host_ms_per_frame", "device_idle_pct"}
    assert "breakdown" not in rec


def test_a_world_that_ends_closes_the_window(tmp_path):
    spec = tiny.spec(tmp_path, seconds_world=21.0)
    lines = []
    rec = run.run_cell(spec, SEED + 2, 1000.0, False, "cpu", log=lines.append)
    assert any("the world ended before the deadline" in line for line in lines)
    assert rec["attempted"] > 0 and rec["correct"] is True
