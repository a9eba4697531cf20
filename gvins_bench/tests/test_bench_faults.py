"""A run with the program broken under the window reads as not correct:
one run for each fault a replay cell can have (a step that returns its
state unchanged: the INS propagation, the window solve; half of a batch
left out: LK's slots, the solve's reprojection factors; an answer altered
where it is produced: LK's points, the marginalization prior). The cells
run on one chip, so no exchange between chips exists to leave out."""

import pytest

from gvins_bench import run
from gvins_bench.tests import faults, tiny


@pytest.fixture
def restore_lk():
    from ic_gvins_tpu_torch.vision import lk

    original = lk.lk_pyr
    yield
    lk.lk_pyr = original


@pytest.mark.parametrize("fault, caught_by", [
    (faults.ins_state_unchanged, "ins_gap_m"),
    (faults.solve_state_unchanged, "solve_gap_m"),
    (faults.solve_half_reprojection, "solve_gap_m"),
    (faults.prior_left_out, "prior_gap"),
    (faults.lk_half_batch, "lk_status_mismatch"),
    (faults.lk_answer_altered, "lk_endpoint_gap_px"),
])
def test_fault_is_not_correct(tmp_path, restore_lk, fault, caught_by):
    spec = tiny.spec(tmp_path)
    rec = run.run_cell(spec, 2**31 + 40, 5.0, False, "cpu", fault=fault, log=lambda *a: None)
    assert rec["correct"] is False
    if rec["failed"] == 0:
        c = rec["checks"][caught_by]
        assert c["value"] is not None and c["value"] > c["limit"], rec["checks"]
