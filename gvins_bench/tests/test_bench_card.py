"""On the card, at each cell's own size: a short window of the cell is
correct and its control is not. Marked ``cuda``; skips where torch sees
no CUDA device. Run on the chip with

    python3 -m pytest -m cuda gvins_bench/tests/test_bench_card.py
"""

import pytest

from gvins_bench import check, run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")["workloads"]])
def test_cell_and_its_control_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = run.cell_spec(workload)
    rec = run.run_cell(spec, 2**31 + 101, 15.0, False, "cuda", control=True, log=lambda *a: None)
    assert rec["correct"] is True, rec["checks"]
    assert not check.verdict(rec["control"], spec["limits"])[0], rec["control"]
