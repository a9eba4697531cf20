"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and
no result without a card or without the program."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

from gvins_bench import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ic_gvins_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert "ic_gvins_tpu" not in run.forbidden_modules() or "ic_gvins_tpu" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "ic_gvins_tpu.probe", sys)
    assert "ic_gvins_tpu" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then the harness's own look."""
    code = (
        "import sys, tempfile\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from gvins_bench import run\n"
        "from gvins_bench.tests import tiny\n"
        "rec = run.run_cell(tiny.spec(tempfile.mkdtemp()), 5, 3.0, False, 'cpu', log=lambda *a: None)\n"
        "import gvins_bench.roofline, gvins_bench.trace\n"
        "for name in ('frame_ms_p95', 'kernel_roofline_pct', 'device_idle_pct'):\n"
        "    run.reader(name)\n"
        "print('FOUND', run.forbidden_modules(), rec['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] True" in out.stdout


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "gvins_bench" / "run.py"), "--workload", "urban38.replay",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gvins_bench", tmp_path / "gvins_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "gvins_bench/run.py", "--workload", "urban38.replay", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
