"""The import guard compares top-level module names whole, and a run
loads neither JAX nor the JAX package (``repro``), nor reads the JAX
package's benchmarks or the smoke script."""

import subprocess
import sys

from tesserae_bench import run

from conftest import ROOT


def test_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "reproduce", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.core", "repro_torch"]) == ["repro"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(ROOT / 'tesserae_bench' / 'tests')!r}]
import pathlib, torch
torch.set_num_threads(1)
from conftest import run_tiny
from tesserae_bench import control, readings, run
out = run_tiny("paper256-backlog", pathlib.Path({str(tmp_path)!r}), nodes=4)
assert out["correct"]
print(run.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_the_benchmark_reads_no_jax_side_file():
    for path in (ROOT / "tesserae_bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("import jax", "from repro.", "from repro ", "import repro\n", "chip_smoke", "BENCH_"):
            assert word not in text, (path, word)
        assert "benchmarks/" not in text.replace("repro_torch/benchmarks/", ""), path
