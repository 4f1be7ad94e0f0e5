"""Shared set-up of the benchmark's own tests (``python -m pytest
tesserae_bench/tests``): the checkout's root and ``src`` on the path, a
``card`` marker for tests that need the GPU (decided in a fixture, never at
import), and tiny CPU versions of the cells."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload: str, nodes: int = 8, warmup: int = 6, live: int = 2, rounds: int = 60):
    """The cell's files with the cluster cut to ``nodes`` nodes and a short
    warm-up and trace, for the CPU (the traffic scales per GPU)."""
    from tesserae_bench import harness

    manifest = harness.load_manifest()
    cell, config, mix = harness.resolve(manifest, workload)
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["cluster"]["num_nodes"] = nodes
    mix.update(warmup_rounds=warmup, live_rounds=live, trace_rounds=warmup + rounds, reference_rounds=3)
    return manifest, (cell, config, mix)


def run_tiny(workload: str, tmp_path, seconds: float = 1.0, seed: int = 2**31 + 17, **kw):
    from tesserae_bench import harness

    manifest, cell_data = tiny_cell(workload, **kw)
    return harness.run_cell(
        workload, seed, seconds, False, "cpu", manifest=manifest, cell_data=cell_data,
        keep_rounds=True, cache_dir=tmp_path,
    )
