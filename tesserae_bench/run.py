"""Run one benchmark cell once and print its result as the last line.

    python3 tesserae_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's system from ``BENCHMARK.json`` and the files it
names, makes the jobs from ``--seed`` and runs the traffic's fixed warm-up
rounds; the window then runs scheduling rounds back to back for
``--seconds``; ``--trace 1`` runs it under the profiler and the Tracer and
reports the per-layer metrics instead of the end-to-end ones.  The run
judges what the window produced against the plain reference, prints each
number compared beside its limit on standard error, and exits non-zero
with no result where there is no card, where JAX or the JAX package was
loaded, or where the run could not be measured.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: top-level module names that no run may load (compared whole, so the
#: port ``repro_torch`` is not the JAX package ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's kernel caches stay at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    # one host thread for the math libraries, set before they load: the
    # round's host work is serial, and idle pool threads only add noise on
    # a host shared with others
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from tesserae_bench import harness

    torch.set_num_threads(1)

    manifest = harness.load_manifest()
    cell_data = harness.resolve(manifest, args.workload)
    chips = cell_data[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tesserae_bench: the cell wants {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
            t_start=T_START, manifest=manifest, cell_data=cell_data,
        )
    except harness.BenchError as exc:
        print(f"tesserae_bench: {exc}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"tesserae_bench: the run loaded {bad}", file=sys.stderr)
        return 4
    out["device"]["power_limit_w"] = power_limit()
    w = out["window"]
    print(f"window: {w['rounds']} rounds in {w['seconds']:.3f} s; active {w['active']}, "
          f"pending {w['pending']}, GPUs placed {w['placed_gpu_share']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr)
    compared = out.pop("compared")
    out["compared"] = compared  # the numbers compared come last in the line
    print(json.dumps(out))
    return 0


def power_limit():
    """The card's power limit in watts, from ``nvidia-smi`` (None if it
    cannot be read)."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
