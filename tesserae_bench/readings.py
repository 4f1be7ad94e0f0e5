"""The readings that the limits of ``correct`` are set from.

    python3 tesserae_bench/readings.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds <s>

Runs the cell as ``run.py`` does, once per seed in one process, and prints
for each seed the numbers compared of the program's run and, for the
control seeds, of the control (``control.py``) and of the packing fault
(``control.packing``) judged on the same rounds.
The largest program reading and the smallest control reading of each
number bound its limit from below and from above.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from tesserae_bench import control, harness

    manifest = harness.load_manifest()
    cell_data = harness.resolve(manifest, args.workload)
    config, mix = cell_data[1], cell_data[2]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = harness.run_cell(
            args.workload, seed, args.seconds, False, args.device,
            manifest=manifest, cell_data=cell_data, keep_rounds=True,
        )
        row = dict(seed=seed, correct=out["correct"], rounds=out["window"]["rounds"],
                   program={k: v["value"] for k, v in out["compared"].items()})
        if seed in ctrl:
            from tesserae_bench.reference import tesserae_round as ref

            table = ref.Jobs(out["jobs"])
            gpn = config["cluster"]["gpus_per_node"]
            compared, _ = harness.check(
                out["rounds"], out["jobs"], config, mix, seed,
                judge=lambda r: control.relabel(r, table, gpn),
            )
            row["control"] = {k: v["value"] for k, v in compared.items()}
            row["control_correct"] = all(v["value"] <= v["limit"] for v in compared.values())
            compared, _ = harness.check(
                out["rounds"], out["jobs"], config, mix, seed,
                judge=lambda r: control.packing(r, table),
            )
            row["packing_fault"] = {k: v["value"] for k, v in compared.items()}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
