"""The readings that a cell's correctness limits are set from, at the cell's
own sizes on the card:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,... --seconds S \
        [--controls 3] [--faults 3]

For each seed, in one process: one run of the cell (``harness.run_cell``)
with a window of ``S`` seconds, whose check gives the program's reading;
for the first ``--controls`` seeds also the control, the reference in the
configuration's lower precision (``"control"`` in its file) put in the
program's place; for the first ``--faults`` seeds of a training cell the
reference trained on half of the rows (half the batch left out). One JSON
line per seed, then one line with the largest program reading and the
smallest control and fault readings of each number. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    import torch

    from .harness import find_cell, load_manifest, run_cell

    ap = argparse.ArgumentParser(description="program, control and fault readings of a cell's check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(load_manifest(), args.workload)
    summary = {"program": {}}
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        controls = [cell.cfg["control"]] if j < args.controls else []
        if j < args.faults and cell.traffic["flow"] == "train":
            controls.append("half_rows")
        r = run_cell(args.workload, seed, args.seconds, False, controls=controls)
        line = {"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()}, **r.get("controls", {})}
        print(json.dumps(line), flush=True)
        for kind, readings in line.items():
            if kind == "seed":
                continue
            pick = max if kind == "program" else min
            for k, v in readings.items():
                summary.setdefault(kind, {})[k] = pick(summary.get(kind, {}).get(k, v), v)
        torch.cuda.empty_cache()
    control = summary.get(cell.cfg["control"], {})
    summary["ratio"] = {k: control[k] / summary["program"][k] for k in control if summary["program"].get(k, 0) > 0}
    print(json.dumps({"summary": summary, "workload": args.workload}), flush=True)
    return 0 if all(np.isfinite(v) for v in summary["program"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
