"""The benchmark of ``expecto_tpu_torch`` on one NVIDIA GPU.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(kernels built into ``build/kernels`` on the first run of a checkout,
inputs and weights from ``--seed``, the cell's shapes warmed up), then whole
calls of the program's entry until ``--seconds`` have passed, then the
check of a sample of the outputs against the plain reference. ``--trace 1``
adds a profiled stretch of calls after the window and reports the cell's
per-layer metrics instead of its end-to-end ones. The last line of standard
output is one JSON object; the compared numbers and their limits are the
last lines of standard error.

Exits 3 without a result when no CUDA device is present (or fewer than the
cell asks for), 4 when JAX or the JAX package was loaded, 1 on any error.
"""

from __future__ import annotations

import argparse
import os
import sys

from .harness import ROOT, find_cell, forbidden_loaded, load_manifest, print_result, process_start_time, run_cell


def main(argv=None) -> int:
    started = process_start_time()
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program and of the benchmark stays in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))

    import torch

    cell = find_cell(load_manifest(), args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    found = forbidden_loaded()
    if found:
        print(f"bench: JAX modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
