#!/usr/bin/env python3
"""Where the time of the port's serving call goes, on one NVIDIA GPU.

    python3 scripts/profile_serving_torch.py [--out DIR] [--seed N] [--fp32]

Builds chip_smoke.py's seeded main-path inputs (full Beluga widths, 218
models, maxshift 800, ~1,156 variants), runs ``score_sed_serving`` once to
warm up, then once more under ``torch.profiler`` with a span around each
runner route (substitution rows, indel pair rows, per-window fallback).
Prints the wall time (unprofiled and profiled), the device's busy and idle shares, device time per
kernel name and host time per route; ``--out DIR`` writes them to
``DIR/profile_serving.json`` (``profile_serving_fp32.json`` with ``--fp32``).
The default is the CLI's bf16 compute with an fp16 wire; ``--fp32`` is
parity mode (the CLI's ``--fp32``: fp32 compute and wire, TF32 off).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ROUTES = ("score_variant_spans_packed_rows", "score_variant_span_pairs_rows", "predict_codes")


def device_summary(prof, spans) -> tuple[list, float, dict]:
    """(device time per kernel name, device busy ms, host ms per span) of a
    ``torch.profiler`` run. CUPTI records the ctypes-launched kernels too;
    the script's own spans (``spans``) also appear as device-side annotation
    ranges and are kept apart. Busy time is the union of the kernel and copy
    intervals."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev = [e for e in prof.events() if e.device_type == cuda and e.name not in spans]
    by_name: dict[str, dict] = {}
    for e in dev:
        k = by_name.setdefault(e.name, {"name": e.name, "calls": 0, "device_ms": 0.0})
        k["calls"] += 1
        k["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    kernels = sorted(by_name.values(), key=lambda k: -k["device_ms"])
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if end > last_end:
            busy_us += end - max(start, last_end)
            last_end = end
    routes = {}
    for e in prof.events():
        if e.device_type == cpu and e.name in spans:
            routes[e.name] = routes.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return kernels, busy_us / 1e3, routes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fp32", action="store_true", help="profile parity mode instead of the bf16 default")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_serving_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.sed import score_sed_serving

    card = cs.card_line()
    inputs = cs.make_inputs(args.seed)
    runner = BelugaRunner(load_params_npz(cs.WORK / "beluga.npz"), batch_size=cs.BATCH, device="cuda",
                          compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
                          out_dtype=np.float32 if args.fp32 else np.float16)
    for name in ROUTES:
        orig = getattr(runner, name)

        def spanned(*a, _orig=orig, _name=name, **kw):
            with record_function(f"route::{_name}"):
                return _orig(*a, **kw)

        setattr(runner, name, spanned)

    genome = FastaIndex(cs.WORK / "genome.fa")
    vcf = standardize_chroms(read_vcf(cs.WORK / "variants.vcf"))
    gene = load_closest_genes(cs.WORK / "genes.tsv")
    ml = load_modellist(cs.WORK / "modellist")

    def serve():
        with record_function("score_sed_serving"):
            score_sed_serving(vcf, gene, genome, runner, ml.iloc[:, 0].tolist(), maxshift=cs.MAXSHIFT,
                              model_names=ml.iloc[:, 1].tolist())
        torch.cuda.synchronize()

    try:
        serve()  # warm-up: kernel load, allocator, cuBLAS handles
        t0 = time.perf_counter()
        serve()
        wall_off = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve()
            wall = time.perf_counter() - t0
    finally:
        genome.close()

    kernels, busy_ms, routes = device_summary(prof, {"score_sed_serving", *(f"route::{r}" for r in ROUTES)})
    result = {
        "card": card, "dtype": "fp32" if args.fp32 else "bf16", "wall_s": wall, "wall_unprofiled_s": wall_off, "rows": inputs["n_rows"], "variants": len(inputs["variants"]),
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / (wall * 1e3),
        "host_ms_by_span": routes, "kernels": kernels[:25],
    }
    print(f"card: {card}; {result['dtype']} compute")
    print(f"serving call: {wall_off:.3f} s unprofiled, {wall:.3f} s profiled, for {inputs['n_rows']} rows; device busy {busy_ms:.1f} ms "
          f"({100 * result['device_busy_share']:.1f}% of wall), idle {100 * (1 - result['device_busy_share']):.1f}%")
    for name, ms in sorted(routes.items(), key=lambda kv: -kv[1]):
        print(f"  host span {name}: {ms:.1f} ms")
    for k in kernels[:25]:
        print(f"  device {k['device_ms']:9.2f} ms {100 * k['device_ms'] / max(busy_ms, 1e-9):5.1f}%  "
              f"x{k['calls']:<5d} {k['name'][:110]}")
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        name = "profile_serving_fp32.json" if args.fp32 else "profile_serving.json"
        (Path(args.out) / name).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
