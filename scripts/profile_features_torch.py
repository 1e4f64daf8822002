#!/usr/bin/env python3
"""Where the time of the port's gene-feature step goes, on one NVIDIA GPU.

    python3 scripts/profile_features_torch.py [--out DIR] [--seed N] [--dtype fp32|bf16|both]

Builds chip_smoke.py's seeded genome, full-width Beluga weights and 96 genes
(48 a strand, three near a contig end) and runs ``compute_gene_features``
with the compute_features CLI's settings (batch 3,200: chunks of 16 spans of
41,800 bp; fp32 compute and wire, or ``--bf16``'s bf16 compute and fp16
wire): once to warm up, once timed, once under ``torch.profiler`` with a
span around each ``predict_spans_project`` call, each chunk's conv stack
(``conv6_phases``), its fc1 (``fc1_pre_from_phases``) and the gene span
fetch (``gene_span_and_offsets``). Prints per dtype the wall time
(unprofiled and profiled), genes/s, the device's busy and idle shares,
device time per kernel name and host time per span; ``--out DIR`` writes
them to ``DIR/profile_features.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SPANS = ("predict_spans_project", "conv6_phases", "fc1_pre_from_phases", "gene_span_and_offsets")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("fp32", "bf16", "both"), default="both")
    args = ap.parse_args(argv)

    import numpy as np
    import pandas as pd
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_features_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke as cs
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.ops import spans as ops_spans
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline import features
    from profile_serving_torch import device_summary

    def spanned(fn, name):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    card = cs.card_line()
    cs.make_inputs(args.seed)
    cs.make_gene_inputs(args.seed)
    genes = features.records_from_geneanno(pd.read_csv(cs.WORK / "geneanno.csv"))
    params = load_params_npz(cs.WORK / "beluga.npz")
    genome = FastaIndex(cs.WORK / "genome.fa")
    # the span forward's two halves, as the runner module calls them, and
    # the host's span fetch, as the features module calls it
    patched = [(ops_spans, "conv6_phases"), (ops_spans, "fc1_pre_from_phases"), (features, "gene_span_and_offsets")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in patched]
    for mod, name, fn in originals:
        setattr(mod, name, spanned(fn, name))
    results = {}
    try:
        for tag in ("fp32", "bf16") if args.dtype == "both" else (args.dtype,):
            runner = BelugaRunner(params, batch_size=cs.GENE_BATCH, device="cuda",
                                  compute_dtype=torch.float32 if tag == "fp32" else torch.bfloat16,
                                  out_dtype=np.float32 if tag == "fp32" else np.float16)
            runner.predict_spans_project = spanned(runner.predict_spans_project, "predict_spans_project")

            def run():
                f = features.compute_gene_features(genes, genome, runner)
                torch.cuda.synchronize()
                return f

            run()  # warm-up: kernel load, weight packing, allocator, cuBLAS handles
            t0 = time.perf_counter()
            run()
            wall_off = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                wall = time.perf_counter() - t0
            kernels, busy_ms, spans = device_summary(prof, set(SPANS))
            # the spans' device-side annotation ranges: device time of the
            # work launched inside each span
            annotated = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA and e.name in SPANS:
                    annotated[e.name] = annotated.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            r = {"dtype": tag, "genes": len(genes), "wall_s": wall, "wall_unprofiled_s": wall_off,
                 "genes_per_s": len(genes) / wall_off, "device_busy_ms": busy_ms,
                 "device_busy_share": busy_ms / (wall * 1e3), "device_ms_by_span": annotated,
                 "host_ms_by_span": spans, "kernels": kernels[:25]}
            results[tag] = r
            print(f"card: {card}; {tag} compute, {len(genes)} genes, batch {cs.GENE_BATCH}")
            print(f"gene features call: {wall_off:.3f} s unprofiled ({len(genes) / wall_off:.2f} genes/s), {wall:.3f} s "
                  f"profiled; device busy {busy_ms:.1f} ms ({100 * r['device_busy_share']:.1f}% of wall), idle "
                  f"{100 * (1 - r['device_busy_share']):.1f}%")
            for name, ms in sorted(spans.items(), key=lambda kv: -kv[1]):
                print(f"  host span {name}: {ms:.1f} ms")
            for name, ms in sorted(annotated.items(), key=lambda kv: -kv[1]):
                print(f"  device range {name}: {ms:.1f} ms ({100 * ms / max(busy_ms, 1e-9):.1f}% of busy)")
            for k in kernels[:25]:
                print(f"  device {k['device_ms']:9.2f} ms {100 * k['device_ms'] / max(busy_ms, 1e-9):5.1f}%  "
                      f"x{k['calls']:<5d} {k['name'][:110]}")
            del runner
            torch.cuda.empty_cache()
    finally:
        genome.close()
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "profile_features.json").write_text(json.dumps({"card": card, **results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
