#!/usr/bin/env python3
"""Where the time of the port's h5-contract chromatin step goes, on one
NVIDIA GPU.

    python3 scripts/profile_chromatin_torch.py [--out DIR] [--seed N] [--dtype fp32|bf16|both]

Builds chip_smoke.py's seeded main-path inputs (full Beluga widths, maxshift
800, ~1,156 variants) and runs the chromatin CLI's streaming step
(``chip_smoke._chromatin_streaming``: ``stream_span_rows`` with numpy arrays
in place of the h5 datasets) with the CLI's settings (batch 1,024; fp32
compute and wire, or ``--bf16``'s bf16 compute and fp16 wire): once to warm
up, once timed, once under ``torch.profiler`` with a span around the span
assembly, the pair-diff forward (``predict_span_pairs_diff``), each chunk's
forward and fetch inside it (``pair_diff_wire``; the rest of the pair-diff
span is the host's fp32 cast and the sink's row writes) and the per-window
fallback (``predict_codes``). Prints per dtype the wall time (unprofiled and
profiled), variants/s, the device's busy and idle shares, device time per
kernel name and host time per span; ``--out DIR`` writes them to
``DIR/profile_chromatin.json``. The rows go to numpy arrays, not h5 files,
so the script needs no h5py and h5 write time is not in it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SPANS = ("assemble_variant_spans", "predict_span_pairs_diff", "pair_diff_wire", "predict_codes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("fp32", "bf16", "both"), default="both")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_chromatin_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke as cs
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline import chromatin
    from profile_serving_torch import device_summary

    card = cs.card_line()
    inputs = cs.make_inputs(args.seed)
    params = load_params_npz(cs.WORK / "beluga.npz")
    genome = FastaIndex(cs.WORK / "genome.fa")
    vcf = standardize_chroms(read_vcf(cs.WORK / "variants.vcf"))
    n = len(vcf)
    orig_assemble = chromatin.assemble_variant_spans

    def assemble(*a, **kw):
        with record_function("assemble_variant_spans"):
            return orig_assemble(*a, **kw)

    chromatin.assemble_variant_spans = assemble
    results = {}
    try:
        for tag in ("fp32", "bf16") if args.dtype == "both" else (args.dtype,):
            runner = BelugaRunner(params, batch_size=cs.H5_BATCH, device="cuda",
                                  compute_dtype=torch.float32 if tag == "fp32" else torch.bfloat16,
                                  out_dtype=np.float32 if tag == "fp32" else np.float16)
            for name in ("predict_span_pairs_diff", "predict_codes", "_pair_diff_wire"):
                orig = getattr(runner, name)
                span = name.lstrip("_")

                def spanned(*a, _orig=orig, _span=span, **kw):
                    with record_function(_span):
                        return _orig(*a, **kw)

                setattr(runner, name, spanned)

            def run():
                res = cs._chromatin_streaming(runner, vcf, genome)
                torch.cuda.synchronize()
                return res

            run()  # warm-up: kernel load, allocator, cuBLAS handles
            t0 = time.perf_counter()
            run()
            wall_off = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                wall = time.perf_counter() - t0
            kernels, busy_ms, spans = device_summary(prof, set(SPANS))
            r = {"dtype": tag, "variants": n, "wall_s": wall, "wall_unprofiled_s": wall_off,
                 "variants_per_s": n / wall_off, "device_busy_ms": busy_ms,
                 "device_busy_share": busy_ms / (wall * 1e3), "host_ms_by_span": spans, "kernels": kernels[:25]}
            results[tag] = r
            print(f"card: {card}; {tag} compute, {n} variants ({len(inputs['variants'])} in the VCF)")
            print(f"chromatin call: {wall_off:.3f} s unprofiled ({n / wall_off:.1f} variants/s), {wall:.3f} s "
                  f"profiled; device busy {busy_ms:.1f} ms ({100 * r['device_busy_share']:.1f}% of wall), idle "
                  f"{100 * (1 - r['device_busy_share']):.1f}%")
            for name, ms in sorted(spans.items(), key=lambda kv: -kv[1]):
                print(f"  host span {name}: {ms:.1f} ms")
            for k in kernels[:25]:
                print(f"  device {k['device_ms']:9.2f} ms {100 * k['device_ms'] / max(busy_ms, 1e-9):5.1f}%  "
                      f"x{k['calls']:<5d} {k['name'][:110]}")
            del runner
            torch.cuda.empty_cache()
    finally:
        genome.close()
        chromatin.assemble_variant_spans = orig_assemble
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "profile_chromatin.json").write_text(json.dumps({"card": card, **results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
