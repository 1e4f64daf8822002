#!/usr/bin/env python3
"""Where the time of the port's GEUVADIS consensus step goes, on one NVIDIA GPU.

    python3 scripts/profile_consensus_torch.py [--out DIR] [--seed N]

Builds chip_smoke.py's full-width Beluga weights and its four bench cohort
mixes (one gene's cohort each) and runs each through the CLI's device path
(``samples --fp16_chromatin``: ``_predict_consensus_preds``; ``samples
--features_only``: ``_predict_consensus_features_cohort``) in fp32 and bf16
at the CLI's batch 1,024, the sparse mix also at 3,200: once to warm up,
once timed, once under ``torch.profiler`` with a span around each engine
method, the conv stacks (``conv6_phases``), the patch
(``conv6_phases_patch_sites``, its splice ``_splice_patch_frames``), fc1
(``fc1_pre_from_phases``) and the host's span encoding and patch planning.
Prints per cell the wall time (unprofiled and profiled), sample-genes/s, the
device's busy and idle shares, device time per kernel name, host time per
span and, per span, its device range (first kernel's start to last kernel's
end) split into the kernel time inside it, by kernel name, and the idle gaps
between those kernels; fc1's rate is its flops over the kernel time inside its
range. ``--out DIR`` writes them to ``DIR/profile_consensus.json``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ENGINES = ("predict_codes", "predict_span_codes", "predict_spans_project", "project_spans_backbone_patch")
SPANS = ENGINES + ("conv6_phases", "conv6_phases_patch_sites", "_splice_patch_frames", "fc1_pre_from_phases",
                   "_encode_record_spans", "conv6_patch_sites_plan", "_predict_window_dedup_spans")
FC1_FLOP_PER_WINDOW = 2 * 67_840 * 2_003


def kernels_in_ranges(prof, spans) -> dict[str, dict]:
    """{span: {"range_ms", "kernel_ms", "gap_ms", "by_kernel": {name: ms}}}
    from the device-side annotation ranges of each span in ``spans``. One
    stream runs the work in launch order, so the kernels (and copies) that
    lie inside a span's range are the ones it launched; the rest of the range
    is the card idling between them, waiting for the host."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == cuda and e.name not in spans)
    starts = [d[0] for d in dev]
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == cuda and e.name in spans:
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    out = {}
    for name, ivs in ranges.items():
        merged = []  # union, so nested or repeated ranges count once
        for a, b in sorted(ivs):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        by_kernel: dict[str, float] = {}
        for a, b in merged:
            for s, e, kname in dev[max(0, bisect.bisect_left(starts, a) - 1):bisect.bisect_right(starts, b)]:
                overlap = min(e, b) - max(s, a)
                if overlap > 0:
                    by_kernel[kname] = by_kernel.get(kname, 0.0) + overlap / 1e3
        range_ms = sum(b - a for a, b in merged) / 1e3
        kernel_ms = sum(by_kernel.values())
        out[name] = {"range_ms": range_ms, "kernel_ms": kernel_ms, "gap_ms": range_ms - kernel_ms,
                     "by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_consensus_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke as cs
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.ops import spans as ops_spans
    from expecto_tpu_torch.parallel import runner as runner_mod
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline import consensus
    from profile_serving_torch import device_summary

    def spanned(fn, name):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    card = cs.card_line()
    cs.make_inputs(args.seed)
    params = load_params_npz(cs.WORK / "beluga.npz")
    # each function as its callers look it up: the spans module's own
    # globals, the runner module's imported names, the consensus module's
    patched = [(ops_spans, "conv6_phases"), (ops_spans, "_splice_patch_frames"), (ops_spans, "fc1_pre_from_phases"),
               (runner_mod, "conv6_phases"), (runner_mod, "conv6_phases_patch_sites"),
               (consensus, "_encode_record_spans"), (consensus, "conv6_patch_sites_plan"),
               (consensus, "_predict_window_dedup_spans")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in patched]
    for mod, name, fn in originals:
        setattr(mod, name, spanned(fn, name))
    results = {}
    try:
        for name, n, private, n_sites, path, _engine in cs.CONS_MIXES:
            seqs = cs.consensus_cohort(args.seed, n, private=private, n_sites=n_sites)
            batches = (cs.CONS_BATCH, cs.CONS_BATCH_WIDE) if n_sites == 4 else (cs.CONS_BATCH,)
            for tag in ("fp32", "bf16"):
                for batch in batches:
                    runner = BelugaRunner(params, batch_size=batch, device="cuda",
                                          compute_dtype=torch.float32 if tag == "fp32" else torch.bfloat16,
                                          out_dtype=np.float16 if path == "preds" else np.float32)
                    spy = cs._EngineSpy(runner)
                    for method in ENGINES:
                        setattr(runner, method, spanned(getattr(runner, method), method))

                    def run():
                        out = cs._consensus_call(runner, seqs, path)
                        torch.cuda.synchronize()
                        return out

                    run()  # warm-up: kernel load, weight packing, allocator, cuBLAS handles
                    t0 = time.perf_counter()
                    run()
                    wall_off = time.perf_counter() - t0
                    spy.calls.clear()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        run()
                        wall = time.perf_counter() - t0
                    kernels, busy_ms, host = device_summary(prof, set(SPANS))
                    annotated = kernels_in_ranges(prof, set(SPANS))
                    # windows through fc1_pre_from_phases: 200 a span, both orientations
                    fc1_windows = 2 * 200 * sum(rows for m, rows, _k in spy.calls if m != "predict_codes")
                    fc1_ms = annotated.get("fc1_pre_from_phases", {}).get("kernel_ms", 0.0)
                    key = f"{name} {tag} batch {batch}"
                    r = {"mix": name, "dtype": tag, "batch": batch, "records": n, "wall_s": wall,
                         "wall_unprofiled_s": wall_off, "sample_genes_per_s": n / wall_off,
                         "device_busy_ms": busy_ms, "device_busy_share": busy_ms / (wall * 1e3),
                         "device_by_span": annotated, "host_ms_by_span": host, "engine_calls": spy.calls,
                         "fc1_tflops": fc1_windows * FC1_FLOP_PER_WINDOW / (fc1_ms * 1e9) if fc1_ms else None,
                         "kernels": kernels[:12]}
                    results[key] = r
                    print(f"card: {card}; {key}: {wall_off:.3f} s unprofiled ({n / wall_off:.2f} sample-genes/s), "
                          f"{wall:.3f} s profiled; device busy {busy_ms:.1f} ms, idle "
                          f"{100 * (1 - r['device_busy_share']):.1f}%; engine {spy.calls[:3]}; fc1 "
                          + (f"{r['fc1_tflops']:.1f} TFLOP/s" if r["fc1_tflops"] else "not on this path"))
                    for sname, ms in sorted(host.items(), key=lambda kv: -kv[1]):
                        print(f"  host span {sname}: {ms:.1f} ms")
                    for sname, d in sorted(annotated.items(), key=lambda kv: -kv[1]["kernel_ms"]):
                        top = ", ".join(f"{k[:48]} {ms:.2f}" for k, ms in list(d["by_kernel"].items())[:4])
                        print(f"  span {sname}: kernels {d['kernel_ms']:.2f} ms "
                              f"({100 * d['kernel_ms'] / max(busy_ms, 1e-9):.1f}% of busy) in a device range of "
                              f"{d['range_ms']:.2f} ms (gaps {d['gap_ms']:.2f}); host {host.get(sname, 0.0):.1f} ms; "
                              f"top: {top}")
                    for k in kernels[:12]:
                        print(f"  device {k['device_ms']:9.2f} ms {100 * k['device_ms'] / max(busy_ms, 1e-9):5.1f}%  "
                              f"x{k['calls']:<5d} {k['name'][:110]}")
                    del runner
                    torch.cuda.empty_cache()
            del seqs
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "profile_consensus.json").write_text(json.dumps({"card": card, **results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
