#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (expecto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Phases (any failure raises, and the script exits non-zero with no result):

1. card: name and power limit as nvidia-smi reports them;
2. build: nvcc compiles every kernel of ``expecto_tpu_torch/csrc`` for
   sm_90a, one process per source, all at once (ptxas registers and spills
   printed); the tensor-core kernel's SASS must hold HGMMA instructions, and
   the SIMT kernel's FFMA and no HMMA or HGMMA (``cuobjdump -sass``; its
   FFMA-to-LDS ratio is printed);
3. kernels, at every shape they run in one substitution chunk of the main
   path (227 variants; maxshift 800: the six Beluga layers over the 3,600-bp
   span and over the alt allele's patch sub-span), each held against its
   plain PyTorch version on the same inputs and timed beside it and cuDNN's
   ``F.conv1d`` (a yardstick only: the port never calls it):
   ``conv8_relu`` at conv1-conv5, fp32 on the SIMT kernel (with each
   shape's share of its fp32 bound) and bf16 on the tensor-core kernel and
   on the SIMT kernel; ``conv0_codes_relu`` at conv0, fp32 and bf16 on the
   code-gather kernel, beside the SIMT kernel on the float one-hot; then
   each dtype's chunk total beside ``F.conv1d`` (TF32 off) and the bound;
   then every conv of the h5 path's pair chunks (112 spans, and the 64 of
   the last chunk: conv0-conv5 over the span, both strands) on each dtype's
   route, held against the plain version and timed;
4. main path: ``python -m expecto_tpu_torch.cli.score`` (its ``main``) at
   Beluga's published widths with seeded random weights, 218 seeded tissue
   models, maxshift 800, default bf16 compute and fp16 wire, on ~1,024
   substitutions, ~128 indels and 4 contig-edge rows of a seeded genome;
   launch counts are zeroed just before and read just after (every conv0 on
   the code-gather kernel, conv1-conv5 on the tensor-core kernel, no SIMT
   launch and no conv8_relu launch at Cin 4, the counts adding up); then
   warm repeats of the same serving call give the throughput;
5. fp32 serve: the same serving call with ``--fp32``'s settings on the first
   256 substitutions and their genes, warm (one call first), its launch
   counts checked (conv1-conv5 on the SIMT kernel, conv0 on the code-gather
   kernel in fp32): the end-to-end throughput of parity mode;
6. parity: a few of those variants scored with ``--fp32`` on the card and on
   the CPU (plain path), REF/ALT/SED compared; the card run's counts are
   zeroed just before it and read just after (conv1-conv5 on the SIMT
   kernel, conv0 on the code-gather kernel in fp32);
7. h5 contract (``expecto-chromatin`` -> ``expecto-predict``) on all the
   main path's variants with the chromatin CLI's settings (batch 1,024; fp32
   compute and wire by default, then ``--bf16``'s bf16 compute and fp16
   wire): per dtype one in-memory call (``keep_arrays``, also the warm-up),
   then one timed call of the CLI's streaming path (the runner's sink
   writing each pair chunk into numpy arrays that stand in for the h5
   datasets, then the window rows), launch counts zeroed just before it and
   read just after (fp32: conv1-conv5 on the SIMT kernel; bf16: on the tc
   kernel, no SIMT launch; totals equal to the chunk arithmetic); the
   streamed arrays equal to the in-memory ones bit for bit, alt = ref + diff
   exactly, the bf16 effects within a stated limit of the fp32 ones (which
   the same comparison with the strands swapped or the rows shifted
   exceeds); the fp32 effects scored by ``score_sed`` (model 0) and
   ``score_sed_multimodel`` (218 models); fp32 card vs CPU effects on a
   substitution, an insertion, a deletion and a contig-edge row;
   ``sed.tsv``'s REF/ALT/SED against ``expecto-score --fp32``'s
   ``output.csv`` row by row, and each ``--modelList`` column against minus
   its SED column. The effects are averaged as ``load_shift_effects``
   averages a file's halves, so this script needs no h5py; the h5 files
   themselves are written and read by the CPU tests
   (tests/test_torch_chromatin.py, tests/test_torch_predict.py);
8. gene features (``expecto-compute-features``) on 96 seeded genes, 48 a
   strand, three near a contig end (N-padded spans; the plus strand's
   group ships 4 bits a base, the minus strand's 2 bits and an N sideband):
   first every conv of one gene chunk (16 spans of 41,800 bp, both
   orientations, 16 launches) on each dtype's route, held against the plain
   version and timed beside it, ``F.conv1d`` and the bound (in the kernel
   phase); then ``python -m expecto_tpu_torch.cli.compute_features`` (its
   ``main``, weights loaded) in fp32 and with ``--bf16``, and three warm
   timed ``compute_gene_features`` calls with the CLI's settings in each
   dtype, launch counts zeroed just before each and checked just after (fp32: SIMT
   only; bf16: tc only; 16 launches a chunk, every conv0 on the code-gather
   kernel); fp32 card vs CPU features on one gene a strand, the span path
   vs the per-window path (``predict_and_project``) and ``--replicate_raw``'s
   matrices projected on the host vs the features, within 1e-5 of
   max|feature|; the bf16 features per feature within fp16's step of the
   bf16 predictions projected in fp64 on the host, a limit that a projection
   contracted in bf16 and the forward half alone both exceed; bf16 vs fp32
   features per gene within a stated limit that the same comparison with
   the gene rows shifted by one exceeds;
9. GEUVADIS consensus (``expecto-consensus``) on bench.py's four cohort
   mixes (generator copied, seeded from ``--seed``; 445 records with 42
   shared sites, 64 with 42 private sites twice, 64 with 4 private sites;
   393,216 bp each, 200 shifts): first every conv shape of the engines on
   each dtype's route against the plain version (the backbone forward at
   N = 1, the patch batches of 704-base sub-spans at K = 8, 16, 24 with 5
   and 16 samples a chunk, timed beside the plain version, ``F.conv1d``
   and the bound; the dedup engine's window batch and a fallback chunk);
   then per mix and dtype three warm timed calls at the CLI's batch 1,024
   (the sparse mix also at 3,200), each call's engine (the runner methods
   it called) and launch counts checked; a '-' strand check cohort (K
   buckets 8, 16 and 24, a backbone copy, a duplicate, an indel-shifted
   record that falls back): fp32 patch vs span and card vs CPU within
   1e-5 of max|feature|, a smoke test of the expression wiring, two
   patch-engine calls equal bit for bit, the splice planted one frame late
   (it must exceed the limits), bf16 vs fp32 per record; the dedup
   engine's tracks vs the span path's; patch vs span on the same records
   at K = 8, 16, 24, 48; the conv1-reusing ``_c1`` patch vs the raw one;
   ``python -m expecto_tpu_torch.cli.consensus ref`` (its ``main``) in
   fp32 and ``--bf16``, its CSV equal to the in-process call;
10. gblinear training (``expecto-train``) at the published width: a
   seeded gene table of 24,338 genes (about 22,000 train genes, 900 on
   chr8, rRNA genes and NaN labels), 24,338 x 20,020 fp32 features and 218
   tissues, the reference's hyperparameters, 100 rounds of 40 feature
   blocks: the coordinate-update kernel against its plain version bit for
   bit at (512, 1), (512, 128) and (512, 218) (padded rows, the 1e-5
   guard, L1, ties), timed beside it and its bound; one tissue with its
   watchlist (``train_expression_model``), equal bit for bit to a second
   run and to the same trainer with the plain version swapped in; all 218
   tissues in one sweep (``train_all_tissues``); 128 bootstrap seeds through
   ``python -m expecto_tpu_torch.cli.train`` (its ``main``), each seed's
   ``.save`` equal to the in-process sweep. Each call's launches are
   zeroed just before it and checked just after (40 a round), and each is
   profiled once for its time a round, the block sweep's kernels and the
   card's idle share. Then the card against the CPU on 2,048 rows, 8
   tissues and 20 rounds with an L1 weight, within 1e-5 of max|w|, which
   one round fewer and alpha's sign swapped must exceed. The single-tissue
   CLI mode (plots) and ``--allTissues`` (``metrics.h5``) run on the CPU
   tests only.

The line before the last is the card's name and power limit; the line before
that is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--out DIR`` also writes the full report
to ``DIR/chip_smoke.json``. Inputs and built kernels go under ``build/``.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

MAXSHIFT = 800
SPAN_LEN = 2 * MAXSHIFT + 2000
BATCH = 2048  # the score CLI's default --batchsize
CHUNK = BATCH // 9  # spans per substitution chunk at 9 shift offsets
N_MODELS = 218
N_SUBS, N_INDELS = 1024, 128
N_FP32_SERVE = 256  # substitutions in the fp32 serve
CONTIG_LEN = 300_000
DEVICE = "cuda"

# kernel tolerances against the plain version on identical inputs:
#  fp32: both sum up to 5,120 fp32 products in different orders (TF32 off)
#  bf16: the kernel reads the same bf16 values and sums in fp32, then rounds
#        its output to bf16 (relative step 2^-8); the plain reference is the
#        fp32 plain version on those bf16 values upcast
#  conv0 over codes, fp32: 8 table entries and the bias in another order
FP32_ATOL, FP32_RTOL = 1e-4, 1e-4
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2
CONV0_FP32_TOL = 1e-5

# fp32 end-to-end parity, card vs CPU: REF/ALT rtol 1e-4; SED differences two
# separately rounded 20,020-term fp32 products, so its absolute noise scales
# with |REF| (tests/torch_port_common.sed_atol)
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5

# h5 contract: the chromatin CLI's default batch, its pair chunks (variants
# a chunk, as runner._pair_rows at 9 offsets) and the spans a chunk's conv
# batch holds (ref and alt of each pair), full and last: every variant but
# the 4 contig-edge rows takes the span path
H5_BATCH = 1024
H5_PAIRS = H5_BATCH // 9 // 2
H5_SPAN_VARIANTS = N_SUBS + N_INDELS
H5_CHUNK_N = tuple(n for n in (2 * H5_PAIRS, 2 * (H5_SPAN_VARIANTS % H5_PAIRS)) if n)
# fp32 effects card vs CPU (track probabilities: REF/ALT rtol 1e-4 atol 1e-5,
# diff atol 1e-5); sed.tsv against the fused scorer: the JAX package's own
# tolerances (tests/test_spans.py: SED rtol 1e-3, REF rtol 1e-4 atol 1e-4),
# SED's atol raised from 1e-5 to 1e-5 * max|REF| because the noise of the two
# separately rounded 20,020-term products scales with |REF| at full width
H5_RTOL, H5_ATOL, H5_DIFF_ATOL = 1e-4, 1e-5, 1e-5
SED_RTOL, REF_RTOL, REF_ATOL = 1e-3, 1e-4, 1e-4
# bf16 vs fp32 h5 effects, per strand and shift: bf16 activations carry about
# 3 significant digits, so sound runs differ by about 1e-2 at most (the
# fwd/RC-averaged maxima at full width were 8.85e-3 and 1.05e-2; one strand's
# may be up to twice that); the same comparison with the bf16 strand halves
# swapped, or its variant rows shifted by one, must exceed the limit, so the
# limit separates a sound run from one whose rows landed in the wrong place
H5_BF16_GAP = 5e-2

# gene features (cli.compute_features): the CLI's batch 3,200 at 200 shifts
# is a chunk of 16 gene spans of 41,800 bp; 48 genes a strand, so each
# strand group is 3 full chunks
GENE_BATCH = 3200
GENE_SHIFTS = 200
GENE_ROWS = GENE_BATCH // GENE_SHIFTS
GENE_SPAN = 41_800
N_GENES_PER_STRAND = 48
GENE_REPEATS = 3  # timed calls a dtype, each launch-checked; the median is reported
# fp32 features card vs CPU, span path vs per-window path, replicate's raw
# matrices projected on the host vs the features: sums of up to 200 weighted
# fp32 track probabilities (sums of 2,003-term products), summed in other
# orders, so the limit scales with the features as sed_atol does with |REF|:
# 1e-5 * max|feature|
GENE_FEAT_RTOL = 1e-5
# bf16 compute (fp16 wire) vs fp32 features, per gene row, over max|fp32
# feature|: bf16 activations carry about 3 significant digits, and the
# features sum 200 windows' fwd/RC averages, so sound runs differ by about
# 5e-3 (5.2e-3 at full width on these genes, NVIDIA H100 80GB HBM3, 700 W);
# the same comparison with the bf16 gene rows shifted by one exceeds the
# limit on every row (it measured 1.17e-2 at least), so the limit separates
# a sound run from one whose rows landed on the wrong gene
GENE_BF16_GAP = 8e-3
# the bf16 path's projection and wire, per feature, against the same bf16
# network's fwd and RC predictions (fetched in fp32) averaged and projected
# in fp64 on the host: |feature - want| / max(|want|, 2^-14). The fp16 wire
# rounds a feature to within 2^-11 = 4.88e-4 of itself (and to within 2^-25
# below fp16's smallest normal 2^-14, hence the floor), and fp32 sums of 200
# positive terms are within 200 * 2^-24 = 1.2e-5 of fp64's, so a sound run
# reads at most 5.0e-4. Two faults that only the bf16 path can have must
# exceed the limit: the projection contracted in bf16 (weights, predictions
# and sums rounded at 2^-9), and the fwd/RC average dropped to the forward half
GENE_WIRE_RTOL = 6e-4

# GEUVADIS consensus (cli.consensus): bench.py's four cohort mixes, each one
# gene's cohort of 393,216-bp records (TSS at len // 2) over the 200 gene
# shifts, at the CLI's default batch 1,024 (5 spans a chunk): (bench.py
# name, records, private sites?, sites, path, the engine it must take)
CONS_BATCH = 1024
CONS_BATCH_WIDE = 3200  # the sparse mix again at 16 spans a chunk
CONS_MIXES = (
    ("consensus_sample_genes_per_sec", 445, False, 42, "preds", "predict_codes"),
    ("consensus_private_sample_genes_per_sec", 64, True, 42, "preds", "predict_span_codes"),
    ("consensus_private_featonly_sample_genes_per_sec", 64, True, 42, "features", "predict_spans_project"),
    ("consensus_sparse_private_featonly_sample_genes_per_sec", 64, True, 4, "features",
     "project_spans_backbone_patch"),
)
CONS_REPEATS = 3  # timed calls a mix and dtype, each launch-checked; the median is reported
CONS_SPAN = 41_808  # the features path's span: 41,800 bp extended to a multiple of 16
CONS_PATCH_SHAPES = ((5, 8), (5, 16), (5, 24), (16, 8), (16, 16), (16, 24))  # (samples a chunk, K)
CONS_SWEEP_K = (8, 16, 24, 48)  # patch vs span on 16 records with K ranges each (48: max_ranges=48)
CONS_SWEEP_ROWS = 16
CONS_REF_GENES = 4  # genes of the ref CLI run, two a strand
# fp32 features (patch vs span, card vs CPU): as GENE_FEAT_RTOL, 1e-5 of
# max|feature|; fp32 track probabilities (window dedup vs span path): 1e-5
CONS_FEAT_RTOL = 1e-5
CONS_PRED_ATOL = 1e-5
# bf16 compute vs fp32 features, per record, over max|fp32 feature|: the
# gene path's limit (GENE_BF16_GAP; sound runs read 4.3-5.2e-3 there and
# 5.1e-3 here). The bf16 patch with its frames spliced one frame late must
# exceed it on some patched record; it cannot on every one, since a few
# private sites move a record's features by about bf16's own noise (the late
# splice read 6.9e-3 at least, on an H100 80GB HBM3 at 700 W), so the fp32
# checks at 1e-5 of max|feature| carry the patch's contract
CONS_BF16_GAP = GENE_BF16_GAP


# gblinear training (cli.train) at the published width: 24,338 genes of
# 2,002 tracks x 10 decay bases, 218 tissues, the reference's hyperparameters
# (eta 0.01, lambda 100, base_score 2) and 100 rounds; seeded features (the
# real Xreducedall.2002.npy is not in the repository)
TRAIN_GENES = 24_338
TRAIN_FEATURES = 20_020
TRAIN_TISSUES = 218
TRAIN_ROUNDS = 100
TRAIN_BOOT_SEEDS = 128
TRAIN_CD_SHAPES = ((512, 1), (512, 128), (512, 218))  # (block, models) of the coordinate-update kernel
# genes a chromosome: chr8 is the test split; chrX/chrY (and chr7 for the
# all-tissue sweep) are held out of training; the rest are spread over the
# other autosomes
TRAIN_CHROMS = {"chr8": 900, "chrX": 820, "chrY": 60, "chr7": 1_100}
# card vs CPU on a reduced problem: rows, models, rounds, and an L1 weight
# large enough that swapping its sign moves the weights; fp32 products
# summed in other orders, held within 1e-5 of max|w| (the JAX package's own
# limit between its trainers, tests/test_gblinear.py:256, is 1e-5 at
# weights of about 1)
TRAIN_SMALL_ROWS, TRAIN_SMALL_K, TRAIN_SMALL_ROUNDS, TRAIN_SMALL_ALPHA = 2_048, 8, 20, 20.0
TRAIN_CPU_RTOL = 1e-5
# a smoke test that the models learned the labels' signal: unrelated
# predictions of the 900 chr8 genes would read about 0 +- 0.03 (a model at
# a tenth of the width, trained on the CPU, read 0.37)
TRAIN_MIN_SPEARMAN = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_stack(span_len: int, phases) -> list[tuple[str, int]]:
    """(layer, input length) of each conv8_relu launch of
    ops/spans.conv6_phases over spans of ``span_len`` bases: conv0..conv3
    once, conv4/conv5 once per pool-2 phase."""
    launches, length = [], span_len
    for i in range(4):
        launches.append((f"conv{i}", length))
        length -= 7
        if i == 1:
            length //= 4  # pool1
    for ph in sorted(phases):
        l4 = (length - ph) // 4  # pool2 from this phase
        launches += [("conv4", l4), ("conv5", l4 - 7)]
    return launches


def chunk_launches() -> Counter:
    """{(layer, L): launches} of one substitution chunk of the main path
    (parallel/runner._preds_from_ref): the ref conv stack over the full
    span, forward and reverse complement, and the alt allele's patch
    sub-span (ops/spans.conv6_phases_patch), forward and reverse complement."""
    from expecto_tpu_torch.genome.windows import variant_shifts
    from expecto_tpu_torch.ops.spans import conv6_patch_ranges, conv6_patch_subspan

    offsets = [s + MAXSHIFT for s in variant_shifts(MAXSHIFT)]
    mutpos = MAXSHIFT + 999  # pipeline/sed.py: maxshift + inputsize // 2 - 1
    tally = Counter()
    for offs, mut in ((offsets, mutpos), ([2 * MAXSHIFT - o for o in offsets], SPAN_LEN - mutpos - 1)):
        phases = sorted({(o // 4) % 4 for o in offs})
        full = conv_stack(SPAN_LEN, phases)
        frames = dict(zip(phases, (length - 7 for name, length in full if name == "conv5")))
        s0, s1 = conv6_patch_subspan(conv6_patch_ranges(mut, 1, phases, frames), SPAN_LEN)
        tally.update(full + conv_stack(s1 - s0, phases))
    return tally


def h5_chunk_launches() -> Counter:
    """{(layer, L): launches} of one pair chunk of the h5 path
    (parallel/runner._span_preds_fwd_rc over ref and alt as one batch): the
    full conv stack over the span, forward and reverse complement."""
    from expecto_tpu_torch.genome.windows import variant_shifts

    offsets = [s + MAXSHIFT for s in variant_shifts(MAXSHIFT)]
    tally = Counter()
    for offs in (offsets, [2 * MAXSHIFT - o for o in offsets]):
        tally.update(conv_stack(SPAN_LEN, sorted({(o // 4) % 4 for o in offs})))
    return tally


def _bound(nbytes: float, ops: float, tag: str) -> dict:
    """The least time for moving ``nbytes`` and doing ``ops`` operations of
    type ``tag`` on the card: the larger of the two at its peak rates."""
    bytes_ms, ops_ms = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_FLOPS[tag]
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


def _check_close(got, want, atol: float, rtol: float, what: str) -> float:
    import torch

    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    max_err = float(err.max())
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what} disagrees with the plain version: max |err| {max_err}")
    return max_err


def kernel_phase(report: dict) -> None:
    """conv1-conv5 at every shape of a substitution chunk: fp32 on the SIMT
    kernel (the fp32 main path's route); bf16 on the tensor-core kernel (the
    bf16 main path's route) and on the SIMT kernel too, so the redesign
    shows shape by shape. Each launch is held against the fp32 plain version
    on the same inputs."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv8 import _route, conv8_relu, conv8_relu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {f"conv{i}": (cin, cout) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    rows, n = [], CHUNK
    for (name, length), per_chunk in sorted(chunk_launches().items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        if name == "conv0":  # on the code-gather kernel: conv0_phase
            continue
        cin, cout = specs[name]
        x32 = torch.randn((n, length, cin), generator=gen, device=dev)
        w32 = torch.randn((8, cin, cout), generator=gen, device=dev) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=dev) * 0.1
        l_out = length - 7
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "launches_per_chunk": per_chunk}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            want = conv8_relu_plain(x.float(), w.float(), b.float())
            atol, rtol = (FP32_ATOL, FP32_RTOL) if tag == "fp32" else (BF16_ATOL, BF16_RTOL)
            main_route = _route("cuda", dtype, cin, x.data_ptr())
            routes = [main_route] + (["simt"] if main_route != "simt" else [])
            xt = x.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).contiguous()  # (Cout, Cin, 8)
            nbytes = (x.numel() + w.numel() + b.numel() + n * l_out * cout) * x.element_size()
            cell = {"route": main_route, **_bound(nbytes, 2.0 * n * l_out * cin * cout * 8, tag),
                    "plain_ms": cuda_ms(lambda: conv8_relu_plain(x, w, b)),
                    "library_ms": cuda_ms(lambda: F.relu(F.conv1d(xt, wt, b)))}
            for route in routes:
                y = conv8_relu(x, w, b, route=route)
                max_err = _check_close(y, want, atol, rtol, f"conv8_relu {route} {tag} {name} L={length}")
                cell[route] = {"ms": cuda_ms(lambda r=route: conv8_relu(x, w, b, route=r)), "max_abs_err": max_err}
                del y
            cell["ms"], cell["max_abs_err"] = cell[main_route]["ms"], cell[main_route]["max_abs_err"]
            row[tag] = cell
            del x, w, b, xt, wt, want
        bf = row["bf16"]
        log(f"kernel conv8_relu {name} N={n} L={length} {cin}->{cout} x{per_chunk} per chunk: bf16 "
            f"tc {bf['tc']['ms']:.3f} ms (err {bf['tc']['max_abs_err']:.3g}) "
            f"simt {bf['simt']['ms']:.3f} ms (err {bf['simt']['max_abs_err']:.3g}) plain {bf['plain_ms']:.3f} ms "
            f"conv1d {bf['library_ms']:.3f} ms bound {bf['bound_ms']:.3f} ms ({bf['bound_by']}); fp32 simt "
            f"{row['fp32']['ms']:.3f} ms (err {row['fp32']['max_abs_err']:.3g}) plain {row['fp32']['plain_ms']:.3f} ms "
            f"conv1d {row['fp32']['library_ms']:.3f} ms bound {row['fp32']['bound_ms']:.3f} ms "
            f"({100 * row['fp32']['bound_ms'] / row['fp32']['ms']:.1f} % of it)")
        rows.append(row)
        torch.cuda.empty_cache()
    report["conv8_layers"] = rows


def _conv0_codes(n: int, length: int, gen):
    """(n, length) int8 codes: bases 0..3, ~2 % N (code 4), an N run, and
    ~0.2 % codes outside 0..4, which add nothing as N does."""
    import torch

    dev = gen.device
    codes = torch.randint(0, 4, (n, length), generator=gen, device=dev, dtype=torch.int8)
    codes[torch.rand((n, length), generator=gen, device=dev) < 0.02] = 4
    codes[:, length // 2 : length // 2 + 50] = 4
    codes[torch.rand((n, length), generator=gen, device=dev) < 0.002] = -1
    return codes


def conv0_phase(report: dict) -> None:
    """conv0 at each of its shapes in a substitution chunk (the span and the
    alt patch sub-span): the code-gather kernel in fp32 and bf16, held
    against the fp32 plain version on the same codes and weights, timed
    beside the plain version in the working dtype, PR 1's SIMT kernel on the
    float one-hot and ``F.conv1d`` on it (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu, conv0_codes_relu_plain, onehot_from_codes
    from expecto_tpu_torch.ops.conv8 import conv8_relu

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(1)
    _kw, cin, cout = CONV_SPECS[0]
    rows, n = [], CHUNK
    for (name, length), per_chunk in sorted(chunk_launches().items(), key=lambda kv: -kv[0][1]):
        if name != "conv0":
            continue
        codes = _conv0_codes(n, length, gen)
        w32 = torch.randn((8, cin, cout), generator=gen, device=gen.device) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=gen.device) * 0.1
        l_out = length - 7
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "launches_per_chunk": per_chunk}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            w, b = w32.to(dtype), b32.to(dtype)
            want = conv0_codes_relu_plain(codes, w.float(), b.float())
            atol = rtol = CONV0_FP32_TOL if tag == "fp32" else BF16_ATOL
            max_err = _check_close(conv0_codes_relu(codes, w, b), want, atol, rtol,
                                   f"conv0_codes_relu {tag} L={length}")
            del want
            x = onehot_from_codes(codes, dtype)
            xt = x.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).contiguous()  # (Cout, 4, 8)
            # codes read once, W and b once, the output written once; 8 adds an output
            nbytes = codes.numel() + (w.numel() + b.numel() + n * l_out * cout) * w.element_size()
            row[tag] = {"route": "codes", **_bound(nbytes, 8.0 * n * l_out * cout, "fp32"),
                        "ms": cuda_ms(lambda: conv0_codes_relu(codes, w, b)), "max_abs_err": max_err,
                        "plain_ms": cuda_ms(lambda: conv0_codes_relu_plain(codes, w, b)),
                        "library_ms": cuda_ms(lambda: F.relu(F.conv1d(xt, wt, b))),
                        "simt_onehot_ms": cuda_ms(lambda: conv8_relu(x, w, b, route="simt"))}
            del x, xt, wt
        log("kernel conv0_codes " + f"N={n} L={length} 4->{cout} x{per_chunk} per chunk: " + "; ".join(
            f"{t} {c['ms']:.4f} ms (err {c['max_abs_err']:.3g}) bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
            f"{100 * c['bound_ms'] / c['ms']:.1f} %) plain {c['plain_ms']:.3f} ms conv1d {c['library_ms']:.4f} ms "
            f"simt on the one-hot {c['simt_onehot_ms']:.4f} ms" for t, c in ((t, row[t]) for t in ("bf16", "fp32"))))
        rows.append(row)
        torch.cuda.empty_cache()
    report["conv0_layers"] = rows


def _chunk_conv_rows(n: int, launches: Counter, gen, what: str, yardsticks: bool) -> tuple[list, dict]:
    """Every conv of one chunk of ``n`` spans (``launches``: {(layer, L):
    launches a chunk}) on each dtype's route of the main path (conv0 on the
    code-gather kernel; conv1-conv5 on the SIMT kernel in fp32 and on the tc
    kernel in bf16), held against the fp32 plain version on the same inputs
    and timed; with ``yardsticks`` also the plain version in the working
    dtype, ``F.conv1d`` (TF32 off) and the bound. Returns the per-shape rows
    and {dtype: the chunk's launch-weighted kernel ms}."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu, conv0_codes_relu_plain, onehot_from_codes
    from expecto_tpu_torch.ops.conv8 import _route, conv8_relu, conv8_relu_plain

    torch.backends.cudnn.allow_tf32 = False
    rows, chunk_ms = [], {"fp32": 0.0, "bf16": 0.0}
    for (name, length), per_chunk in sorted(launches.items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        _kw, cin, cout = CONV_SPECS[int(name[4:])]
        if name == "conv0":
            x32 = _conv0_codes(n, length, gen)
        else:
            x32 = torch.randn((n, length, cin), generator=gen, device=gen.device)
        w32 = torch.randn((8, cin, cout), generator=gen, device=gen.device) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=gen.device) * 0.1
        l_out = length - 7
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "launches_per_chunk": per_chunk}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            w, b = w32.to(dtype), b32.to(dtype)
            if name == "conv0":
                x, route = x32, "codes"
                want = conv0_codes_relu_plain(x, w.float(), b.float())
                atol = rtol = CONV0_FP32_TOL if tag == "fp32" else BF16_ATOL
                launch = lambda: conv0_codes_relu(x, w, b)  # noqa: E731
                plain = lambda: conv0_codes_relu_plain(x, w, b)  # noqa: E731
                # codes read once, W and b once, the output written once; 8 adds an output
                nbytes = x.numel() + (w.numel() + b.numel() + n * l_out * cout) * w.element_size()
                bound = _bound(nbytes, 8.0 * n * l_out * cout, "fp32")
            else:
                x = x32.to(dtype)
                route = _route("cuda", dtype, cin, x.data_ptr())
                if route != ("simt" if tag == "fp32" else "tc"):
                    raise AssertionError(f"{what} {name} {tag} N={n} L={length} would take the {route} route")
                want = conv8_relu_plain(x.float(), w.float(), b.float())
                atol, rtol = (FP32_ATOL, FP32_RTOL) if tag == "fp32" else (BF16_ATOL, BF16_RTOL)
                launch = lambda: conv8_relu(x, w, b, route=route)  # noqa: E731
                plain = lambda: conv8_relu_plain(x, w, b)  # noqa: E731
                nbytes = (x.numel() + w.numel() + b.numel() + n * l_out * cout) * x.element_size()
                bound = _bound(nbytes, 2.0 * n * l_out * cin * cout * 8, tag)
            err = _check_close(launch(), want, atol, rtol, f"{what} {name} {route} {tag} N={n} L={length}")
            del want
            cell = {"route": route, "max_abs_err": err, "ms": cuda_ms(launch)}
            if yardsticks:
                xf = onehot_from_codes(x, dtype) if name == "conv0" else x
                xt = xf.transpose(1, 2).contiguous()
                wt = w.permute(2, 1, 0).contiguous()  # (Cout, Cin, 8)
                cell.update(bound, plain_ms=cuda_ms(plain), library_ms=cuda_ms(lambda: F.relu(F.conv1d(xt, wt, b))))
                del xf, xt, wt
            row[tag] = cell
            chunk_ms[tag] += per_chunk * cell["ms"]
            del x
        rows.append(row)
        torch.cuda.empty_cache()
    return rows, chunk_ms


def h5_kernel_phase(report: dict) -> None:
    """Every conv of the h5 path's pair chunks, the full chunk and the
    smaller last one (H5_CHUNK_N spans: conv0-conv5 over the full span,
    forward and reverse complement), on each dtype's route of the h5 runs
    (conv0 on the code-gather kernel; conv1-conv5 on the SIMT kernel in fp32
    and the tc kernel in bf16), held against the fp32 plain version on the
    same inputs and timed."""
    import torch

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(2)
    rows, chunk_ms = [], {}
    for n in H5_CHUNK_N:
        n_rows, ms = _chunk_conv_rows(n, h5_chunk_launches(), gen, "h5 chunk", yardsticks=False)
        rows += n_rows
        chunk_ms.update({(n, tag): t for tag, t in ms.items()})
        log(f"h5 pair chunk of {n} spans ({sum(h5_chunk_launches().values())} launches): kernels fp32 "
            f"{chunk_ms[(n, 'fp32')]:.3f} ms, bf16 {chunk_ms[(n, 'bf16')]:.3f} ms; max |err| fp32 "
            f"{max(r['fp32']['max_abs_err'] for r in n_rows):.3g}, bf16 "
            f"{max(r['bf16']['max_abs_err'] for r in n_rows):.3g}")
    report["h5_layers"] = rows
    report["h5_chunk_kernel_ms"] = {f"N={n} {tag}": ms for (n, tag), ms in chunk_ms.items()}


def gene_chunk_launches() -> Counter:
    """{(layer, L): launches} of one gene chunk (parallel/runner.
    predict_spans_project: the full conv stack over each 41,800-bp span,
    forward and reverse complement; the 200 window offsets of either strand
    fall on pool-2 phases 0 and 2, and so do their mirrors)."""
    tally = Counter()
    for _orientation in range(2):
        tally.update(conv_stack(GENE_SPAN, (0, 2)))
    return tally


def gene_kernel_phase(report: dict) -> None:
    """Every conv of one gene chunk (GENE_ROWS spans of 41,800 bp, both
    orientations: 16 launches) on each dtype's route, held against the fp32
    plain version and timed beside the plain version, ``F.conv1d`` and the
    bound."""
    import torch

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(3)
    launches = gene_chunk_launches()
    rows, chunk_ms = _chunk_conv_rows(GENE_ROWS, launches, gen, "gene chunk", yardsticks=True)
    for r in rows:
        log(f"gene chunk {r['layer']} N={r['N']} L={r['L']} {r['Cin']}->{r['Cout']} x{r['launches_per_chunk']}: "
            + "; ".join(f"{t} {c['route']} {c['ms']:.3f} ms (err {c['max_abs_err']:.3g}) bound {c['bound_ms']:.3f} "
                        f"ms ({c['bound_by']}, {100 * c['bound_ms'] / c['ms']:.1f} %) plain {c['plain_ms']:.3f} ms "
                        f"conv1d {c['library_ms']:.3f} ms" for t, c in ((t, r[t]) for t in ("fp32", "bf16"))))
    summary = {}
    for tag in ("fp32", "bf16"):
        summary[tag] = {"ms": chunk_ms[tag], "bound_ms": _weighted(rows, tag, "bound_ms"),
                        "plain_ms": _weighted(rows, tag, "plain_ms"), "library_ms": _weighted(rows, tag, "library_ms"),
                        "conv0_ms": _weighted([r for r in rows if r["layer"] == "conv0"], tag, "ms")}
        c = summary[tag]
        log(f"gene chunk {tag} ({sum(launches.values())} launches): kernels {c['ms']:.3f} ms (conv0 "
            f"{c['conv0_ms']:.3f}), bound {c['bound_ms']:.3f} ms ({100 * c['bound_ms'] / c['ms']:.1f} %), plain "
            f"{c['plain_ms']:.3f} ms, F.conv1d {c['library_ms']:.3f} ms")
    report["gene_layers"] = rows
    report["gene_chunk_kernel_ms"] = summary


def _weighted(rows: list, tag: str, key: str) -> float:
    """Sum of ``row[tag][key]`` over per-shape rows, each weighted by its
    launches in one substitution chunk."""
    return sum(r[tag][key] * r["launches_per_chunk"] for r in rows)


def chunk_summary(report: dict) -> None:
    """Launch-weighted kernel time of one substitution chunk (32 launches)
    in each dtype, on the main path's routes, against F.conv1d and the
    bound."""
    conv8, conv0 = report["conv8_layers"], report["conv0_layers"]
    every = conv8 + conv0
    for tag in ("bf16", "fp32"):
        chunk = {"conv1_5_ms": _weighted(conv8, tag, "ms"), "conv0_ms": _weighted(conv0, tag, "ms"),
                 "library_ms": _weighted(every, tag, "library_ms"), "bound_ms": _weighted(every, tag, "bound_ms")}
        chunk["ms"] = chunk["conv1_5_ms"] + chunk["conv0_ms"]
        report[f"conv_chunk_{tag}"] = chunk
        log(f"{tag} chunk ({sum(r['launches_per_chunk'] for r in every)} launches): main-path kernels "
            f"{chunk['ms']:.3f} ms (conv1-conv5 {chunk['conv1_5_ms']:.3f}, conv0 {chunk['conv0_ms']:.3f}), "
            f"F.conv1d {chunk['library_ms']:.3f} ms, bound {chunk['bound_ms']:.3f} ms")
    simt = {"ms": _weighted(conv8, "fp32", "ms"), "library_ms": _weighted(conv8, "fp32", "library_ms"),
            "bound_ms": _weighted(conv8, "fp32", "bound_ms"),
            "min_shape_share": min(r["fp32"]["bound_ms"] / r["fp32"]["ms"] for r in conv8)}
    report["simt_fp32_chunk"] = simt
    log(f"simt fp32 conv1-conv5 chunk: {simt['ms']:.3f} ms, {100 * simt['bound_ms'] / simt['ms']:.1f} % of its "
        f"bound {simt['bound_ms']:.3f} ms; F.conv1d (TF32 off) {simt['library_ms']:.3f} ms, "
        f"{simt['library_ms'] / simt['ms']:.2f}x the kernel's time; lowest share of a shape's bound "
        f"{100 * simt['min_shape_share']:.1f} %")


def make_inputs(seed: int) -> dict:
    """Seeded genome, VCF, closest-gene table, 218 gblinear models and
    full-width Beluga weights under build/chip_smoke."""
    import numpy as np

    from expecto_tpu_torch.genome.fasta import write_fasta
    from expecto_tpu_torch.io.xgb import save_xgb07_binary
    from expecto_tpu_torch.models.beluga import CONV_SPECS, FC1_IN, FC1_OUT, FC2_OUT
    from expecto_tpu_torch.models.convert import save_params_npz
    from expecto_tpu_torch.models.gblinear import GBLinearModel

    rng = np.random.default_rng(seed)
    WORK.mkdir(parents=True, exist_ok=True)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contigs = {}
    for name in ("chr1", "chr2"):
        seq = bases[rng.integers(0, 4, CONTIG_LEN)]
        for start in rng.integers(2000, CONTIG_LEN - 2000, 6):  # a few N runs
            seq[start : start + int(rng.integers(20, 400))] = ord("N")
        contigs[name] = seq.tobytes().decode()
    write_fasta(WORK / "genome.fa", contigs)

    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    # one variant per site (the gene table repeats rows per variant key)
    sites = rng.choice(2 * (CONTIG_LEN - 6000), N_SUBS + N_INDELS, replace=False)
    variants = []
    for i, site in enumerate(sites):
        kind = "sub" if i < N_SUBS else "indel"
        chrom = ("chr1", "chr2")[int(site) % 2]
        pos = 3000 + int(site) // 2
        seq = contigs[chrom]
        if kind == "sub":
            ref = seq[pos - 1]
            alt = comp.get(ref, "A")
        elif rng.random() < 0.5:  # insertion of 1-20 bp
            ref = seq[pos - 1]
            alt = ref + "".join(rng.choice(list("ACGT"), int(rng.integers(1, 21))))
        else:  # deletion of 1-20 bp
            ref = seq[pos - 1 : pos + int(rng.integers(1, 21))]
            alt = seq[pos - 1]
        variants.append((chrom, pos, ref, alt))
    for chrom, pos in (("chr1", 700), ("chr2", 1500), ("chr1", CONTIG_LEN - 600), ("chr2", CONTIG_LEN - 1300)):
        ref = contigs[chrom][pos - 1]
        variants.append((chrom, pos, ref, comp.get(ref, "A")))  # contig-edge rows: per-window fallback

    vcf_lines, gene_lines = [], []
    for chrom, pos, ref, alt in variants:
        vcf_lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}")
        for g in range(int(rng.integers(1, 4))):
            tss = pos + int(rng.integers(-20000, 20000))
            strand = "+" if rng.random() < 0.5 else "-"
            gene_lines.append(f"{chrom[3:]}\t{pos - 1}\t{pos}\t{ref}\t{alt}\t{chrom[3:]}\t{tss - 1}\t{tss}\t{strand}"
                              f"\tENSG{pos:08d}{g}\t{tss - pos}")
    (WORK / "variants.vcf").write_text("\n".join(vcf_lines) + "\n")
    (WORK / "genes.tsv").write_text("\n".join(gene_lines) + "\n")

    model_dir = WORK / "models"
    model_dir.mkdir(exist_ok=True)
    modellist = ["ModelName\tTissue"]
    for j in range(N_MODELS):
        w = (rng.standard_normal(10 * 2002) * 0.02).astype(np.float32)
        path = model_dir / f"tissue{j:03d}.save"
        save_xgb07_binary(GBLinearModel(weight=w, bias=float(rng.normal(0, 0.1)), base_score=2.0), path)
        modellist.append(f"{path}\tTissue{j:03d}")
    (WORK / "modellist").write_text("\n".join(modellist) + "\n")

    def layer(shape, fan_in):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in))
        return {"w": w, "b": (rng.standard_normal(shape[-1]) * 0.05).astype(np.float32)}

    params = {f"conv{i}": layer((8, cin, cout), 8 * cin) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    params["fc1"] = layer((FC1_IN, FC1_OUT), FC1_IN)
    params["fc2"] = layer((FC1_OUT, FC2_OUT), FC1_OUT)
    save_params_npz(params, WORK / "beluga.npz")
    return {"variants": variants, "n_rows": len(gene_lines)}


def make_gene_inputs(seed: int) -> list:
    """``geneanno.csv`` under build/chip_smoke: N_GENES_PER_STRAND seeded
    genes a strand on make_inputs' genome, plus-strand genes first. Three
    TSSs lie within 20 kb of a contig end, so their 41,800-bp spans are
    N-padded: the plus strand's 18,000 N at chr1's start passes the 2-bit
    wire's N budget (that group ships 4 bits a base), the minus strand's
    11,000 N at chr2's end does not (it rides the N sideband). Returns the
    genes as (id, chrom, tss, strand) rows."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed + 1)  # apart from make_inputs' stream
    edge = {1: [("chr1", 3000), ("chr2", 12000)], -1: [("chr2", CONTIG_LEN - 10000)]}
    sites = []
    for strand in (1, -1):
        n = N_GENES_PER_STRAND - len(edge[strand])
        sites += [(chrom, tss, strand) for chrom, tss in edge[strand]]
        sites += [(("chr1", "chr2")[int(c)], int(t), strand)
                  for c, t in zip(rng.integers(0, 2, n), rng.integers(21000, CONTIG_LEN - 21000, n))]
    genes = [(f"ENSG{i:07d}", *site) for i, site in enumerate(sites)]
    pd.DataFrame({"id": [g[0] for g in genes], "symbol": [f"S{i}" for i in range(len(genes))],
                  "seqnames": [g[1] for g in genes], "strand": ["+" if g[3] == 1 else "-" for g in genes],
                  "TSS": [g[2] for g in genes], "CAGE_representative_TSS": [g[2] for g in genes],
                  "type": ["protein_coding"] * len(genes)}).to_csv(WORK / "geneanno.csv", index=False)
    return genes


def score_args(vcf: Path, genes: Path, *extra: str) -> list[str]:
    return [str(vcf), "--geneFile", str(genes), "--modelList", str(WORK / "modellist"),
            "--genome", str(WORK / "genome.fa"), "--beluga_weights", str(WORK / "beluga.npz"),
            "--maxshift", str(MAXSHIFT), "--device", DEVICE, *extra]


def check_output(csv: Path, n_rows: int):
    import numpy as np
    import pandas as pd

    df = pd.read_csv(csv)
    names = [f"Tissue{j:03d}" for j in range(N_MODELS)]
    if df.shape != (n_rows, 8 + 3 * N_MODELS):
        raise AssertionError(f"{csv.name}: shape {df.shape}, expected {(n_rows, 8 + 3 * N_MODELS)}")
    ref = df[[f"REF_{m}" for m in names]].to_numpy(np.float64)
    alt = df[[f"ALT_{m}" for m in names]].to_numpy(np.float64)
    sed = df[names].to_numpy(np.float64)
    if not (np.isfinite(ref).all() and np.isfinite(alt).all() and np.isfinite(sed).all()):
        raise AssertionError(f"{csv.name}: non-finite values")
    # ALT is rebuilt as REF + SED in fp32 on the host
    gap = float(np.abs(sed - (alt - ref)).max())
    if gap > 1e-5 * max(1.0, float(np.abs(alt).max())):
        raise AssertionError(f"{csv.name}: SED != ALT - REF (max gap {gap})")
    return df, ref, alt, sed


def _reset_counts() -> None:
    from expecto_tpu_torch.ops import conv0, conv8

    conv8.reset_launch_counts()
    conv0.reset_launch_counts()


def _read_counts(dtype: str) -> dict:
    """Every kernel's launches since the last _reset_counts, checked: the
    route counts add up, no float one-hot reached conv8_relu (no launch at
    Cin 4), every conv0 ran on the code-gather kernel in ``dtype``, and each
    conv stack ran its conv0 there (conv1 and conv2, the two Cin-320 convs
    of a stack, launch twice as often as conv0)."""
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu
    from expecto_tpu_torch.ops.conv8 import conv8_relu

    by_route, kinds = dict(conv8_relu.launches_by_route), Counter(conv8_relu.launches_by_kind)
    n0, kind0 = conv0_codes_relu.launches, dict(conv0_codes_relu.launches_by_kind)
    counts = {"conv8_relu": conv8_relu.launches, "conv8_relu_by_route": by_route,
              "conv8_relu_by_kind": {f"{r} {dt} Cin {cin}": k for (r, dt, cin), k in sorted(kinds.items())},
              "conv0_codes": n0, "conv0_codes_by_kind": kind0}
    if sum(by_route.values()) != conv8_relu.launches:
        raise AssertionError(f"route counts {by_route} do not add up to {conv8_relu.launches} launches")
    if n0 <= 0 or kind0 != {dtype: n0}:
        raise AssertionError(f"conv0 did not run on the code-gather kernel in {dtype} alone: {kind0}")
    if any(cin == 4 for _r, _dt, cin in kinds):
        raise AssertionError(f"a float one-hot reached conv8_relu: {counts['conv8_relu_by_kind']}")
    if sum(k for (_r, _dt, cin), k in kinds.items() if cin == 320) != 2 * n0:
        raise AssertionError(f"conv stacks without a conv0 launch: {n0} conv0, {counts['conv8_relu_by_kind']}")
    return counts


def main_path_phase(report: dict, inputs: dict, card: str) -> None:
    import numpy as np
    import torch

    from expecto_tpu_torch.cli.score import main as score_main

    out_csv = WORK / "output.csv"
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rc = score_main(score_args(WORK / "variants.vcf", WORK / "genes.tsv", "--output", str(out_csv)))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"score CLI returned {rc}")
    counts = _read_counts("bfloat16")
    by_route = counts["conv8_relu_by_route"]
    if by_route["tc"] <= 0 or by_route["simt"] != 0:
        raise AssertionError(f"bf16 conv1-conv5 did not all run on the tc kernel: {by_route}")
    _df, ref, _alt, sed = check_output(out_csv, inputs["n_rows"])
    n_var = len(inputs["variants"])
    report["main_path"] = {
        "variants": n_var, "rows": inputs["n_rows"], "models": N_MODELS, "maxshift": MAXSHIFT,
        "cli_wall_s": wall, "launches": counts,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "sed_abs_max": float(np.abs(sed).max()), "ref_abs_max": float(np.abs(ref).max()),
    }
    log(f"main path: {n_var} variants, {inputs['n_rows']} (variant, gene) rows x {N_MODELS} models in {wall:.2f} s "
        f"(CLI incl. weight load) = {inputs['n_rows'] / wall:.1f} rows/s, {n_var / wall:.1f} variants/s; "
        f"launches {counts} [{card}]")
    walls = serve(WORK / "variants.vcf", WORK / "genes.tsv", inputs["n_rows"], fp32=False, warmup=0, repeats=3)
    med = statistics.median(walls)
    log(f"warm serving ({len(walls)} runs): median {med:.3f} s = {inputs['n_rows'] / med:.1f} rows/s, "
        f"{n_var / med:.1f} variants/s; runs {[round(w, 3) for w in walls]} [{card}]")
    report["main_path"]["serve_wall_s"] = walls


def serve(vcf: Path, genes: Path, n_rows: int, *, fp32: bool, warmup: int, repeats: int) -> list[float]:
    """Wall times of repeats of the serving call itself on the card, with
    the CLI's settings (bf16 compute and fp16 wire, or ``--fp32``'s fp32 and
    fp32): one runner and its models built once, ``warmup`` calls first,
    launch counts zeroed just before the timed calls."""
    import numpy as np
    import pandas as pd
    import torch

    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.sed import score_sed_serving

    runner = BelugaRunner(load_params_npz(WORK / "beluga.npz"), batch_size=BATCH, device=DEVICE,
                          compute_dtype=torch.float32 if fp32 else torch.bfloat16,
                          out_dtype=np.float32 if fp32 else np.float16)
    genome = FastaIndex(WORK / "genome.fa")
    vcf_df = standardize_chroms(read_vcf(vcf))
    gene = load_closest_genes(genes)
    ml = load_modellist(WORK / "modellist")
    walls = []
    try:
        for i in range(warmup + repeats):
            if i == warmup:
                _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df = score_sed_serving(vcf_df, gene, genome, runner, ml.iloc[:, 0].tolist(), maxshift=MAXSHIFT,
                                   model_names=ml.iloc[:, 1].tolist())
            torch.cuda.synchronize()
            if i >= warmup:
                walls.append(time.perf_counter() - t0)
    finally:
        genome.close()
    if not isinstance(df, pd.DataFrame) or len(df) != n_rows:
        raise AssertionError("warm serving returned the wrong number of rows")
    return walls


def subset(inputs: dict, picks, tag: str) -> tuple[Path, Path, int]:
    """``tag``.vcf and ``tag``_genes.tsv under build/chip_smoke: the variants
    ``picks`` (indices into ``inputs["variants"]``) and all their gene rows;
    returns both paths and the number of rows."""
    variants = inputs["variants"]
    vcf_lines = (WORK / "variants.vcf").read_text().splitlines()
    gene_lines = (WORK / "genes.tsv").read_text().splitlines()
    keep = {f"{variants[i][0][3:]}\t{variants[i][1] - 1}\t{variants[i][1]}\t{variants[i][2]}\t{variants[i][3]}"
            for i in picks}
    vcf, genes = WORK / f"{tag}.vcf", WORK / f"{tag}_genes.tsv"
    vcf.write_text("\n".join(vcf_lines[i] for i in picks) + "\n")
    rows = [g for g in gene_lines if "\t".join(g.split("\t")[:5]) in keep]
    genes.write_text("\n".join(rows) + "\n")
    return vcf, genes, len(rows)


def fp32_serve_phase(report: dict, inputs: dict, card: str) -> None:
    """One warm fp32 serving call on the first N_FP32_SERVE substitutions
    and their genes: parity mode's end-to-end throughput, its conv1-conv5 on
    the SIMT kernel."""
    vcf, genes, n_rows = subset(inputs, range(N_FP32_SERVE), "fp32_serve")
    wall = serve(vcf, genes, n_rows, fp32=True, warmup=1, repeats=1)[0]
    counts = _read_counts("float32")
    if counts["conv8_relu_by_route"]["simt"] <= 0 or counts["conv8_relu_by_route"]["tc"] != 0:
        raise AssertionError(f"fp32 serve: conv1-conv5 did not all run on the simt kernel: {counts}")
    report["fp32_serve"] = {"variants": N_FP32_SERVE, "rows": n_rows, "models": N_MODELS, "wall_s": wall,
                            "rows_per_s": n_rows / wall, "launches": counts}
    log(f"warm fp32 serve: {N_FP32_SERVE} substitutions, {n_rows} (variant, gene) rows x {N_MODELS} models in "
        f"{wall:.3f} s = {n_rows / wall:.1f} rows/s, {N_FP32_SERVE / wall:.1f} variants/s; launches {counts} [{card}]")


def parity_phase(report: dict, inputs: dict) -> None:
    """fp32 on the card vs fp32 on the CPU for a substitution with its genes,
    a second substitution, an indel and a contig-edge row."""
    import numpy as np

    from expecto_tpu_torch.cli.score import main as score_main

    vcf, genes, n_rows = subset(inputs, [0, 1, N_SUBS, len(inputs["variants"]) - 1], "parity")
    frames = {}
    for tag, device in (("card", DEVICE), ("cpu", "cpu")):
        out = WORK / f"parity_{tag}.csv"
        _reset_counts()
        rc = score_main(score_args(vcf, genes, "--fp32", "--device", device, "--output", str(out)))
        if rc != 0:
            raise AssertionError(f"fp32 score CLI on {device} returned {rc}")
        if tag == "card":
            counts = _read_counts("float32")
            if counts["conv8_relu_by_route"]["simt"] <= 0 or counts["conv8_relu_by_route"]["tc"] != 0:
                raise AssertionError(f"fp32 conv1-conv5 did not all run on the simt kernel: {counts}")
        frames[tag] = check_output(out, n_rows)
    _dg, ref_g, alt_g, sed_g = frames["card"]
    _dc, ref_c, alt_c, sed_c = frames["cpu"]
    sed_atol = 1e-5 * max(1.0, float(np.abs(ref_c).max()))
    errs = {"REF": float(np.abs(ref_g - ref_c).max()), "ALT": float(np.abs(alt_g - alt_c).max()),
            "SED": float(np.abs(sed_g - sed_c).max())}
    for name, g, c, atol in (("REF", ref_g, ref_c, PARITY_ATOL), ("ALT", alt_g, alt_c, PARITY_ATOL),
                             ("SED", sed_g, sed_c, sed_atol)):
        np.testing.assert_allclose(g, c, rtol=PARITY_RTOL, atol=atol, err_msg=f"card vs CPU fp32 {name}")
    report["parity"] = {"rows": n_rows, "max_abs_err": errs, "sed_atol": sed_atol, "launches": counts}
    log(f"parity fp32 card vs CPU on {n_rows} rows x {N_MODELS} models: max |err| {errs}; card launches {counts}")


def _h5_effects(res) -> dict:
    """``ChromatinResult.arrays`` ({shift: (diff, ref, alt)}, (2N, M) each)
    as ``load_shift_effects`` returns the files: {key: (S, N, M)} with the
    forward and reverse-complement halves averaged."""
    import numpy as np

    from expecto_tpu_torch.io.h5 import avg_fwd_rc

    return {k: np.stack([avg_fwd_rc(res.arrays[s][i]) for s in res.shifts])
            for i, k in ((0, "diff"), (1, "ref"), (2, "alt"))}


def _chromatin(runner, vcf, genome):
    """The chromatin step in memory (``keep_arrays``): the span rows through
    ``predict_span_pairs_diff`` whole, merged with the window rows."""
    from expecto_tpu_torch.pipeline.chromatin import compute_variant_chromatin_effects

    return compute_variant_chromatin_effects(vcf, genome, runner, None, maxshift=MAXSHIFT, keep_arrays=True,
                                             verbose=False)


def _chromatin_streaming(runner, vcf, genome) -> list[dict]:
    """The chromatin CLI's step as ``compute_variant_chromatin_effects`` runs
    it with an output directory: validation, diagnostics and eligibility,
    then ``stream_span_rows`` (the pair chunks through the runner's sink,
    then the window rows), with numpy arrays in place of the h5 datasets,
    since this script needs no h5py. Returns per shift {"diff", "ref",
    "alt"}: (2N, 2002) float32 arrays, rows [fwd; rc]."""
    import numpy as np

    from expecto_tpu_torch.genome.windows import variant_shifts
    from expecto_tpu_torch.pipeline import chromatin as ch

    n = len(vcf)
    chroms, positions = vcf.iloc[:, 0].astype(str).values, vcf.iloc[:, 1].astype(int).values
    refs, alts = vcf.iloc[:, 3].astype(str).values, vcf.iloc[:, 4].astype(str).values
    ch._require_known_chromosomes(genome, chroms)
    ch._diagnostics(genome, chroms, positions, refs, alts, 2000, False)
    span_ok = ch._span_eligible(genome, chroms, positions, refs, alts, MAXSHIFT, 2000)
    shifts = variant_shifts(MAXSHIFT)
    dsets = [{k: np.empty((2 * n, 2002), np.float32) for k in ("diff", "ref", "alt")} for _ in shifts]
    ch.stream_span_rows(genome, runner, chroms, positions, refs, alts, shifts, MAXSHIFT, 2000, span_ok, dsets)
    return dsets


def _bf16_gap(res16, res32, n: int) -> dict:
    """max |bf16 - fp32| of each h5 dataset over every shift, strand and
    row; and the same with a fault planted in the bf16 arrays: the strand
    halves swapped, or the variant rows shifted by one."""
    import numpy as np

    def shifted(a):
        return np.concatenate([np.roll(a[:n], 1, axis=0), np.roll(a[n:], 1, axis=0)])

    gap = {"sound": {}, "strands_swapped": {}, "rows_shifted": {}}
    for s in res32.shifts:
        for i, k in ((0, "diff"), (1, "ref"), (2, "alt")):
            a16, a32 = res16.arrays[s][i], res32.arrays[s][i]
            for case, a in (("sound", a16), ("strands_swapped", np.roll(a16, n, axis=0)),
                            ("rows_shifted", shifted(a16))):
                gap[case][k] = max(gap[case].get(k, 0.0), float(np.abs(a - a32).max()))
    return gap


def h5_contract_phase(report: dict, inputs: dict, card: str) -> None:
    """The h5 contract on every main-path variant, fp32 then bf16, with the
    chromatin CLI's settings; the fp32 effects scored as the predict CLI
    scores them and checked against the CPU and the fused scorer."""
    import numpy as np
    import torch

    from expecto_tpu_torch.cli.score import main as score_main
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.io.xgb import load_expression_model
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.chromatin import _span_eligible
    from expecto_tpu_torch.pipeline.sed import score_sed, score_sed_multimodel

    params = load_params_npz(WORK / "beluga.npz")
    genome = FastaIndex(WORK / "genome.fa")
    vcf = standardize_chroms(read_vcf(WORK / "variants.vcf"))
    gene = load_closest_genes(WORK / "genes.tsv")
    ml = load_modellist(WORK / "modellist")
    paths, names = ml.iloc[:, 0].tolist(), ml.iloc[:, 1].tolist()
    n = len(vcf)
    eligible = _span_eligible(genome, vcf.iloc[:, 0].astype(str).values, vcf.iloc[:, 1].astype(int).values,
                              vcf.iloc[:, 3].astype(str).values, vcf.iloc[:, 4].astype(str).values, MAXSHIFT, 2000)
    n_win = int((~eligible).sum())
    out = {"variants": n, "span_rows": n - n_win, "window_rows": n_win, "batch": H5_BATCH}
    if n - n_win != H5_SPAN_VARIANTS:
        raise AssertionError(f"{n - n_win} span rows, but the kernel phase checked chunks of {H5_SPAN_VARIANTS}")
    span_rows = np.nonzero(eligible)[0]
    span_rows = np.concatenate([span_rows, n + span_rows])
    results = {}
    try:
        for tag, dtype, wire in (("fp32", torch.float32, np.float32), ("bf16", torch.bfloat16, np.float16)):
            runner = BelugaRunner(params, batch_size=H5_BATCH, device=DEVICE, compute_dtype=dtype, out_dtype=wire)
            if runner._pair_rows(9) != H5_PAIRS:
                raise AssertionError(f"pair chunks of {runner._pair_rows(9)} variants, kernels checked {H5_PAIRS}")
            res = _chromatin(runner, vcf, genome)  # also the warm-up
            torch.cuda.synchronize()
            # the timed step: the CLI's streaming path
            _reset_counts()
            t0 = time.perf_counter()
            streamed = _chromatin_streaming(runner, vcf, genome)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counts(str(dtype).removeprefix("torch."))
            # per pair chunk, both alleles in one batch: 2 orientations x (1
            # conv0 + conv1-conv3 + conv4/conv5 at pool-2 phases 0 and 2);
            # per shift, the window rows' 4 windows each (ref, alt, both
            # orientations) in batches of H5_BATCH: 1 conv0 + 5 conv8 a batch
            chunks = -(-H5_SPAN_VARIANTS // H5_PAIRS)
            win_calls = 9 * -(-4 * n_win // H5_BATCH) if n_win else 0
            want0, want8 = 2 * chunks + win_calls, 14 * chunks + 5 * win_calls
            route, other = ("simt", "tc") if tag == "fp32" else ("tc", "simt")
            by_route = counts["conv8_relu_by_route"]
            if (counts["conv0_codes"], by_route[route], by_route[other]) != (want0, want8, 0):
                raise AssertionError(f"h5 {tag}: launches {counts}, expected {want0} conv0 and {want8} {route}")
            # the streamed rows land where the in-memory path puts them, bit
            # for bit; on the span rows alt = ref + diff exactly (rebuilt on
            # the host in fp32), and with an fp16 wire ref and diff are fp16
            # values (diff taken on the card before the cast)
            for si, s in enumerate(res.shifts):
                diff, ref, alt = res.arrays[s]
                for k, a in (("diff", diff), ("ref", ref), ("alt", alt)):
                    if not np.array_equal(streamed[si][k], a):
                        raise AssertionError(f"h5 {tag}: streamed {k} of shift {s} differs from the in-memory path "
                                             f"(max |diff| {float(np.abs(streamed[si][k] - a).max())})")
                    if not np.isfinite(a).all() or a.shape != (2 * n, 2002):
                        raise AssertionError(f"h5 {tag}: {k} of shift {s} has shape {a.shape}, or is not finite")
                if not np.array_equal(alt[span_rows], ref[span_rows] + diff[span_rows]):
                    raise AssertionError(f"h5 {tag}: alt != ref + diff on the span rows of shift {s}")
                if wire == np.float16 and not all(np.array_equal(a[span_rows], a[span_rows].astype(wire))
                                                  for a in (ref, diff)):
                    raise AssertionError(f"h5 {tag}: ref or diff of shift {s} is not what an fp16 wire carries")
            del streamed
            nbytes = sum(a.nbytes for s in res.shifts for a in res.arrays[s])
            out[tag] = {"wall_s": wall, "variants_per_s": n / wall, "launches": counts, "pair_chunks": chunks,
                        "window_batches": win_calls, "h5_bytes": nbytes}
            log(f"h5 contract {tag}: chromatin (streaming) on {n} variants ({n - n_win} span, {n_win} window) in "
                f"{wall:.3f} s warm = {n / wall:.1f} variants/s; {chunks} pair chunks, {win_calls} window batches; "
                f"the fork-schema files would hold {nbytes / 1e9:.3f} GB; launches {counts}; streamed = in-memory "
                f"bit for bit [{card}]")
            results[tag] = res
            del runner
            torch.cuda.empty_cache()

        res32 = results["fp32"]
        gap = _bf16_gap(results.pop("bf16"), res32, n)
        out["bf16_vs_fp32_max_abs"] = gap
        log(f"h5 contract bf16 vs fp32 effects, per strand: max |diff| {gap['sound']} (limit {H5_BF16_GAP}); with "
            f"the strands swapped {gap['strands_swapped']}, with the rows shifted by one {gap['rows_shifted']}")
        if max(gap["sound"].values()) > H5_BF16_GAP:
            raise AssertionError(f"h5 bf16 effects differ from fp32 by more than {H5_BF16_GAP}: {gap['sound']}")
        if min(min(gap[c].values()) for c in ("strands_swapped", "rows_shifted")) <= H5_BF16_GAP:
            raise AssertionError(f"the bf16 gap limit {H5_BF16_GAP} does not catch a planted fault: {gap}")
        eff32 = _h5_effects(res32)

        # the predict step on the fp32 effects: sed.tsv for model 0 and the
        # --modelList table for all 218 models
        t0 = time.perf_counter()
        sed = score_sed(eff32, vcf, gene, load_expression_model(paths[0]), maxshift=MAXSHIFT,
                        out_dir=WORK / "h5_predict").table
        t_sed = time.perf_counter() - t0
        t0 = time.perf_counter()
        multi = score_sed_multimodel(eff32, vcf, gene, paths, maxshift=MAXSHIFT, model_names=names,
                                     output_csv=WORK / "h5_output.csv")
        t_multi = time.perf_counter() - t0
        out.update(score_sed_s=t_sed, score_sed_multimodel_s=t_multi)
        log(f"h5 contract predict: score_sed (1 model) {t_sed:.3f} s, score_sed_multimodel ({N_MODELS} models) "
            f"{t_multi:.3f} s on {len(sed)} rows")

        # card vs CPU on a substitution, an insertion, a deletion, an edge row
        variants = inputs["variants"]
        indels = range(N_SUBS, N_SUBS + N_INDELS)
        picks = [0, next(i for i in indels if len(variants[i][3]) > 1),
                 next(i for i in indels if len(variants[i][2]) > 1), len(variants) - 1]
        cpu = _chromatin(BelugaRunner(params, batch_size=H5_BATCH, device="cpu"), vcf.iloc[picks], genome)
        rows = np.array(picks + [n + i for i in picks])
        errs = {}
        for s in cpu.shifts:
            for name, got, want, rtol, atol in zip(("diff", "ref", "alt"), res32.arrays[s], cpu.arrays[s],
                                                   (0, H5_RTOL, H5_RTOL), (H5_DIFF_ATOL, H5_ATOL, H5_ATOL)):
                np.testing.assert_allclose(got[rows], want, rtol=rtol, atol=atol, err_msg=f"h5 card vs CPU {name} {s}")
                errs[name] = max(errs.get(name, 0.0), float(np.abs(got[rows] - want).max()))
        out["card_vs_cpu_max_abs"] = errs
        log(f"h5 contract fp32 card vs CPU on {len(picks)} variants x 9 shifts x 2 strands: max |err| {errs}")
    finally:
        genome.close()

    # expecto-score --fp32 on the same variants: sed.tsv against its model-0
    # columns, and every --modelList column against minus its SED column
    serve_csv = WORK / "h5_serve_fp32.csv"
    if score_main(score_args(WORK / "variants.vcf", WORK / "genes.tsv", "--fp32", "--output", str(serve_csv))) != 0:
        raise AssertionError("fp32 score CLI returned non-zero")
    _df, ref_s, alt_s, sed_s = check_output(serve_csv, inputs["n_rows"])
    if len(sed) != inputs["n_rows"] or len(multi) != inputs["n_rows"]:
        raise AssertionError(f"h5 scorers returned {len(sed)} and {len(multi)} rows, expected {inputs['n_rows']}")
    sed_atol = 1e-5 * max(1.0, float(np.abs(ref_s[:, 0]).max()))
    np.testing.assert_allclose(sed["REF"], ref_s[:, 0], rtol=REF_RTOL, atol=REF_ATOL, err_msg="sed.tsv REF")
    np.testing.assert_allclose(sed["ALT"], alt_s[:, 0], rtol=REF_RTOL, atol=REF_ATOL, err_msg="sed.tsv ALT")
    np.testing.assert_allclose(sed["SED"], sed_s[:, 0], rtol=SED_RTOL, atol=sed_atol, err_msg="sed.tsv SED")
    multi_v = multi[names].to_numpy(np.float64)
    col_atol = 1e-5 * np.maximum(1.0, np.abs(ref_s).max(axis=0))
    err = np.abs(multi_v + sed_s)
    if not (err <= col_atol + SED_RTOL * np.abs(sed_s)).all():
        raise AssertionError(f"--modelList output != -SED of expecto-score --fp32: max |err| {err.max()}")
    out["vs_score_fp32"] = {
        "REF": float(np.abs(sed["REF"] - ref_s[:, 0]).max()), "ALT": float(np.abs(sed["ALT"] - alt_s[:, 0]).max()),
        "SED": float(np.abs(sed["SED"] - sed_s[:, 0]).max()), "SED_atol": sed_atol,
        "multimodel_plus_SED": float(err.max()), "multimodel_atol_max": float(col_atol.max()),
    }
    report["h5_contract"] = out
    log(f"h5 contract vs expecto-score --fp32 on {inputs['n_rows']} rows: max |err| {out['vs_score_fp32']}")


def _gene_route_plan(runner, genes, genome) -> list[dict]:
    """How each strand group of compute_gene_features ships its chunks: the
    2-bit wire with the N sideband, or 4 bits a base when a chunk of the
    group passes the sideband's N budget (the runner decides per call, and
    each group is one call); with each chunk's N count."""
    import numpy as np

    from expecto_tpu_torch.genome.windows import gene_shifts
    from expecto_tpu_torch.pipeline.features import _offset_groups, gene_span_and_offsets

    groups = []
    for offsets, idxs in _offset_groups(genes, gene_shifts(), 2000).items():
        spans = np.stack([gene_span_and_offsets(genome, genes[j].chrom, genes[j].tss, genes[j].strand)[0]
                          for j in idxs])
        n_per_chunk = [int((spans[i : i + GENE_ROWS] == 4).sum()) for i in range(0, len(idxs), GENE_ROWS)]
        route = "2-bit" if runner._pack2_plan(spans, GENE_ROWS) is not None else "4-bit"
        groups.append({"strand": "+" if offsets[0] == 0 else "-", "genes": len(idxs), "route": route,
                       "n_bases_per_chunk": n_per_chunk})
    return groups


def _gene_counts_checked(dtype: str, chunks: int, what: str) -> dict:
    """The launch counts since the last _reset_counts, checked for a gene
    run of ``chunks`` chunks: 16 launches a chunk, 2 conv0 on the
    code-gather kernel and 14 conv8_relu on the dtype's route only."""
    counts = _read_counts(dtype)
    route, other = ("simt", "tc") if dtype == "float32" else ("tc", "simt")
    by_route = counts["conv8_relu_by_route"]
    if (counts["conv0_codes"], by_route[route], by_route[other]) != (2 * chunks, 14 * chunks, 0):
        raise AssertionError(f"{what}: launches {counts}, expected {2 * chunks} conv0 and {14 * chunks} {route} "
                             f"for {chunks} gene chunks of 16 launches")
    return counts


def _row_gaps(a, b, scale: float):
    """Per gene row, max |a - b| over its features, over ``scale``."""
    import numpy as np

    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max(axis=1) / scale


def _gene_projection_gaps(params, genes, genome, bf16_feats) -> dict:
    """The bf16 path's projection and wire (GENE_WIRE_RTOL): per strand
    group, the bf16 network's fwd and RC predictions fetched in fp32 (the
    same chunks, route and kernels as the timed call, so the same values),
    averaged and projected in fp64 on the host; the timed bf16 features held
    against that per feature, and so are two planted faults: the projection
    contracted in bf16 on the card, and the forward half alone."""
    import numpy as np
    import torch

    from expecto_tpu_torch.genome.windows import gene_shifts
    from expecto_tpu_torch.ops.decay import gene_pos_weights
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.features import _offset_groups, gene_span_and_offsets

    runner = BelugaRunner(params, batch_size=GENE_BATCH, device=DEVICE, compute_dtype=torch.bfloat16,
                          out_dtype=np.float32)
    pw = gene_pos_weights(gene_shifts()).astype(np.float64)
    pw_bf16 = torch.as_tensor(pw, device=DEVICE).bfloat16()
    gaps = {"sound": 0.0, "projection_in_bf16": 0.0, "forward_half_only": 0.0}
    for offsets, idxs in _offset_groups(genes, gene_shifts(), 2000).items():
        spans = np.stack([gene_span_and_offsets(genome, genes[j].chrom, genes[j].tss, genes[j].strand)[0]
                          for j in idxs])
        y = runner.predict_span_codes(spans, offsets, rc_mode="concat")  # (n, 2[fwd|rc], 200, 2002) fp32
        avg = (y[:, 0] + y[:, 1]) * 0.5  # fp32, as the runner averages on the card
        want = np.matmul(pw, avg.astype(np.float64)).reshape(len(idxs), -1)
        scale = np.maximum(np.abs(want), 2.0**-14)
        in_bf16 = torch.einsum("bs,nsm->nbm", pw_bf16, torch.as_tensor(avg, device=DEVICE).bfloat16())
        faults = {"sound": bf16_feats[idxs],
                  "projection_in_bf16": in_bf16.half().float().cpu().numpy().reshape(len(idxs), -1),
                  "forward_half_only": np.matmul(pw, y[:, 0].astype(np.float64)).astype(np.float16)
                  .reshape(len(idxs), -1)}
        for k, got in faults.items():
            gaps[k] = max(gaps[k], float((np.abs(got - want) / scale).max()))
    del runner
    torch.cuda.empty_cache()
    return gaps


def gene_phase(report: dict, card: str) -> None:
    """Gene features (``expecto-compute-features``) at Beluga's widths on
    N_GENES_PER_STRAND genes a strand: the CLI (fp32, then ``--bf16``), then
    warm timed compute_gene_features calls with the CLI's settings, launch
    counts zeroed just before each and checked just after; fp32 card vs CPU,
    span path vs per-window path, replicate's raw matrices vs the features,
    the bf16 path's projection and wire against fp64, and bf16 vs fp32."""
    import numpy as np
    import pandas as pd
    import torch

    from expecto_tpu_torch.cli.compute_features import main as cf_main
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.windows import gene_shifts
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.ops.decay import gene_pos_weights, project_features
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.features import (
        compute_gene_features,
        gene_window_codes,
        records_from_geneanno,
        replicate_gene_features,
    )

    out = {"genes": 2 * N_GENES_PER_STRAND, "batch": GENE_BATCH, "chunk_spans": GENE_ROWS}
    genes = records_from_geneanno(pd.read_csv(WORK / "geneanno.csv"))
    chunks = 2 * -(-N_GENES_PER_STRAND // GENE_ROWS)
    params = load_params_npz(WORK / "beluga.npz")
    genome = FastaIndex(WORK / "genome.fa")
    pw = gene_pos_weights(gene_shifts())
    feats = {}
    try:
        for tag, dtype, wire, flags in (("fp32", torch.float32, np.float32, []),
                                         ("bf16", torch.bfloat16, np.float16, ["--bf16"])):
            kind = str(dtype).removeprefix("torch.")
            # the CLI, weights loaded and the output written
            _reset_counts()
            t0 = time.perf_counter()
            rc = cf_main([str(WORK / "geneanno.csv"), "--genome", str(WORK / "genome.fa"), "--beluga_weights",
                          str(WORK / "beluga.npz"), "-o", str(WORK / f"features_{tag}"), "--device", DEVICE, *flags])
            cli_wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"compute_features CLI ({tag}) returned {rc}")
            cli_counts = _gene_counts_checked(kind, chunks, f"gene CLI {tag}")
            cli_feats = np.load(WORK / f"features_{tag}" / "Xreducedall.2002.representative_tss_top.npy")
            if cli_feats.shape != (len(genes), 20020) or not np.isfinite(cli_feats).all():
                raise AssertionError(f"gene CLI {tag}: features of shape {cli_feats.shape}, or not finite")

            # the timed call: compute_gene_features with the CLI's settings
            runner = BelugaRunner(params, batch_size=GENE_BATCH, device=DEVICE, compute_dtype=dtype, out_dtype=wire)
            if runner._span_rows(GENE_SHIFTS) != GENE_ROWS:
                raise AssertionError(f"gene chunks of {runner._span_rows(GENE_SHIFTS)} spans, kernels checked {GENE_ROWS}")
            compute_gene_features(genes[:GENE_ROWS], genome, runner)  # warm-up: one chunk
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            walls = []
            for _ in range(GENE_REPEATS):
                _reset_counts()
                t0 = time.perf_counter()
                f = compute_gene_features(genes, genome, runner)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts = _gene_counts_checked(kind, chunks, f"gene call {tag}")
                if f.shape != (len(genes), 20020) or not np.isfinite(f).all():
                    raise AssertionError(f"gene call {tag}: features of shape {f.shape}, or not finite")
            wall = statistics.median(walls)
            cli_gap = float(np.abs(f - cli_feats).max())
            if cli_gap > GENE_FEAT_RTOL * float(np.abs(f).max()):
                raise AssertionError(f"gene call {tag}: features differ from the CLI's by {cli_gap}")
            out[tag] = {"wall_s": wall, "walls_s": walls, "genes_per_s": len(genes) / wall, "chunks": chunks,
                        "launches": counts,
                        "cli_wall_s": cli_wall, "cli_launches": cli_counts,
                        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
                        "peak_over_resident_mib": (torch.cuda.max_memory_allocated() - resident) / 2**20,
                        "feature_abs_max": float(np.abs(f).max()), "vs_cli_max_abs": cli_gap}
            if tag == "fp32":
                out["routes"] = _gene_route_plan(runner, genes, genome)
            log(f"gene features {tag}: {len(genes)} genes in {wall:.3f} s warm (median of {[round(w, 3) for w in walls]}) "
                f"= {len(genes) / wall:.2f} genes/s; "
                f"CLI {cli_wall:.3f} s (weights loaded); {chunks} chunks of {GENE_ROWS} spans; peak device memory "
                f"{out[tag]['peak_device_mib']:.0f} MiB, {out[tag]['peak_over_resident_mib']:.0f} MiB over what was "
                f"resident before the call; launches {counts} [{card}]")
            feats[tag] = f
            if tag == "fp32":
                runner32 = runner
            else:
                del runner
            torch.cuda.empty_cache()
        gaps = _gene_projection_gaps(params, genes, genome, feats["bf16"])
        out["bf16_projection"] = {"limit": GENE_WIRE_RTOL, **gaps}
        log(f"gene bf16 projection and wire vs fp64 on the bf16 predictions, per feature over |feature|: sound "
            f"{gaps['sound']:.4g}; projection contracted in bf16 {gaps['projection_in_bf16']:.4g}, forward half "
            f"only {gaps['forward_half_only']:.4g} (limit {GENE_WIRE_RTOL})")
        if gaps["sound"] > GENE_WIRE_RTOL:
            raise AssertionError(f"gene bf16 projection or wire off by {gaps['sound']} of the features")
        if min(gaps["projection_in_bf16"], gaps["forward_half_only"]) <= GENE_WIRE_RTOL:
            raise AssertionError(f"the gene projection limit {GENE_WIRE_RTOL} does not catch a planted fault: {gaps}")
        log(f"gene routes per strand group: {out['routes']}")

        # fp32 checks on one gene a strand (the first of each group) at all 200 shifts
        picks = [0, N_GENES_PER_STRAND]
        two = [genes[i] for i in picks]
        f32 = feats["fp32"][picks]
        limit = GENE_FEAT_RTOL * float(np.abs(f32).max())
        cpu = compute_gene_features(two, genome, BelugaRunner(params, batch_size=GENE_BATCH, device="cpu"))
        codes = np.concatenate([gene_window_codes(genome, g.chrom, g.tss, g.strand) for g in two])
        window = runner32.predict_and_project(codes, pw, GENE_SHIFTS)
        raw = replicate_gene_features(two, genome, runner32)
        replicated = np.stack([project_features(pw, raw[g.gene_id][:, None, :])[0] for g in two])
        errs = {"card_vs_cpu": float(np.abs(f32 - cpu).max()), "span_vs_window": float(np.abs(f32 - window).max()),
                "replicate_vs_features": float(np.abs(f32 - replicated).max())}
        out["fp32_checks"] = {"genes": [g.gene_id for g in two], "limit": limit, "max_abs_err": errs}
        log(f"gene fp32 checks on {len(two)} genes (one a strand, 200 shifts): max |err| {errs} (limit {limit:.3g})")
        for name, e in errs.items():
            if not e <= limit:
                raise AssertionError(f"gene fp32 {name}: max |err| {e} over the limit {limit}")

        # bf16 vs fp32, per gene row, over max|fp32 feature|
        scale = float(np.abs(feats["fp32"]).max())
        sound = _row_gaps(feats["bf16"], feats["fp32"], scale)
        shifted = _row_gaps(np.roll(feats["bf16"], 1, axis=0), feats["fp32"], scale)
        out["bf16_vs_fp32"] = {"limit": GENE_BF16_GAP, "sound_max": float(sound.max()),
                               "rows_shifted_min": float(shifted.min()), "rows_shifted_max": float(shifted.max())}
        log(f"gene bf16 vs fp32 features, per gene over max|feature| {scale:.4g}: sound max {sound.max():.4g}, rows "
            f"shifted by one min {shifted.min():.4g} (limit {GENE_BF16_GAP})")
        if sound.max() > GENE_BF16_GAP:
            raise AssertionError(f"gene bf16 features differ from fp32 by {sound.max()} of max|feature|")
        if shifted.min() <= GENE_BF16_GAP:
            raise AssertionError(f"the gene bf16 limit {GENE_BF16_GAP} does not catch rows shifted by one: "
                                 f"{shifted.min()}")
    finally:
        genome.close()
    report["genes"] = out


def consensus_kernel_launches(span_len: int, phases=(0, 2)) -> Counter:
    """{(layer, L): launches} of one consensus conv batch over spans of
    ``span_len`` bases, forward and reverse complement: the full stack
    (conv4/conv5 once per pool-2 phase; a lone 2,000-bp window has one)."""
    tally = Counter()
    for _orientation in range(2):
        tally.update(conv_stack(span_len, phases))
    return tally


def consensus_kernel_phase(report: dict) -> None:
    """Every conv shape the consensus engines give the kernels, on each
    dtype's route, held against the fp32 plain version before anything is
    timed: the backbone forward (one span of CONS_SPAN) and the patch
    batches (704-base sub-spans, N·K for CONS_PATCH_SHAPES), each also timed
    beside its plain version, ``F.conv1d`` and the bound; the dedup engine's
    window batch (CONS_BATCH windows of 2,000 bp) and a fallback span chunk
    (5 spans), checked and timed."""
    import torch

    from expecto_tpu_torch.ops.spans import PATCH_SUB_LEN

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(4)
    cases = [("backbone", 1, CONS_SPAN, True)]
    cases += [(f"patch N={n} K={k}", n * k, PATCH_SUB_LEN, True) for n, k in CONS_PATCH_SHAPES]
    cases += [("dedup windows", CONS_BATCH, 2000, False), ("fallback spans", CONS_BATCH // GENE_SHIFTS, CONS_SPAN, False)]
    rows, chunk_ms = [], {}
    for what, n, span_len, yardsticks in cases:
        launches = consensus_kernel_launches(span_len, (0,) if span_len == 2000 else (0, 2))
        n_rows, ms = _chunk_conv_rows(n, launches, gen, f"consensus {what}", yardsticks=yardsticks)
        for r in n_rows:
            r["case"] = what
        rows += n_rows
        chunk_ms[what] = ms
        log(f"consensus {what} ({n} spans of {span_len}, {sum(launches.values())} launches): kernels fp32 "
            f"{ms['fp32']:.3f} ms, bf16 {ms['bf16']:.3f} ms; max |err| fp32 "
            f"{max(r['fp32']['max_abs_err'] for r in n_rows):.3g}, bf16 {max(r['bf16']['max_abs_err'] for r in n_rows):.3g}")
        if yardsticks:
            for tag in ("fp32", "bf16"):
                log(f"  {tag}: bound {_weighted(n_rows, tag, 'bound_ms'):.3f} ms, plain "
                    f"{_weighted(n_rows, tag, 'plain_ms'):.3f} ms, F.conv1d {_weighted(n_rows, tag, 'library_ms'):.3f} ms; "
                    + ", ".join(f"{r['layer']} L={r['L']} {r[tag]['ms']:.4f} ms ({100 * r[tag]['bound_ms'] / r[tag]['ms']:.0f} %"
                                f" of bound, conv1d {r[tag]['library_ms']:.4f})" for r in n_rows))
    report["consensus_layers"] = rows
    report["consensus_chunk_kernel_ms"] = chunk_ms


def consensus_cohort(seed: int, n_samples: int, *, private: bool, n_sites: int = 42) -> list:
    """bench.py's cohort generator (``_consensus_cohort_seqs``), seeded from
    ``seed`` (seed 0 gives bench.py's cohorts): one gene's records sharing a
    random 393,216-bp backbone, TSS at len // 2, '+' strand. ``private=False``:
    ``n_sites`` shared segregating sites within 21 kb of the TSS, each
    carried w.p. 0.5; ``private=True``: every sample mutates its own
    ``n_sites`` random positions there."""
    import numpy as np

    from expecto_tpu_torch.pipeline.consensus import ENFORMER_SEQ_LENGTH

    rng = np.random.default_rng(3 + seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    backbone = rng.integers(0, 4, size=ENFORMER_SEQ_LENGTH, dtype=np.int64)
    center = ENFORMER_SEQ_LENGTH // 2
    covered = np.arange(center - 21000, center + 21000)
    seqs = []
    if private:
        for _ in range(n_samples):
            arr = backbone.copy()
            sites = rng.choice(covered, size=n_sites, replace=False)
            arr[sites] = (arr[sites] + rng.integers(1, 4, size=len(sites))) % 4
            seqs.append((bases[arr].tobytes().decode("latin-1"), "+"))
        return seqs
    sites = rng.choice(covered, size=n_sites, replace=False)
    site_alt = (backbone[sites] + rng.integers(1, 4, size=len(sites))) % 4
    for _ in range(n_samples):
        arr = backbone.copy()
        carry = rng.random(len(sites)) < 0.5
        arr[sites[carry]] = site_alt[carry]
        seqs.append((bases[arr].tobytes().decode("latin-1"), "+"))
    return seqs


def consensus_check_cohort(seed: int) -> tuple[list, dict]:
    """'-' strand records for the checks (not timed): a backbone copy first,
    8 records in each K bucket of 8, 16 and 24 (5-8, 9-16 and 17-24 sites
    on a grid at least 1,200 bp apart within 20 kb of the TSS, so each site
    is its own range), a duplicate, and a record with one base deleted 15 kb
    upstream of the TSS (a base appended), which differs from the backbone
    everywhere past it and must fall back to the span path. Returns the
    records and {"8"/"16"/"24"/"trivial"/"fallback": record indices}."""
    import numpy as np

    from expecto_tpu_torch.pipeline.consensus import ENFORMER_SEQ_LENGTH

    rng = np.random.default_rng(seed + 7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    tss = ENFORMER_SEQ_LENGTH // 2
    bb = rng.integers(0, 4, size=ENFORMER_SEQ_LENGTH)
    grid = tss - 20000 + 1600 * np.arange(25) + rng.integers(0, 400, size=25)

    def seq(a):
        return bases[a].tobytes().decode("latin-1")

    recs, groups = [(seq(bb), "-")], {"trivial": [0]}
    for lo, hi, k8 in ((5, 8, "8"), (9, 16, "16"), (17, 24, "24")):
        for _ in range(8):
            k = int(rng.integers(lo, hi + 1))
            sites = rng.choice(grid, size=k, replace=False)
            a = bb.copy()
            a[sites] = (a[sites] + rng.integers(1, 4, size=k)) % 4
            groups.setdefault(k8, []).append(len(recs))
            recs.append((seq(a), "-"))
    recs.append(recs[groups["8"][0]])
    groups["fallback"] = [len(recs)]
    recs.append((seq(np.concatenate([np.delete(bb, tss - 15000), bb[:1]])), "-"))
    return recs, groups


def _patch_starts(bb, rows, offsets, max_ranges: int):
    """(starts_f, starts_r) of ``rows`` against backbone ``bb`` as the cohort
    engine plans them (ops/spans.conv6_patch_sites_plan on the forward and
    the mirrored diff positions), K padded to a multiple of 8."""
    import numpy as np

    from expecto_tpu_torch.ops.spans import conv6_patch_sites_plan

    span_len = rows.shape[1]
    phases_f = {(o // 4) % 4 for o in offsets}
    phases_r = {((span_len - 2000 - o) // 4) % 4 for o in offsets}
    plans = []
    for r in rows:
        dp = np.nonzero(r != bb)[0]
        plans.append((conv6_patch_sites_plan(dp, span_len, phases_f, max_ranges=max_ranges),
                      conv6_patch_sites_plan((span_len - 1 - dp)[::-1], span_len, phases_r, max_ranges=max_ranges)))
    if any(p is None for plan in plans for p in plan):
        raise AssertionError("a record of a patch check has no patch plan")
    k = max(8, -(-max(len(p) for plan in plans for p in plan) // 8) * 8)
    sf, sr = (np.zeros((len(rows), k, 2), np.int32) for _ in range(2))
    for m, (pf, pr) in enumerate(plans):
        if pf:
            sf[m, : len(pf)] = pf
        if pr:
            sr[m, : len(pr)] = pr
    return sf, sr


CONS_ENGINES = ("predict_codes", "predict_span_codes", "predict_spans_project", "project_spans_backbone_patch")


class _EngineSpy:
    """Records (method, rows, K) of every engine call the consensus
    pipelines make on a runner."""

    def __init__(self, runner):
        self.calls = []
        for name in CONS_ENGINES:
            setattr(runner, name, self._wrap(name, getattr(runner, name)))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            patch = name == "project_spans_backbone_patch"
            self.calls.append((name, len(args[1] if patch else args[0]), len(args[2][0]) if patch else None))
            return fn(*args, **kw)

        return call


def _check_engine(calls: list, engine: str, n: int, what: str) -> None:
    """The engine a pipeline took over ``n`` records, from the runner
    methods it called: ``engine`` alone (the patch at K = 8 alone), or for
    the fallback engine the span projection on most records."""
    rows_by = Counter()
    for name, rows, _k in calls:
        rows_by[name] += rows
    if engine == "predict_spans_project":  # mostly the fallback: a patch bucket may take a few
        ok = set(rows_by) <= {engine, "project_spans_backbone_patch"} and rows_by[engine] > n // 2
    elif engine == "project_spans_backbone_patch":
        ok = set(rows_by) == {engine} and {k for _n, _r, k in calls} == {8}
    else:
        ok = set(rows_by) == {engine}
    if not ok:
        raise AssertionError(f"{what}: took {calls}, expected the {engine} engine")


def _consensus_counts_checked(kind: str, calls: list, runner, what: str) -> dict:
    """The launch counts since the last _reset_counts, checked against the
    chunk arithmetic of the engine calls: a window batch (``batch_size``
    windows) is 1 conv0 + 5 conv8 an orientation, a span chunk
    (``_span_rows(200)`` spans) 1 conv0 + 7 conv8 an orientation
    (conv4/conv5 at pool-2 phases 0 and 2), and the patch method adds the
    backbone's span forward once."""
    want0 = want8 = 0
    span_rows = runner._span_rows(GENE_SHIFTS)
    for name, rows, _k in calls:
        if name == "predict_codes":
            c = -(-rows // runner.batch_size)
            want0, want8 = want0 + 2 * c, want8 + 10 * c
        else:
            c = -(-rows // span_rows) + (name == "project_spans_backbone_patch")
            want0, want8 = want0 + 2 * c, want8 + 14 * c
    counts = _read_counts(kind)
    route, other = ("simt", "tc") if kind == "float32" else ("tc", "simt")
    by_route = counts["conv8_relu_by_route"]
    if (counts["conv0_codes"], by_route[route], by_route[other]) != (want0, want8, 0):
        raise AssertionError(f"{what}: launches {counts}, expected {want0} conv0 and {want8} {route} for {calls}")
    return {"launches": counts, "engine_calls": [list(c) for c in calls]}


def _consensus_call(runner, seqs, path: str):
    """One cohort gene through the CLI's device path: ``samples
    --fp16_chromatin`` (track predictions, fp16) or ``samples
    --features_only`` (features)."""
    import numpy as np

    from expecto_tpu_torch.pipeline.consensus import _predict_consensus_features_cohort, _predict_consensus_preds

    if path == "preds":
        return _predict_consensus_preds(runner, seqs, None, dtype=np.float16)
    return _predict_consensus_features_cohort(runner, seqs, None)


def _timed_cohort(params, seqs, path: str, engine: str, dtype, batch: int, repeats: int, what: str):
    """A warm-up call, then ``repeats`` timed calls of one cohort with the
    CLI's settings (``--fp16_chromatin``'s fp16 wire for track predictions,
    an fp32 wire for features), launch counts zeroed just before each and
    checked just after. Each call's process CPU time stands beside its wall:
    on the host-bound cells the two move together when the host runs slower.
    Returns (stats, the last output)."""
    import numpy as np
    import torch

    from expecto_tpu_torch.parallel.runner import BelugaRunner

    runner = BelugaRunner(params, batch_size=batch, device=DEVICE, compute_dtype=dtype,
                          out_dtype=np.float16 if path == "preds" else np.float32)
    spy = _EngineSpy(runner)
    _consensus_call(runner, seqs, path)
    kind = str(dtype).removeprefix("torch.")
    walls, cpus = [], []
    for _ in range(repeats):
        spy.calls.clear()
        _reset_counts()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        out = _consensus_call(runner, seqs, path)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        cpus.append(time.process_time() - c0)
        _check_engine(spy.calls, engine, len(seqs), what)
        checked = _consensus_counts_checked(kind, spy.calls, runner, what)
    width = 20030 if path == "features" else GENE_SHIFTS * 2002
    if out.shape[0] != len(seqs) or out[0].size != width or not np.isfinite(out).all():
        raise AssertionError(f"{what}: output of shape {out.shape}, or not finite")
    wall = statistics.median(walls)
    return {"batch": batch, "wall_s": wall, "walls_s": walls, "cpu_s": cpus, "sample_genes_per_s": len(seqs) / wall,
            **checked}, out


def consensus_phase(report: dict, card: str, seed: int) -> None:
    """GEUVADIS consensus (``expecto-consensus``) at Beluga's widths: the four
    bench mixes timed in fp32 and bf16 at the CLI's batch (the sparse mix at
    3,200 too), each call's engine and launches checked; patch vs span per
    K; the _c1 patch against the raw one; the checks (patch vs span, card vs
    CPU, dedup vs span, bit-equal repeats, planted faults, bf16 vs fp32,
    expression); the ``ref`` CLI in fp32 and ``--bf16``."""
    import torch

    from expecto_tpu_torch.models.convert import load_params_npz

    params = load_params_npz(WORK / "beluga.npz")
    out = {"mixes": {}}
    feats = {}
    for name, n, private, n_sites, path, engine in CONS_MIXES:
        t0 = time.perf_counter()
        seqs = consensus_cohort(seed, n, private=private, n_sites=n_sites)
        mix = {"records": n, "private": private, "sites": n_sites, "path": path, "engine": engine,
               "cohort_s": time.perf_counter() - t0}
        batches = (CONS_BATCH, CONS_BATCH_WIDE) if engine == "project_spans_backbone_patch" else (CONS_BATCH,)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for batch in batches:
                key = tag if batch == CONS_BATCH else f"{tag}_batch{batch}"
                mix[key], res = _timed_cohort(params, seqs, path, engine, dtype, batch, CONS_REPEATS,
                                              f"consensus {name} {key}")
                log(f"consensus {name} {key}: {n} records in {mix[key]['wall_s']:.3f} s warm (median of "
                    f"{[round(w, 3) for w in mix[key]['walls_s']]}, CPU {[round(c, 3) for c in mix[key]['cpu_s']]}) = "
                    f"{mix[key]['sample_genes_per_s']:.2f} "
                    f"sample-genes/s; engine calls {mix[key]['engine_calls'][:4]}"
                    f"{' ...' if len(mix[key]['engine_calls']) > 4 else ''}; launches {mix[key]['launches']} [{card}]")
                if engine == "project_spans_backbone_patch" and batch == CONS_BATCH:
                    feats[tag] = res
                elif engine == "predict_codes" and tag == "fp32":
                    shared = seqs
        out["mixes"][name] = mix
        del seqs
    _consensus_checks(out, params, shared, feats, seed, card)
    _consensus_sweep(out, params, seed, card)
    _consensus_ref_cli(out, seed, card)
    report["consensus"] = out


def _consensus_checks(out: dict, params, shared: list, sparse_feats: dict, seed: int, card: str) -> None:
    """fp32 patch vs span and card vs CPU on the '-' check cohort (one record
    a bucket, the fallback and trivial rows); two equal calls of the patch
    engine; the splice planted one frame late; bf16 vs fp32 per record; the
    dedup engine vs the span path. The expression step is a smoke test of
    ``_match_features`` and the model's wiring, not of the model: the
    gblinear model runs on the host on both sides, so its card-vs-CPU gap
    is the feature gap times the weights, and its limit (the feature limit
    times sum|w|) is the Lipschitz bound that the feature check implies."""
    import numpy as np
    import torch

    from expecto_tpu_torch.genome.windows import gene_shifts
    from expecto_tpu_torch.models.gblinear import GBLinearModel
    from expecto_tpu_torch.ops import spans
    from expecto_tpu_torch.ops.decay import gene_pos_weights, pad_legacy_20030
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.consensus import (
        PATCH_MAX_RANGES,
        _match_features,
        _predict_consensus_features_cohort,
        _predict_consensus_preds,
        consensus_span_and_offsets,
    )

    pw = gene_pos_weights(gene_shifts())
    recs, groups = consensus_check_cohort(seed)
    runners = {tag: BelugaRunner(params, batch_size=CONS_BATCH, device=DEVICE, compute_dtype=dtype)
               for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    spy = _EngineSpy(runners["fp32"])
    _reset_counts()
    f32 = _predict_consensus_features_cohort(runners["fp32"], recs, None)
    torch.cuda.synchronize()
    checked = _consensus_counts_checked("float32", spy.calls, runners["fp32"], "consensus check cohort")
    # the buckets in K order (the trivial record joins the fallback beside it), then the fallback
    calls = list(spy.calls)
    want_calls = [("project_spans_backbone_patch", 8, k) for k in (8, 16, 24)] + [("predict_spans_project", 2, None)]
    if calls != want_calls:
        raise AssertionError(f"check cohort: engine calls {calls}, expected {want_calls}")
    again = _predict_consensus_features_cohort(runners["fp32"], recs, None)
    if not np.array_equal(again, f32):
        raise AssertionError(f"check cohort: two calls of the patch engine differ by {np.abs(again - f32).max()}")
    spans_offs = [consensus_span_and_offsets(s, st, align=16) for s, st in recs]
    offsets = spans_offs[0][1]
    rows = np.stack([sp for sp, _ in spans_offs])
    span32 = pad_legacy_20030(runners["fp32"].predict_spans_project(rows, offsets, pw))
    limit = CONS_FEAT_RTOL * float(np.abs(span32).max())
    errs = {"patch_vs_span": float(np.abs(f32 - span32).max())}

    # card vs CPU: one record a bucket, the fallback and the trivial rows
    picks = [groups[g][0] for g in ("8", "16", "24")]
    cpu = BelugaRunner(params, batch_size=CONS_BATCH, device="cpu")
    bb = rows[0]
    got_cpu = np.empty((len(picks) + 2, 20020), np.float32)
    for i, r in enumerate(picks):
        sf, sr = _patch_starts(bb, rows[[r]], offsets, PATCH_MAX_RANGES)
        got_cpu[i] = cpu.project_spans_backbone_patch(bb, rows[[r]], sf, sr, offsets, pw)[0]
    extra = [groups["fallback"][0], groups["trivial"][0]]
    got_cpu[len(picks):] = cpu.predict_spans_project(rows[extra], offsets, pw)
    cpu_rows = picks + extra
    errs["card_vs_cpu"] = float(np.abs(f32[cpu_rows] - pad_legacy_20030(got_cpu)).max())
    model = GBLinearModel(weight=(np.random.default_rng(seed + 9).standard_normal(20020) * 0.02).astype(np.float32),
                          bias=0.1, base_score=2.0)
    expr_card = model.predict(_match_features(f32[cpu_rows], model))
    expr_cpu = model.predict(_match_features(pad_legacy_20030(got_cpu), model))
    if expr_card.shape != (len(cpu_rows),) or not np.isfinite(expr_card).all():
        raise AssertionError(f"consensus expression: shape {expr_card.shape} or non-finite values")
    expr_limit = limit * float(np.abs(model.weight).sum())
    errs["expression_card_vs_cpu"] = float(np.abs(expr_card - expr_cpu).max())

    # planted fault: patch frames spliced one frame late
    splice = spans._splice_patch_frames
    try:
        spans._splice_patch_frames = lambda b, s, f0, n, k, ph: splice(b, s, f0 + 1, n, k, ph)
        late = {tag: _predict_consensus_features_cohort(r, recs, None) for tag, r in runners.items()}
    finally:
        spans._splice_patch_frames = splice
    patch_rows = [r for g in ("8", "16", "24") for r in groups[g]]
    errs["late_splice_fp32"] = float(np.abs(late["fp32"][patch_rows] - span32[patch_rows]).max())
    out["checks"] = {"records": len(recs), "feature_limit": limit, "expression_limit": expr_limit,
                     "max_abs_err": errs, "engine_calls": [list(c) for c in calls], "launches": checked["launches"]}
    log(f"consensus checks ('-' strand, {len(recs)} records): max |err| {errs} (feature limit {limit:.4g}, "
        f"expression smoke limit {expr_limit:.4g}); engine calls {calls}; two patch-engine calls equal bit for bit")
    for k in ("patch_vs_span", "card_vs_cpu"):
        if not errs[k] <= limit:
            raise AssertionError(f"consensus {k}: max |err| {errs[k]} over the limit {limit}")
    if not errs["expression_card_vs_cpu"] <= expr_limit:
        raise AssertionError(f"consensus expression card vs CPU: {errs['expression_card_vs_cpu']} over {expr_limit}")
    if not errs["late_splice_fp32"] > limit:
        raise AssertionError(f"the patch check's limit {limit} does not catch a splice one frame late")

    # bf16 vs fp32 per record, over max|fp32 feature|, on the check cohort and the sparse mix
    scale = float(np.abs(f32).max())
    f16 = _predict_consensus_features_cohort(runners["bf16"], recs, None)
    gaps = {"check_sound_max": float(_row_gaps(f16, f32, scale).max()),
            "check_late_splice_min": float(_row_gaps(late["bf16"][patch_rows], f32[patch_rows], scale).min()),
            "check_late_splice_max": float(_row_gaps(late["bf16"][patch_rows], f32[patch_rows], scale).max()),
            "sparse_sound_max": float(_row_gaps(sparse_feats["bf16"], sparse_feats["fp32"],
                                                float(np.abs(sparse_feats["fp32"]).max())).max())}
    out["bf16_vs_fp32"] = {"limit": CONS_BF16_GAP, **gaps}
    log(f"consensus bf16 vs fp32 features per record over max|feature|: {gaps} (limit {CONS_BF16_GAP})")
    if max(gaps["check_sound_max"], gaps["sparse_sound_max"]) > CONS_BF16_GAP:
        raise AssertionError(f"consensus bf16 features differ from fp32 by more than {CONS_BF16_GAP}: {gaps}")
    if not gaps["check_late_splice_max"] > CONS_BF16_GAP:
        raise AssertionError(f"the bf16 limit {CONS_BF16_GAP} does not catch a splice one frame late: {gaps}")

    # the dedup engine's track predictions vs the span path's, fp32 wire
    r32 = runners["fp32"]
    spy = _EngineSpy(r32)
    dedup = _predict_consensus_preds(r32, shared, None, dtype=np.float32)
    if {c[0] for c in spy.calls} != {"predict_codes"}:
        raise AssertionError(f"shared mix fp32: engine calls {spy.calls}, expected the window dedup")
    sub = [consensus_span_and_offsets(s, st) for s, st in shared[:CONS_SWEEP_ROWS]]
    span_preds = r32.predict_span_codes(np.stack([sp for sp, _ in sub]), sub[0][1], rc_mode="average")
    err = float(np.abs(dedup[:CONS_SWEEP_ROWS] - span_preds).max())
    out["dedup_vs_span"] = {"records": CONS_SWEEP_ROWS, "max_abs_err": err, "limit": CONS_PRED_ATOL,
                            "unique_windows": spy.calls[0][1]}
    log(f"consensus dedup engine vs span path (fp32, {CONS_SWEEP_ROWS} records x 200 shifts): max |err| {err:.3g} "
        f"(limit {CONS_PRED_ATOL}); {spy.calls[0][1]} unique windows for {len(shared)} records")
    if not err <= CONS_PRED_ATOL:
        raise AssertionError(f"consensus dedup vs span path: max |err| {err} over {CONS_PRED_ATOL}")
    del runners, r32
    torch.cuda.empty_cache()


def _sweep_rows(seed: int, k: int, n: int):
    """(backbone span, (n, CONS_SPAN) samples, '+' offsets): each sample has
    k sites at least 800 bp apart, so k patch ranges."""
    import numpy as np

    rng = np.random.default_rng(seed + 11 + k)
    bb = rng.integers(0, 4, size=CONS_SPAN).astype(np.int8)
    rows = np.stack([bb] * n)
    grid = 600 + (CONS_SPAN - 1200) * np.arange(k) // k
    for i in range(n):
        sites = grid + rng.integers(0, 40, size=k)
        rows[i, sites] = (rows[i, sites] + 1) % 4
    return bb, rows, tuple(range(0, 39_801, 200))


def _consensus_sweep(out: dict, params, seed: int, card: str) -> None:
    """Patch vs span on the same CONS_SWEEP_ROWS records (one chunk at batch
    3,200) at K = 8, 16, 24 and 48 ranges a record, median of three calls
    each, both dtypes, fp32 features of the two held together; then the
    conv1-reusing _c1 patch against the raw patch and the full forward
    (phase buffers only, forward orientation, N = 16, K = 8)."""
    import numpy as np
    import torch

    from expecto_tpu_torch.genome.windows import gene_shifts
    from expecto_tpu_torch.ops.decay import gene_pos_weights
    from expecto_tpu_torch.ops.spans import conv1_acts, conv6_phases, conv6_phases_patch_sites, conv6_phases_patch_sites_c1
    from expecto_tpu_torch.parallel.runner import BelugaRunner

    pw = gene_pos_weights(gene_shifts())
    sweep = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        runner = BelugaRunner(params, batch_size=CONS_BATCH_WIDE, device=DEVICE, compute_dtype=dtype)
        for k in CONS_SWEEP_K:
            bb, rows, offsets = _sweep_rows(seed, k, CONS_SWEEP_ROWS)
            sf, sr = _patch_starts(bb, rows, offsets, max_ranges=max(CONS_SWEEP_K))
            if sf.shape[1] != k:
                raise AssertionError(f"sweep K={k}: planned {sf.shape[1]} ranges a record")
            calls = {"patch": lambda: runner.project_spans_backbone_patch(bb, rows, sf, sr, offsets, pw),
                     "span": lambda: runner.predict_spans_project(rows, offsets, pw)}
            res, walls = {}, {m: [] for m in calls}
            for m, fn in calls.items():
                res[m] = fn()  # warm-up
            for _ in range(CONS_REPEATS):
                for m, fn in calls.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[m].append(time.perf_counter() - t0)
            cell = {m: statistics.median(w) for m, w in walls.items()}
            cell["span_over_patch"] = cell["span"] / cell["patch"]
            cell["max_abs_err"] = float(np.abs(res["patch"] - res["span"]).max())
            cell["limit"] = CONS_FEAT_RTOL * float(np.abs(res["span"]).max())
            if tag == "fp32" and not cell["max_abs_err"] <= cell["limit"]:
                raise AssertionError(f"sweep K={k}: fp32 patch vs span max |err| {cell['max_abs_err']} over {cell['limit']}")
            sweep[f"{tag} K={k}"] = cell
            log(f"consensus patch vs span {tag} K={k} ({CONS_SWEEP_ROWS} records): patch {cell['patch']:.4f} s, span "
                f"{cell['span']:.4f} s, span/patch {cell['span_over_patch']:.3f}; max |err| {cell['max_abs_err']:.3g} "
                f"(fp32 limit {cell['limit']:.3g}) [{card}]")
        # the _c1 patch vs the raw patch vs the full forward: phase buffers only
        bb, rows, offsets = _sweep_rows(seed, 8, CONS_SWEEP_ROWS)
        sf, _sr = _patch_starts(bb, rows, offsets, max_ranges=8)
        phases = {(o // 4) % 4 for o in offsets}
        p = runner.params
        x = runner._dev(rows)
        base_x = runner._dev(bb[None])
        base = conv6_phases(p, base_x, phases)
        base_c1 = conv1_acts(p, base_x)
        w0, d0 = runner._dev(sf[..., 0]), runner._dev(sf[..., 1])
        c1 = conv6_phases_patch_sites_c1(p, base_c1, base, x, w0, d0, phases)
        raw = conv6_phases_patch_sites(p, base, x, w0, phases)
        c1_err = max(float((c1[ph].float() - raw[ph].float()).abs().max()) for ph in phases)
        cell = {"c1_ms": cuda_ms(lambda: conv6_phases_patch_sites_c1(p, base_c1, base, x, w0, d0, phases), reps=3),
                "raw_ms": cuda_ms(lambda: conv6_phases_patch_sites(p, base, x, w0, phases), reps=3),
                "full_ms": cuda_ms(lambda: conv6_phases(p, x, phases), reps=3), "c1_vs_raw_max_abs": c1_err}
        sweep[f"{tag} c1"] = cell
        log(f"consensus _c1 vs raw patch {tag} (N={CONS_SWEEP_ROWS}, K=8, fwd phase buffers): c1 {cell['c1_ms']:.3f} ms, "
            f"raw {cell['raw_ms']:.3f} ms, full forward {cell['full_ms']:.3f} ms; max |c1 - raw| {c1_err:.3g} [{card}]")
        if tag == "fp32" and not c1_err <= 1e-4 * max(1.0, max(float(raw[ph].abs().max()) for ph in phases)):
            raise AssertionError(f"_c1 patch differs from the raw patch by {c1_err}")
        del runner, x, base, base_c1, c1, raw
        torch.cuda.empty_cache()
    out["patch_vs_span"] = sweep


def make_consensus_ref_inputs(seed: int) -> tuple[Path, Path]:
    """A consensus_dir of CONS_REF_GENES genes (ref.fa each, alternating
    strands) and its genes csv under build/chip_smoke."""
    import numpy as np

    from expecto_tpu_torch.pipeline.consensus import ENFORMER_SEQ_LENGTH

    rng = np.random.default_rng(seed + 13)
    bases = np.frombuffer(b"ACGT", np.uint8)
    root = WORK / "consensus_ref"
    lines = []
    for g in range(CONS_REF_GENES):
        start = 10_000 + g * 500_000
        (root / f"cgene{g}").mkdir(parents=True, exist_ok=True)
        seq = bases[rng.integers(0, 4, size=ENFORMER_SEQ_LENGTH)].tobytes().decode()
        (root / f"cgene{g}" / "ref.fa").write_text(f">chr1:{start}-{start + ENFORMER_SEQ_LENGTH - 1}\n{seq}\n")
        lines.append(f"ENSG{g:011d},chr1,{start + ENFORMER_SEQ_LENGTH // 2},CGENE{g},{'+-'[g % 2]}")
    (WORK / "consensus_genes.csv").write_text("\n".join(lines) + "\n")
    return root, WORK / "consensus_genes.csv"


def _consensus_ref_cli(out: dict, seed: int, card: str) -> None:
    """``python -m expecto_tpu_torch.cli.consensus ref`` (its ``main``,
    weights loaded) on the card in fp32 and with ``--bf16``: its CSV equals
    the in-process call with the same settings."""
    import numpy as np
    import pandas as pd
    import torch

    from expecto_tpu_torch.cli.consensus import main as consensus_main
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.consensus import predict_ref_all_genes

    cdir, genes = make_consensus_ref_inputs(seed)
    model = str(WORK / "models" / "tissue000.save")
    res = {}
    for tag, dtype, flags in (("fp32", torch.float32, []), ("bf16", torch.bfloat16, ["--bf16"])):
        out_dir = WORK / f"consensus_ref_{tag}"
        _reset_counts()
        t0 = time.perf_counter()
        rc = consensus_main(["ref", model, str(cdir), str(genes), "--beluga_weights", str(WORK / "beluga.npz"),
                             "-o", str(out_dir), "--device", DEVICE, *flags])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"consensus ref CLI ({tag}) returned {rc}")
        counts = _read_counts(str(dtype).removeprefix("torch."))
        csv = pd.read_csv(out_dir / "ref_preds.csv", float_precision="round_trip")
        runner = BelugaRunner(load_params_npz(WORK / "beluga.npz"), batch_size=CONS_BATCH, device=DEVICE,
                              compute_dtype=dtype)
        want = predict_ref_all_genes(model, str(cdir), str(genes), runner, str(WORK / f"consensus_ref_inproc_{tag}"))
        if csv.shape != (CONS_REF_GENES, 2) or not np.isfinite(csv["ref_preds"]).all():
            raise AssertionError(f"consensus ref CLI ({tag}): CSV of shape {csv.shape}, or not finite")
        pd.testing.assert_frame_equal(csv, want)
        res[tag] = {"cli_wall_s": wall, "launches": counts, "ref_preds": csv["ref_preds"].tolist()}
        log(f"consensus ref CLI {tag}: {CONS_REF_GENES} genes in {wall:.3f} s (weights loaded); CSV equals the "
            f"in-process call; launches {counts} [{card}]")
        del runner
        torch.cuda.empty_cache()
    out["ref_cli"] = res


def make_train_inputs(seed: int) -> dict:
    """Seeded training tables at the published shape under
    build/chip_smoke/train: ``geneanno.csv`` (24,338 genes, the real
    columns; about 22,000 train genes and 900 on chr8; some rRNA genes),
    ``Xreducedall.npy`` (24,338 x 20,020 fp32, standard normal, drawn on the
    card) and ``expression.csv`` (218 tissue columns: the exponential of a
    sparse linear model of the features plus noise; 1 % of the genes NaN in
    every tissue, so the label filter acts, and some zero entries)."""
    import numpy as np
    import pandas as pd
    import torch

    d = WORK / "train"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed + 8)
    n, f, k = TRAIN_GENES, TRAIN_FEATURES, TRAIN_TISSUES
    chroms = np.concatenate([np.repeat(list(TRAIN_CHROMS), list(TRAIN_CHROMS.values())),
                             rng.choice([f"chr{c}" for c in range(1, 23) if c not in (7, 8)],
                                        size=n - sum(TRAIN_CHROMS.values()))])
    rng.shuffle(chroms)
    gtype = rng.choice(["protein_coding", "lincRNA", "rRNA"], size=n, p=[0.8, 0.198, 0.002])
    geneanno = pd.DataFrame({
        "id": [f"ENSG{i:011d}" for i in range(n)], "symbol": [f"G{i}" for i in range(n)], "seqnames": chroms,
        "strand": rng.choice(["+", "-"], size=n), "TSS": rng.integers(1, 2 * 10**8, size=n),
        "CAGE_representative_TSS": rng.integers(1, 2 * 10**8, size=n), "type": gtype,
    })
    geneanno.to_csv(d / "geneanno.csv", index=False)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    X = torch.randn((n, f), generator=gen, device=DEVICE)
    w_true = torch.randn((f, k), generator=gen, device=DEVICE) * (torch.rand((f, k), generator=gen, device=DEVICE)
                                                                  < 0.01)
    torch.backends.cuda.matmul.allow_tf32 = False
    logit = (X @ w_true) * (0.7 / (0.01 * f) ** 0.5) + 1.0 + 0.5 * torch.randn((n, k), generator=gen, device=DEVICE)
    expr = torch.exp(logit).cpu().numpy().astype(np.float64)
    X = X.cpu().numpy()
    expr[rng.random(n) < 0.01] = np.nan  # genes measured in no tissue
    expr[rng.random((n, k)) < 0.002] = 0.0
    np.save(d / "Xreducedall.npy", X)
    # np.savetxt formats the numbers several times faster than DataFrame.to_csv
    buf = io.StringIO()
    np.savetxt(buf, expr, fmt="%.7g", delimiter=",")
    with open(d / "expression.csv", "w") as fh:
        fh.write(",".join(["gene", *(f"tissue{t:03d}" for t in range(k))]) + "\n")
        fh.writelines(f"{gene},{line}\n" for gene, line in zip(geneanno["id"], buf.getvalue().splitlines()))
    return {"X": X, "geneanno": geneanno, "expression": pd.read_csv(d / "expression.csv"), "dir": d}


def _cd_inputs(b: int, k: int, alpha: float, gen):
    """(g, h, w) of shape (b, k) on the card: hessians around the 1e-5 guard
    and zero (a last block's padded rows), ties tmp == 0 (g = w = 0) and
    gradients at +-alpha (gl2 -+ alpha == 0)."""
    import torch

    g = torch.randn((b, k), generator=gen, device=DEVICE) * 30
    h = torch.rand((b, k), generator=gen, device=DEVICE) * 50 + 1e-3
    w = torch.randn((b, k), generator=gen, device=DEVICE) * 0.05
    h[:6] = torch.tensor([0.0, 5e-6, 9.99e-6, 1e-5, 1.01e-5, 2e-5], device=DEVICE)[:, None]
    h[-36:] = 0.0
    g[8:16], w[8:16] = 0.0, 0.0
    g[16:24], w[16:24] = alpha, 0.0
    g[24:32], w[24:32] = -alpha, 0.0
    return g, h, w


def device_ms(fn, reps: int = 200) -> float:
    """The card's time for one call of ``fn``: the summed duration of the
    kernels it launches over ``reps`` calls (``torch.profiler``), per call.
    Unlike :func:`cuda_ms` it leaves out the gaps in which the card waits
    for the host to issue the next launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e - s for s, e, _name in profiled_events(prof)) / 1e3 / reps


def profiled_events(prof, device: str = "cuda") -> list:
    """(start_us, end_us, name) of every event of a ``torch.profiler`` run on
    ``device`` ("cuda": kernels, copies and the annotation ranges of
    ``record_function`` spans; "cpu": host ops and spans), read from the
    profiler's raw results: building ``prof.events()`` takes seconds for a
    run of 100 training rounds."""
    import torch

    kind = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
            for e in prof.profiler.kineto_results.events() if e.device_type() == kind]


def train_kernel_phase(out: dict) -> None:
    """The coordinate-update kernel against its plain version, bit for bit,
    at each (block, models) shape of the three training calls, with alpha
    0 and > 0; then timed beside the plain version and its bound (g, h and
    w read once, w and dw written once: 20 bytes an element): the card's
    time a call (the kernel, or the plain version's kernels) and the
    time a call back to back, which the host's issue rate sets."""
    import torch

    from expecto_tpu_torch.ops.gblinear_cd import coord_update, coord_update_plain

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for b, k in TRAIN_CD_SHAPES:
        for alpha in (0.0, 0.7, 25.0):
            g, h, w = _cd_inputs(b, k, alpha, gen)
            w_plain = w.clone()
            dw = coord_update(g, h, w, 0.01, 100.0, alpha)
            want = coord_update_plain(g, h, w_plain, 0.01, 100.0, alpha)
            torch.cuda.synchronize()
            if not (torch.equal(dw.view(torch.int32), want.view(torch.int32))
                    and torch.equal(w.view(torch.int32), w_plain.view(torch.int32))):
                raise AssertionError(f"gblinear_cd ({b}, {k}) alpha {alpha}: the kernel and the plain version differ "
                                     f"(max |dw - plain| {float((dw - want).abs().max())})")
            if bool((dw[h < 1e-5] != 0).any()):
                raise AssertionError(f"gblinear_cd ({b}, {k}): a hessian below 1e-5 gave a nonzero update")
        kernel, plain = (lambda: coord_update(g, h, w, 0.01, 100.0, 25.0),
                         lambda: coord_update_plain(g, h, w, 0.01, 100.0, 25.0))
        row = {"B": b, "K": k, "max_abs_err": 0.0, **_bound(20.0 * b * k, 0.0, "fp32"),
               "ms": device_ms(kernel), "plain_ms": device_ms(plain),
               "call_ms": cuda_ms(kernel, reps=200, warmup=20), "plain_call_ms": cuda_ms(plain, reps=200, warmup=20)}
        rows.append(row)
        log(f"kernel gblinear_cd ({b}, {k}): equal to the plain version bit for bit (alpha 0, 0.7, 25; padded rows, "
            f"the 1e-5 guard, ties); {row['ms'] * 1e3:.2f} us on the card a launch, bound "
            f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), plain {row['plain_ms'] * 1e3:.2f} us; back to back "
            f"{row['call_ms'] * 1e3:.2f} us a call, plain {row['plain_call_ms'] * 1e3:.2f} us")
    out["cd_layers"] = rows


def _round_trace(prof, rounds: int) -> dict:
    """From a ``torch.profiler`` run of one training call: each round's
    device range (the ``gblinear_round`` annotation: first kernel to last),
    the card's busy time inside those ranges (the union of kernel and copy
    intervals) and its kernel time by kind: the coordinate-update kernel,
    torch's elementwise and reduction kernels, and the products (every
    other kernel: cuBLAS's GEMV/GEMM); and the whole call's busy time."""
    ranges, dev = [], []
    for ev in profiled_events(prof):
        (ranges if ev[2] == "gblinear_round" else dev).append(ev)
    if len(ranges) != rounds:
        raise AssertionError(f"the profile holds {len(ranges)} gblinear_round ranges on the card, not {rounds}")
    ranges.sort()

    def union(ivs):
        busy, last = 0.0, float("-inf")
        for s, e in sorted(ivs):
            if e > last:
                busy += e - max(s, last)
                last = e
        return busy

    by_kind = {"gblinear_cd": 0.0, "elementwise": 0.0, "products": 0.0, "copies": 0.0}
    inside = []
    j = 0
    dev.sort()
    for s, e, name in dev:
        while j < len(ranges) and ranges[j][1] < s:
            j += 1
        if j < len(ranges) and ranges[j][0] <= s and e <= ranges[j][1]:
            inside.append((s, e))
            kind = ("gblinear_cd" if "gblinear_cd" in name else "copies" if "Memcpy" in name or "Memset" in name
                    else "elementwise" if "at::native" in name else "products")
            by_kind[kind] += (e - s) / 1e3
    sweep_ms = sum(e - s for s, e, _ in ranges) / 1e3
    busy_ms = union(inside) / 1e3
    return {"rounds": rounds, "ms_per_round": (ranges[-1][1] - ranges[0][0]) / 1e3 / rounds,
            "sweep_ms_per_round": sweep_ms / rounds, "sweep_idle_share": 1 - busy_ms / sweep_ms,
            "kernel_ms_by_kind": by_kind, "call_busy_ms": union([(s, e) for s, e, _ in dev]) / 1e3}


def _profiled_train_call(fn, rounds: int):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA): its result, wall
    time and :func:`_round_trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = _round_trace(prof, rounds)
    trace["profiled_wall_s"] = wall
    trace["call_idle_share"] = 1 - trace["call_busy_ms"] / (wall * 1e3)
    return res, trace


def _launch_checked(fn, launches: int, what: str):
    """``fn()`` timed on the host clock (ending in a synchronize), with the
    coordinate-update kernel's count zeroed just before and read just after:
    it must be ``launches``."""
    import torch

    from expecto_tpu_torch.ops import gblinear_cd

    torch.cuda.synchronize()
    gblinear_cd.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = gblinear_cd.coord_update.launches
    if got != launches:
        raise AssertionError(f"{what}: {got} coordinate-update launches, expected {launches} (blocks x rounds)")
    return res, wall


def _log_train_call(what: str, c: dict, card: str) -> None:
    log(f"{what}: wall {c['wall_s']:.3f} s (profiled {c['profiled_wall_s']:.3f} s), {c['ms_per_round']:.3f} ms a "
        f"round ({c['sweep_ms_per_round']:.3f} ms of it the block sweep, idle {100 * c['sweep_idle_share']:.1f} %), "
        f"call idle {100 * c['call_idle_share']:.1f} %; sweep kernels " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in c["kernel_ms_by_kind"].items()) + f"; launches {c['launches']} [{card}]")


def train_phase(report: dict, card: str, seed: int) -> None:
    """gblinear training at the published width: the kernel checks; three
    timed calls (one tissue with its watchlist, K = 1; all 218 tissues in
    one sweep; 128 bootstrap seeds through the CLI), each launch-checked and
    profiled once for its round time and idle share; the kernel against the
    plain version swapped in and against a second run, bit for bit; the
    CLI's models against the in-process sweep; card vs CPU on a reduced
    problem with two planted faults."""
    import numpy as np
    import torch

    from expecto_tpu_torch.cli import train as train_cli
    from expecto_tpu_torch.io.xgb import load_expression_model
    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops.gblinear_cd import coord_update, coord_update_plain
    from expecto_tpu_torch.pipeline import train as ptrain

    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    inp = make_train_inputs(seed)
    out["inputs_s"] = time.perf_counter() - t0
    X, geneanno, expression = inp["X"], inp["geneanno"], inp["expression"]
    n_blocks = -(-TRAIN_FEATURES // gblinear.GBLinearParams().block_size)
    f_pad = n_blocks * gblinear.GBLinearParams().block_size
    launches = n_blocks * TRAIN_ROUNDS
    log(f"train inputs: {X.shape} features, {expression.shape[1] - 1} tissues ({out['inputs_s']:.1f} s)")
    train_kernel_phase(out)

    # one tissue, its watchlist on: the kernel's run, a rerun, and the plain version swapped in
    def one_tissue():
        return ptrain.train_expression_model(X, geneanno, expression.iloc[:, 1].values, device=DEVICE)

    k1, wall = _launch_checked(one_tissue, launches, "train_expression_model")
    gblinear.coord_update = coord_update_plain
    try:
        k1_plain, wall_plain = _launch_checked(one_tissue, 0, "train_expression_model, plain version")
    finally:
        gblinear.coord_update = coord_update
    k1_again, c = _profiled_train_call(one_tissue, TRAIN_ROUNDS)
    for other, what in ((k1_again, "a second run"), (k1_plain, "the plain version swapped in")):
        if not (np.array_equal(other.model.weight, k1.model.weight) and other.model.bias == k1.model.bias
                and other.model.eval_history == k1.model.eval_history):
            raise AssertionError(f"train_expression_model with the kernel differs from {what}")
    n_tr = len(k1.train_true)
    c.update(wall_s=wall, wall_plain_s=wall_plain, launches=launches, train_genes=n_tr,
             test_genes=len(k1.test_true), spearman=k1.spearman)
    c["products_gb_per_s"] = 2 * 4 * f_pad * n_tr * TRAIN_ROUNDS / (c["kernel_ms_by_kind"]["products"] * 1e6)
    c["products_share_of_peak_bytes"] = c["products_gb_per_s"] * 1e9 / PEAK_BYTES
    out["k1"] = c
    _log_train_call(f"train_expression_model (1 tissue, {n_tr} train genes, watchlist on)", c, card)
    log(f"  equal bit for bit to a second (profiled) run and to the plain version swapped in (wall "
        f"{wall_plain:.3f} s); block-sweep products {c['products_gb_per_s']:.1f} GB/s "
        f"({100 * c['products_share_of_peak_bytes']:.1f} % of {PEAK_BYTES / 1e12:.2f} TB/s); chr8 spearman "
        f"{k1.spearman:.4f}")
    if not (np.isfinite(k1.model.weight).all() and k1.spearman > TRAIN_MIN_SPEARMAN):
        raise AssertionError(f"one-tissue model: finite weights and a chr8 Spearman above {TRAIN_MIN_SPEARMAN} "
                             f"expected, got {k1.spearman}")
    del k1_again, k1_plain

    # every tissue in one sweep
    def all_tissues():
        return ptrain.train_all_tissues(X, geneanno, expression, vectorized=True, metrics_path=None, device=DEVICE)

    allt, wall = _launch_checked(all_tissues, launches, "train_all_tissues(vectorized=True)")
    allt_again, c = _profiled_train_call(all_tissues, TRAIN_ROUNDS)
    names = list(allt)
    if names != list(expression.columns[1:]) or not all(
            np.array_equal(allt[t].model.weight, allt_again[t].model.weight) for t in names):
        raise AssertionError("train_all_tissues: tissues missing or two runs differ")
    n_tr = len(allt[names[0]].train_true)
    c.update(wall_s=wall, launches=launches, train_genes=n_tr, tissues=len(names),
             spearman_median=float(np.median([r.spearman for r in allt.values()])))
    c["products_tflop_per_s"] = 4 * f_pad * n_tr * len(names) * TRAIN_ROUNDS / (c["kernel_ms_by_kind"]["products"]
                                                                                * 1e9)
    c["products_share_of_peak_fp32"] = c["products_tflop_per_s"] * 1e12 / PEAK_FLOPS["fp32"]
    out["k218"] = c
    _log_train_call(f"train_all_tissues (vectorized, {len(names)} tissues, {n_tr} train genes)", c, card)
    log(f"  block-sweep products {c['products_tflop_per_s']:.2f} TFLOP/s fp32 "
        f"({100 * c['products_share_of_peak_fp32']:.1f} % of {PEAK_FLOPS['fp32'] / 1e12:.0f}); median chr8 spearman "
        f"{c['spearman_median']:.4f}")
    if not (all(np.isfinite(r.model.weight).all() for r in allt.values())
            and c["spearman_median"] > TRAIN_MIN_SPEARMAN):
        raise AssertionError(f"train_all_tissues: finite weights and a median chr8 Spearman above "
                             f"{TRAIN_MIN_SPEARMAN} expected, got {c['spearman_median']}")
    del allt, allt_again

    # 128 bootstrap seeds of one tissue through the CLI
    boot_dir = inp["dir"] / "boot"
    argv = ["--targetIndex", "1", "--bootstrap_seeds", str(TRAIN_BOOT_SEEDS), "--expFile",
            str(inp["dir"] / "expression.csv"), "--inputFile", str(inp["dir"] / "Xreducedall.npy"),
            "--annoFile", str(inp["dir"] / "geneanno.csv"), "--output_dir", str(boot_dir), "--device", DEVICE]
    rc, wall = _launch_checked(lambda: train_cli.main(argv), launches, "cli.train --bootstrap_seeds")
    if rc != 0:
        raise AssertionError(f"cli.train --bootstrap_seeds exited {rc}")

    def bootstrap():
        return ptrain.train_bootstrap(X, geneanno, expression.iloc[:, 1].values, list(range(TRAIN_BOOT_SEEDS)),
                                      device=DEVICE)

    boot, c = _profiled_train_call(bootstrap, TRAIN_ROUNDS)
    for seed_j, res in enumerate(boot):
        saved = load_expression_model(boot_dir / f"bootstrap_seed{seed_j}.save")
        if not (np.array_equal(saved.weight, res.model.weight)
                and np.float32(saved.bias) == np.float32(res.model.bias)):
            raise AssertionError(f"bootstrap seed {seed_j}: the CLI's .save differs from the in-process sweep")
    c.update(cli_wall_s=wall, launches=launches, seeds=TRAIN_BOOT_SEEDS,
             spearman_mean=float(np.nanmean([r.spearman for r in boot])))
    out["boot"] = c
    log(f"cli.train --bootstrap_seeds {TRAIN_BOOT_SEEDS}: wall {wall:.3f} s (the npy and CSVs loaded, "
        f"{2 * TRAIN_BOOT_SEEDS} model files written); every seed's .save equal to the in-process sweep")
    c["wall_s"] = c["profiled_wall_s"]
    _log_train_call(f"train_bootstrap in process ({TRAIN_BOOT_SEEDS} seeds, profiled only)", c, card)
    del boot

    train_cpu_check(out, X, expression)
    report["train"] = out


def train_cpu_check(out: dict, X, expression) -> None:
    """``train_gblinear_multi`` on the card against the CPU on a reduced
    problem (the first rows, the first tissues, the published feature width,
    an L1 weight), weights within TRAIN_CPU_RTOL of max|w|; one round fewer
    and alpha's sign swapped, both on the card, must exceed that limit."""
    import numpy as np

    from expecto_tpu_torch.models import gblinear

    rows = slice(0, TRAIN_SMALL_ROWS)
    Y = np.log(expression.iloc[rows, 1:1 + TRAIN_SMALL_K].fillna(1.0).values + 1e-4).astype(np.float32)
    Xs = X[rows]

    def run(device, rounds=TRAIN_SMALL_ROUNDS, alpha=TRAIN_SMALL_ALPHA):
        hp = gblinear.GBLinearParams(num_round=rounds, reg_alpha=alpha)
        return gblinear.train_gblinear_multi(Xs, Y, hp, device=device)

    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    limit = TRAIN_CPU_RTOL * float(np.abs(cpu.weights).max())
    gaps = {}
    for what, res in (("card", run(DEVICE)), ("one round fewer", run(DEVICE, rounds=TRAIN_SMALL_ROUNDS - 1)),
                      ("alpha's sign swapped", run(DEVICE, alpha=-TRAIN_SMALL_ALPHA))):
        gaps[what] = float(np.abs(res.weights - cpu.weights).max())
        if what == "card":
            bias_gap = float(np.abs(res.biases - cpu.biases).max())
    if not (gaps["card"] <= limit and bias_gap <= 1e-5):
        raise AssertionError(f"card vs CPU: weights {gaps['card']} (limit {limit}), biases {bias_gap} (limit 1e-5)")
    for what in ("one round fewer", "alpha's sign swapped"):
        if gaps[what] <= limit:
            raise AssertionError(f"the planted fault '{what}' stays within the card-vs-CPU limit: {gaps[what]}")
    out["cpu_check"] = {"rows": TRAIN_SMALL_ROWS, "models": TRAIN_SMALL_K, "rounds": TRAIN_SMALL_ROUNDS,
                        "alpha": TRAIN_SMALL_ALPHA, "limit": limit, "max_abs_w": float(np.abs(cpu.weights).max()),
                        "bias_gap": bias_gap, "cpu_s": cpu_s, **{f"gap_{k}": v for k, v in gaps.items()}}
    fewer, swapped = gaps["one round fewer"], gaps["alpha's sign swapped"]
    log(f"train card vs CPU ({TRAIN_SMALL_ROWS} rows x {TRAIN_FEATURES} features, K {TRAIN_SMALL_K}, "
        f"{TRAIN_SMALL_ROUNDS} rounds, alpha {TRAIN_SMALL_ALPHA}): weights {gaps['card']:.3g} (limit {limit:.3g} = "
        f"{TRAIN_CPU_RTOL:g} x max|w|), biases {bias_gap:.3g}; planted faults: one round fewer {fewer:.3g}, "
        f"alpha's sign swapped {swapped:.3g}")


def gblinear_cd_entry(train: dict) -> dict:
    """The kernel line's entry of the coordinate-update kernel: its time on
    the card, its plain version's and its bound at the one-tissue call's
    shape (512, 1), whose timed run gives ``launches``; the times a call
    back to back (``call_ms``); the same at K = 128 and 218 and the launches
    of the other two timed calls beside them."""
    cd = {r["K"]: r for r in train["cd_layers"]}
    return {
        "name": "gblinear_cd", "route": "cuda", "source": "expecto_tpu_torch/csrc/gblinear_cd.cu",
        "replaces": "expecto_tpu/models/gblinear.py:92",
        "replaces_what": "_coord_delta with the eta scale and weight update of the block steps (:125-127, "
                         ":249-251): an XLA fusion, no pallas_call",
        "launches": train["k1"]["launches"], "max_abs_err": max(r["max_abs_err"] for r in cd.values()),
        "ms": cd[1]["ms"], "plain_ms": cd[1]["plain_ms"], "bound_ms": cd[1]["bound_ms"], "bound_by": cd[1]["bound_by"],
        "library_ms": None, "shape": [cd[1]["B"], 1], "call_ms": cd[1]["call_ms"],
        "plain_call_ms": cd[1]["plain_call_ms"],
        **{f"{key}_k{k}": cd[k][key] for k in (128, 218) for key in ("ms", "plain_ms", "bound_ms", "call_ms")},
        "launches_k218": train["k218"]["launches"], "launches_bootstrap_k128": train["boot"]["launches"],
    }


def kernel_table(report: dict) -> dict:
    """The kernel line: one entry per hand-written kernel, over the launches
    of one substitution chunk that its main path gives it (each shape
    weighted by its launches there): the tc kernel at bf16 conv1-conv5 and
    the code-gather kernel at bf16 conv0, whose ``launches`` are the bf16
    serving run's; the SIMT kernel at fp32 conv1-conv5, whose ``launches``
    are the fp32 parity run's on the card. ``launches_h5_*`` are the timed
    h5-contract chromatin runs', ``h5_chunk_ms`` the kernel's time in one
    full pair chunk of them; ``launches_gene_*`` are the timed gene-feature
    calls', ``gene_chunk_ms`` the kernel's time in one gene chunk of them
    (16 spans of 41,800 bp); ``max_abs_err`` covers every path's shapes.
    Per-shape numbers in ``layers``, ``h5_layers`` and ``gene_layers``."""
    conv8, conv0 = report["conv8_layers"], report["conv0_layers"]
    h5_full = [r for r in report["h5_layers"] if r["N"] == H5_CHUNK_N[0]]
    serve, parity = report["main_path"]["launches"], report["parity"]["launches"]
    h5 = {t: report["h5_contract"][t]["launches"] for t in ("fp32", "bf16")}
    gene = {t: report["genes"][t]["launches"] for t in ("fp32", "bf16")}
    mixes = report["consensus"]["mixes"].values()
    cons_cases = ["backbone"] + [f"patch N={n} K={k}" for n, k in CONS_PATCH_SHAPES]

    def cons_launches(tag: str, route: str) -> int:
        """The launches of the last timed call of each consensus mix at the
        CLI's batch, summed."""
        return sum(m[tag]["launches"]["conv0_codes"] if route == "codes"
                   else m[tag]["launches"]["conv8_relu_by_route"][route] for m in mixes)

    def cons_ms(tag: str, conv0: bool, key: str = "ms") -> dict:
        """{case: launch-weighted ms} of the backbone forward and each patch batch."""
        return {c: _weighted([r for r in report["consensus_layers"] if r["case"] == c and (r["layer"] == "conv0") == conv0],
                             tag, key) for c in cons_cases}

    def entry(name, source, rows, tag, launches, **extra):
        """``tag``'s numbers on the main path's route of each shape."""
        h5_rows = [r for r in report["h5_layers"] if (r["layer"] == "conv0") == (name == "conv0_codes")]
        gene_rows = [r for r in report["gene_layers"] if (r["layer"] == "conv0") == (name == "conv0_codes")]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": "expecto_tpu/ops/pallas_conv.py:49",
            "launches": launches,
            "max_abs_err": max(r[tag]["max_abs_err"] for r in rows + h5_rows + gene_rows),
            "ms": _weighted(rows, tag, "ms"),
            "plain_ms": _weighted(rows, tag, "plain_ms"), "bound_ms": _weighted(rows, tag, "bound_ms"),
            "bound_by": "operations" if _weighted(rows, tag, "ops_ms") >= _weighted(rows, tag, "bytes_ms") else "bytes",
            "library_ms": _weighted(rows, tag, "library_ms"), "dtype": tag,
            "h5_chunk_ms": _weighted([r for r in h5_full if r in h5_rows], tag, "ms"),
            "gene_chunk_ms": _weighted(gene_rows, tag, "ms"), "gene_chunk_bound_ms": _weighted(gene_rows, tag, "bound_ms"),
            "gene_chunk_library_ms": _weighted(gene_rows, tag, "library_ms"), **extra,
        }

    return {"kernels": [
        entry("conv8_relu_tc", "expecto_tpu_torch/csrc/conv8_relu_tc.cu", conv8, "bf16",
              serve["conv8_relu_by_route"]["tc"], sass_hgmma=report["sass_hgmma"],
              launches_h5_bf16=h5["bf16"]["conv8_relu_by_route"]["tc"],
              launches_gene_bf16=gene["bf16"]["conv8_relu_by_route"]["tc"],
              launches_consensus_bf16=cons_launches("bf16", "tc"), consensus_ms=cons_ms("bf16", False),
              consensus_bound_ms=cons_ms("bf16", False, "bound_ms"),
              consensus_library_ms=cons_ms("bf16", False, "library_ms")),
        entry("conv8_relu", "expecto_tpu_torch/csrc/conv8_relu.cu", conv8, "fp32",
              parity["conv8_relu_by_route"]["simt"], launches_run="fp32 parity",
              launches_h5_fp32=h5["fp32"]["conv8_relu_by_route"]["simt"],
              launches_gene_fp32=gene["fp32"]["conv8_relu_by_route"]["simt"],
              launches_consensus_fp32=cons_launches("fp32", "simt"), consensus_ms=cons_ms("fp32", False),
              consensus_bound_ms=cons_ms("fp32", False, "bound_ms"),
              consensus_library_ms=cons_ms("fp32", False, "library_ms"),
              bf16_ms=sum(r["bf16"]["simt"]["ms"] * r["launches_per_chunk"] for r in conv8),
              min_shape_bound_share=report["simt_fp32_chunk"]["min_shape_share"],
              sass_ffma=report["sass_simt"]["FFMA"], sass_lds=report["sass_simt"]["LDS"],
              sass_hmma=report["sass_simt"]["HMMA"], sass_hgmma=report["sass_simt"]["HGMMA"]),
        entry("conv0_codes", "expecto_tpu_torch/csrc/conv0_codes.cu", conv0, "bf16", serve["conv0_codes"],
              fp32_ms=_weighted(conv0, "fp32", "ms"), fp32_bound_ms=_weighted(conv0, "fp32", "bound_ms"),
              fp32_plain_ms=_weighted(conv0, "fp32", "plain_ms"),
              fp32_library_ms=_weighted(conv0, "fp32", "library_ms"),
              max_err_fp32=max(r["fp32"]["max_abs_err"] for r in conv0 + report["h5_layers"] + report["gene_layers"]
                               if r["layer"] == "conv0"),
              h5_chunk_fp32_ms=_weighted([r for r in h5_full if r["layer"] == "conv0"], "fp32", "ms"),
              launches_fp32_parity=parity["conv0_codes"],
              launches_h5_bf16=h5["bf16"]["conv0_codes"], launches_h5_fp32=h5["fp32"]["conv0_codes"],
              launches_gene_bf16=gene["bf16"]["conv0_codes"], launches_gene_fp32=gene["fp32"]["conv0_codes"],
              **{f"gene_chunk_fp32_{k}": _weighted([r for r in report["gene_layers"] if r["layer"] == "conv0"], "fp32",
                                                   k) for k in ("ms", "bound_ms", "library_ms")},
              launches_consensus_bf16=cons_launches("bf16", "codes"),
              launches_consensus_fp32=cons_launches("fp32", "codes"),
              consensus_ms=cons_ms("bf16", True), consensus_fp32_ms=cons_ms("fp32", True),
              consensus_fp32_bound_ms=cons_ms("fp32", True, "bound_ms"),
              consensus_fp32_library_ms=cons_ms("fp32", True, "library_ms"),
              simt_onehot_ms=_weighted(conv0, "bf16", "simt_onehot_ms")),
        gblinear_cd_entry(report["train"]),
    ], "layers": [
        {"layer": r["layer"], "N": r["N"], "L": r["L"], "Cin": r["Cin"], "Cout": r["Cout"],
         "launches_per_chunk": r["launches_per_chunk"],
         **{f"{t}_{k}": r[t][k] for t in ("fp32", "bf16") for k in ("route", "ms", "plain_ms", "library_ms", "bound_ms",
                                                                     "bound_by", "max_abs_err")},
         **({"bf16_simt_ms": r["bf16"]["simt"]["ms"]} if "simt" in r["bf16"] else {}),
         **({"bf16_simt_onehot_ms": r["bf16"]["simt_onehot_ms"], "fp32_simt_onehot_ms": r["fp32"]["simt_onehot_ms"]}
            if "simt_onehot_ms" in r["bf16"] else {})}
        for r in conv0 + conv8],
        "h5_layers": [{k: r[k] for k in ("layer", "N", "L", "Cin", "Cout", "launches_per_chunk")}
                      | {f"{t}_{k}": r[t][k] for t in ("fp32", "bf16") for k in ("route", "ms", "max_abs_err")}
                      for r in report["h5_layers"]],
        "gene_layers": [{k: r[k] for k in ("layer", "N", "L", "Cin", "Cout", "launches_per_chunk")}
                        | {f"{t}_{k}": r[t][k] for t in ("fp32", "bf16")
                           for k in ("route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                        for r in report["gene_layers"]],
        "consensus_layers": [{k: r[k] for k in ("case", "layer", "N", "L", "Cin", "Cout", "launches_per_chunk")}
                             | {f"{t}_{k}": r[t].get(k) for t in ("fp32", "bf16")
                                for k in ("route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                             for r in report["consensus_layers"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report to DIR/chip_smoke.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from expecto_tpu_torch.ops import cuda_build

    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "seed": args.seed}
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = cuda_build.build(ptxas_info=True)
    report["build_s"] = time.perf_counter() - t0
    for name, (secs, out) in built.items():
        log(f"built csrc/{name}.cu in {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    report["sass_hgmma"] = cuda_build.sass_count("conv8_relu_tc", "HGMMA")
    log(f"csrc/conv8_relu_tc.cu SASS: {report['sass_hgmma']} HGMMA instructions")
    if report["sass_hgmma"] == 0:
        raise AssertionError("the tc kernel's SASS holds no HGMMA (tensor-core) instruction")
    sass = {op: cuda_build.sass_count("conv8_relu", op) for op in ("FFMA", "LDS", "HMMA", "HGMMA")}
    report["sass_simt"] = sass
    log(f"csrc/conv8_relu.cu SASS: {sass['FFMA']} FFMA, {sass['LDS']} LDS ({sass['FFMA'] / max(1, sass['LDS']):.1f} "
        f"FFMA per LDS), {sass['HMMA']} HMMA, {sass['HGMMA']} HGMMA")
    if sass["FFMA"] == 0 or sass["HMMA"] or sass["HGMMA"]:
        raise AssertionError(f"the SIMT kernel's SASS must hold FFMA and no tensor-core instruction: {sass}")
    log(f"build phase {report['build_s']:.1f} s")

    t0 = time.perf_counter()
    kernel_phase(report)
    conv0_phase(report)
    chunk_summary(report)
    h5_kernel_phase(report)
    gene_kernel_phase(report)
    consensus_kernel_phase(report)
    log(f"kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    inputs = make_inputs(args.seed)
    log(f"inputs: {len(inputs['variants'])} variants, {inputs['n_rows']} rows ({time.perf_counter() - t0:.1f} s)")

    main_path_phase(report, inputs, card)
    t0 = time.perf_counter()
    fp32_serve_phase(report, inputs, card)
    log(f"fp32 serve phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity_phase(report, inputs)
    log(f"parity phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    h5_contract_phase(report, inputs, card)
    log(f"h5 contract phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    make_gene_inputs(args.seed)
    gene_phase(report, card)
    log(f"gene phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    consensus_phase(report, card, args.seed)
    log(f"consensus phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_phase(report, card, args.seed)
    log(f"train phase {time.perf_counter() - t0:.1f} s")

    table = kernel_table(report)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "chip_smoke.json").write_text(json.dumps({**report, **table}, indent=1))
    print(json.dumps({"kernels": table["kernels"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
