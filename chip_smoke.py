#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (expecto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Phases (any failure raises, and the script exits non-zero with no result):

1. card: name and power limit as nvidia-smi reports them;
2. build: nvcc compiles every kernel of ``expecto_tpu_torch/csrc`` for
   sm_90a, one process per source, all at once (ptxas registers and spills
   printed); the tensor-core kernels' SASS (conv1-conv5 in bf16 and in
   fp32, fc1 in bf16 and both fp32 fc1 kernels) must hold HGMMA
   instructions, the fp32 conv kernel's ptxas report no spill, and the SIMT
   kernel's SASS FFMA and no HMMA or HGMMA (``cuobjdump -sass``; its
   FFMA-to-LDS ratio is printed);
3. kernels, at every shape they run in one substitution chunk of the main
   path (227 variants; maxshift 800: the six Beluga layers over the 3,600-bp
   span and over the alt allele's patch sub-span), each held against its
   plain PyTorch version on the same inputs and timed beside it and cuDNN's
   ``F.conv1d`` (a yardstick only: the port never calls it):
   ``conv8_relu`` at conv2, conv4 and conv5 and ``conv8_relu_pool4`` at
   conv1 and conv3 (their pools fused, as the flows launch them; see 17),
   fp32 on the three-pass TF32 kernel (``csrc/conv8_relu_tf32x3.cu``,
   also within FP32_F64_REL of max|y| of a float64 product, which one
   TF32 pass must miss, and bit-equal on a second launch; with each
   shape's share of its 3xTF32 bound, the FFMA bound beside it) and on the
   SIMT kernel (route "simt", held and timed on the same work), bf16 on
   the tensor-core kernel and on the SIMT kernel (unfused, then the
   pools); ``conv0_codes_relu`` at conv0, fp32 and bf16 on the
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
   the code-gather kernel, conv1-conv5 on the tensor-core kernel, no launch
   on another route and no conv8_relu launch at Cin 4, the counts adding up, fc1 on
   its tensor-core kernel); then warm repeats of the same serving call give
   the throughput. Every later flow's counts are read the same way: a bf16
   flow's fc1 runs on the bf16 kernel (``fc1_strided_tc.cu``) and an fp32
   flow's on the three-pass TF32 kernels, each shape on the one its M routes
   to (``fc1_strided_tf32x3_swap.cu`` after one split pass up to 64 windows,
   ``fc1_strided_tf32x3.cu`` past it), never a bf16 one; the h5, gene and
   consensus span flows launch it exactly 4
   times a chunk (two orientations x two pool-2 phases) in either dtype,
   every other flow (the serves, the pipeline's, each rank of the 2-rank
   serves, the bench) at least once;
5. fp32 serve: the same serving call with ``--fp32``'s settings on the first
   256 substitutions and their genes, warm (one call first), its launch
   counts checked (conv1-conv5 on the three-pass TF32 conv kernel and no
   SIMT launch, conv0 on the code-gather kernel in fp32, fc1 on the
   three-pass TF32 kernels): the end-to-end
   throughput of parity mode;
6. parity: a few of those variants scored with ``--fp32`` on the card and on
   the CPU (plain path), REF/ALT/SED compared; the card run's counts are
   zeroed just before it and read just after (conv1-conv5 on the tf32x3
   kernel and none on another route, conv0 on the code-gather kernel in
   fp32);
7. h5 contract (``expecto-chromatin`` -> ``expecto-predict``) on all the
   main path's variants with the chromatin CLI's settings (batch 1,024; fp32
   compute and wire by default, then ``--bf16``'s bf16 compute and fp16
   wire): per dtype one in-memory call (``keep_arrays``, also the warm-up),
   then one timed call of the CLI's streaming path (the runner's sink
   writing each pair chunk into numpy arrays that stand in for the h5
   datasets, then the window rows), launch counts zeroed just before it and
   read just after (fp32: conv1-conv5 on the tf32x3 kernel; bf16: on the tc
   kernel; no launch on another route; totals equal to the chunk
   arithmetic); the
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
8. entry and exit, the user's way in and out with the port alone: the
   Beluga weights written back as a reference-layout ``deepsea.beluga.pth``
   (this script's own inversion of the converter), ``python -m
   expecto_tpu_torch.models.convert`` on it (timed), every array of its npz
   equal to beluga.npz bit for bit, ``cli.score --fp32`` on the card with
   the converted npz held to the fp32 serve phase's table (bit for bit
   expected), and the same serve on an fc1 converted without the
   permutation missing that phase's limits; ``python -m
   expecto_tpu_torch.cli.closest_genes`` (its ``main``) on the fp32 serve's
   substitutions, plain and ``--all_in_receptive_field``, against the
   seeded annotation plus the fp32 serve's genes, each table scored by
   ``cli.score --fp32`` on the card (a row a table row, every variant
   present, launch counts checked, every row shared with the fp32 serve's
   table within its limits); ``score_sed_with_clusters`` on the h5 phase's
   fp32 effects (model 0, seeded labels of the 2,002 marks in 20 clusters,
   then a seeded RSAT membership): REF and ALT equal to the h5 phase's
   ``score_sed``, the proportions equal to the contributions computed here
   and summing to 1 within 1e-5; its sed.tsv split into three chunk
   directories and ``merge_sed_batches`` equal to the unsplit rows; and
   ``utils.profiling.trace`` around a projection call and one kernel
   launch, its Chrome trace holding CUDA kernel events. Each sub-phase's
   wall is printed with the card;
9. gene features (``expecto-compute-features``) on 96 seeded genes, 48 a
   strand, three near a contig end (N-padded spans; the plus strand's
   group ships 4 bits a base, the minus strand's 2 bits and an N sideband):
   first every conv of one gene chunk (16 spans of 41,800 bp, both
   orientations, 16 launches) on each dtype's route, held against the plain
   version and timed beside it, ``F.conv1d`` and the bound (in the kernel
   phase); then ``python -m expecto_tpu_torch.cli.compute_features`` (its
   ``main``, weights loaded) in fp32 and with ``--bf16``, and three warm
   timed ``compute_gene_features`` calls with the CLI's settings in each
   dtype, launch counts zeroed just before each and checked just after (fp32: tf32x3
   only; bf16: tc only; 16 launches a chunk, every conv0 on the code-gather
   kernel); fp32 card vs CPU features on one gene a strand, the span path
   vs the per-window path (``predict_and_project``) and ``--replicate_raw``'s
   matrices projected on the host vs the features, within 1e-5 of
   max|feature|; the bf16 features per feature within fp16's step of the
   bf16 predictions projected in fp64 on the host, a limit that a projection
   contracted in bf16 and the forward half alone both exceed; bf16 vs fp32
   features per gene within a stated limit that the same comparison with
   the gene rows shifted by one exceeds;
10. GEUVADIS consensus (``expecto-consensus``) on bench.py's four cohort
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
11. pipeline: each flow at depth 1 and at its CLI's ``pipeline_depth``
   (the runner's default 4, or ``cli.compute_features``' 6) on one runner,
   in turns, PIPE_REPEATS timed calls a depth after a warm-up: serving in
   bf16 on every row and in fp32 on the fp32 serve's rows, the chromatin
   CLI's streaming h5 step in fp32, the gene call in bf16 on 768 seeded
   genes (one full gene block a strand, 24 chunks a runner call) and the
   consensus private mix's track predictions in bf16; the chunks of each
   runner call; the outputs of the two depths equal bit for bit and every
   call's launch counts equal; each depth's median wall, peak device
   memory, and the card's idle share in one
   profiled call, run under torch's sync debug mode "warn", which must
   report no synchronizing operation;
12. gblinear training (``expecto-train``) at the published width: a
   seeded gene table of 24,338 genes (about 22,000 train genes, 900 on
   chr8, rRNA genes and NaN labels), 24,338 x 20,020 fp32 features and 218
   tissues, the reference's hyperparameters, 100 rounds of 40 feature
   blocks: the coordinate-update kernel against its plain version bit for
   bit at (512, K) for K = 1, 128, 218, 256 and 1,000 (padded rows, the
   1e-5 guard, L1, ties), timed beside it and its bound; the K-model block
   step's two kernels (gradient with the coordinate update, residual) at K
   = 1, 128, 218, 256 and 1,000 on the rows of the call that runs each: G
   and r's increment within TRAIN_BLOCK_REL of max|.| against float64
   (late-row faults must miss), w and dw the coordinate step on the
   kernel's G bit for bit, the fused one-rank update equal to the split
   route, reruns equal, timed beside their bounds, the plain block step and
   the torch block step they replaced (which they must beat at K > 1); one
   tissue with its
   watchlist (``train_expression_model``), which launches the round kernel
   once a round and the coordinate update never, equal bit for bit to a
   second run and, with the plain round (the per-block loop) swapped in,
   within 1e-5 of max|w| (weights), 1e-6 (bias) and 1e-5 (RMSE history),
   limits that the plain round with a stale residual (r not advanced after
   the first block) must miss; its training RMSE, taken from r, within 1e-5
   of the same call with the training set passed as a copy (the product
   form), and both calls' peak device memory; the round kernel at the
   published shape against the plain round over one round (and a bit-equal
   rerun), timed beside the plain round, a CUDA-graph replay of the plain
   round (a yardstick of what removing the launches alone buys) and its
   bound, its plan's invariants (:func:`_check_round_geometry`) and its
   SASS free of local loads and stores; all
   218 tissues in one sweep (``train_all_tissues``); 128 bootstrap seeds
   through ``python -m expecto_tpu_torch.cli.train`` (its ``main``), each
   seed's ``.save`` equal to the in-process sweep. Each call's launches are
   zeroed just before it and checked just after (one round kernel a round
   at K = 1; at K = 218 and 128 the block step's two kernels 40 times a
   round each and no coordinate update), and each is
   profiled once for its time a round, the block sweep's kernels and the
   card's idle share. Then the card against the CPU on 2,048 rows, 8
   tissues and 20 rounds with an L1 weight (launch-checked), within 1e-5
   of max|w|, which one round fewer and alpha's sign swapped must exceed.
   Then the round
   kernel's two shared-memory plans: ``train_gblinear`` at 512 features
   with the rows drawn on the card, at the "shared" plan's row cap (8,192
   rows a CTA: about 1.08 million rows) and one row past it (the "streamed" plan), one
   round-kernel launch a round either way, each within the round limits of
   the plain round. The single-tissue CLI mode (plots) and
   ``--allTissues`` (``metrics.h5``) run on the CPU tests only;
13. analysis (``expecto-analysis``), host code over the card's own outputs:
   each subcommand of ANALYSIS_ON_CARD through ``cli.analysis``'s ``main``
   in process under build/chip_smoke/analysis, each wall logged with the
   card: ``bootstrap-coefficients --no_plots`` on the training phase's 128
   bootstrap ``.save`` files (20,020 weights) with its one-tissue model as
   the main model and an ``all_feature_clusters.tsv`` from the port's
   ``feature_clusters_table`` over a seeded 2,002-mark table (``se_weight``
   equal to ``np.std(ddof=1)`` of the models as loaded, every z-score row
   its own feature's, which the reference's positional assignment fails);
   ``fimo-query --fimo_engine builtin`` on the first 256 substitutions of
   the VCF against the genome with 24 seeded motifs of widths 6-20 (each
   record the +-30-bp window around its variant, each window's sequence
   the record's slice, its score the log-odds sum within the text's 4
   digits, p-values in (0, 1], a row for every window without an N less
   those the scanner leaves out at a motif's lowest score);
   ``fimo-enrich --no_plots`` with and without ``--rank_int`` on the entry
   phase's RSAT table (seven tables of 15 finite p-values in [0, 1]);
   ``enriched-motifs`` (exactly the motifs under q 0.01); ``rank-int`` on
   the entry phase's sed.tsv by gene in both modes (the closed form of
   the Blom ranks); ``make-profile --rank_match_col`` on the training
   genes (every column's sorted values the reference column's);
   ``collect-pwms`` with and without Lambert/HGNC files (the motifs of the
   kept TF symbols); ``cluster-viz --method louvain`` on a seeded (2,002 x
   20) embedding (the 11 planted groups back). No kernel may launch in the
   phase. ANALYSIS_CPU_ONLY lists the subcommands this machine's packages
   do not allow (no scikit-learn, joblib, matplotlib or h5py): the CPU
   tests prove those;
14. multi-process runs: each flow's CLI as a 2-rank group, ``python -m
   torch.distributed.run --standalone --nproc_per_node 2`` on this card
   (the two ranks share it, so the backend is gloo), each rank running
   ``-m expecto_tpu_torch.cli.<flow>`` under ``--rank-worker``, which
   zeroes the launch counts first and writes each rank's counts; against
   the same call at one rank (the earlier phases' outputs where they are
   the same call): ``cli.score --fp32`` on the fp32 serve's 514 rows (same
   rows in the same order, REF/ALT rtol 1e-4, REF/ALT/SED within 1e-5 of
   max|REF|, no exchange file left; the ranks' blocks assembled in reverse
   rank order must fail that check); ``cli.score`` (bf16) on all rows
   (within SERVE_BF16_GAP of one rank's, which also bounds bf16 vs fp32 at
   one rank; rows shifted by one must exceed it); ``cli.compute_features``
   on the 96 genes in fp32 (1e-5 of max|feature|); ``cli.consensus ref``
   in fp32; ``cli.train --bootstrap_seeds 128`` at the published width
   (every ``.save`` within 1e-5 of max|w|, biases 1e-6; per rank the block
   step's split route, 4,000 launches each of the gradient kernel, the
   coordinate update's planes entry and the residual kernel, and 3 + 100 x
   41 = 4,103 all-reduce calls, whose host time is printed), and again on its first 8 seeds with the
   all-reduce swapped for the identity, which must miss those limits. Every rank's convs must run
   on its dtype's kernels. The backend and each run's wall at one and two
   ranks are printed; the ranks share one card, so the walls are the
   layer's cost, not a scaling;
15. bench: ``python -m expecto_tpu_torch.bench`` (its ``main``, no
   arguments: the card, ``bench.py``'s on-card sizes, no h5 writes), every
   launch count zeroed just before it and read just after: the tc kernel,
   the code-gather conv0 in bf16 and the block step's two kernels 520
   times each (13 rounds of 40 blocks) must launch, the SIMT kernel, the
   round kernel and the coordinate update must not;
   its one result line (printed after ``bench result:``) must hold every
   path key, each finite and above 0; its wall is printed with the card;
16. fc1: the kernels of fc1's strided product at every shape that the
   flows, the 2-rank serves and the bench launched them at (the wrapper's
   ``launches_by_shape``, keyed by dtype), and in fp32 at the routes'
   boundary shapes (FC1_BOUNDARY_M windows of the serving span, both fp32
   kernels at each), on seeded inputs at Beluga's widths. bf16
   (``csrc/fc1_strided_tc.cu``): held against its plain version within
   FC1_TOL_STEPS bf16 steps of max|y|. fp32 (three TF32 passes: the split
   pass ``csrc/fc1_split_tf32.cu`` and ``csrc/fc1_strided_tf32x3_swap.cu``
   up to ``ops/fc1.SWAP_MAX_M`` windows, ``csrc/fc1_strided_tf32x3.cu``
   past it; each row records its route and the bytes its launches stream):
   held against a float64 product of the same inputs within FC1_FP32_REL of
   max|y|, and against the plain version within FC1_FP32_PLAIN_REL, a limit
   that the plain version must meet against float64. In both, the plain version with
   the first window read one frame late must miss the limit, and two calls
   are equal bit for bit; each is timed beside its bound (bf16: operations
   at the bf16 peak; fp32: three passes' operations at the TF32 peak, the
   one pass's share of the FFMA peak beside it), the plain version, the
   ``unfold`` + 2003-column ``torch.matmul`` it replaced (in fp32 the plain
   version itself, TF32 off) and one ``torch.matmul`` of the same windows,
   as one contiguous (M, K) matrix, by the weight zero-padded to 2,048
   columns (a yardstick only: the port never calls it), timed twice. Each shape's row has the kernel's time over the
   yardstick's (``vs_library``) and its share of the bound; a shape where
   the kernel is slower than the yardstick by more than the difference of
   the yardstick's two timings is logged and listed in the report (it does
   not fail the run: a slow kernel stays, with its times); each kernel's
   entry in the kernel line has its worst ``vs_library``;
17. pool: the max-pools fused into the conv kernels' epilogue
   (``conv8_relu_pool4``: conv1 pools phase 0, conv3 each pool-2 phase).
   The conv phases (3 and the gene and consensus kernel phases) launch
   conv1 and conv3 pooled at every shape of every flow (the serving chunk's
   span and patch sub-spans, the h5 pair chunks, the gene chunk, the
   consensus backbone, patch batches, dedup windows and fallback spans),
   bf16 on the tc kernel and fp32 on the tf32x3 kernel: bit-equal to the
   unfused kernel followed by ``ops/spans._pool4_from``, within the route's
   limits of the fp32 plain version, which a pool read one row late and
   another phase's buffer must miss; timed beside the replaced path (kernel
   + pool), the pools alone, the plain version,
   ``F.max_pool1d(F.relu(F.conv1d(...)), 4)`` on each phase's slice (TF32
   off; a yardstick only) and the bound. This phase sums them per chunk
   into the ``pool4`` fields of the two conv kernels' entries in the kernel
   line. Every flow's count read (every phase above, each rank of the
   2-rank groups, the bench) also checks that no pool ran on its own on the
   card (``ops/spans._pool4_from`` is wrapped to count its calls on CUDA
   tensors; the one caller left, ``conv6_phases_patch_sites_c1``, runs
   outside the counted windows) and that each conv stack pooled twice in
   its convs' epilogue; at the default seed each flow's conv launches by
   route equal PARENT_CONV_LAUNCHES, the counts before the pools were
   fused.

The line before the last is the card's name and power limit; the line before
that is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--out DIR`` also writes the full report
to ``DIR/chip_smoke.json``. Inputs and built kernels go under ``build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import json
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
FP32_SERVE_CSV = WORK / "fp32_serve_output.csv"  # the fp32 serve phase's table

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them,
# TF32 tensor cores, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
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
#  fc1 bf16: the kernel and the plain version both round an fp32 sum of the
#        same 67,840 bf16 products, taken in another order, to bf16: within
#        FC1_TOL_STEPS bf16 steps (2^-8 relative) of max|y|
#  fc1 fp32: the three-pass TF32 split holds each product within about
#        2^-21 of it (lo*lo and the parts' rounding left out) and the kernel
#        adds each stage's 96 products into an fp32 sum rounded to nearest:
#        within FC1_FP32_REL of max|y| of a float64 product of the same
#        inputs. The plain SGEMM (TF32 off) carries a running fp32 sum of
#        67,840 products, about 2^-24 sqrt(K) = 1.6e-5 of max|y| off
#        float64: it, and the kernel against it, within FC1_FP32_PLAIN_REL
FC1_TOL_STEPS = 2
FC1_FP32_REL, FC1_FP32_PLAIN_REL = 1e-5, 4e-5
#: each compute dtype's conv1-conv5 kernel (ops/conv8.py::_route: bf16 on the
#: tc kernel, fp32 on the three-pass TF32 kernel); every flow launches the
#: other conv8_relu routes, the SIMT kernel among them, 0 times
CONV_ROUTE = {"bfloat16": "tc", "float32": "tf32x3"}
#: the fp32 conv kernel's limit against a float64 product of the same inputs:
#: FP32_F64_REL of max|y| (three TF32 passes hold each product within about
#: 2^-21 of it, and each stage's chain is promoted into an fp32 sum rounded
#: to nearest; one TF32 pass, about 2^-11 off, misses it)
FP32_F64_REL = 1e-5
#: each compute dtype's fc1 kernels (ops/fc1.py::_route: fp32 takes the
#: swapped kernel up to SWAP_MAX_M windows a call, the tf32x3 kernel past it)
FC1_ROUTES = {"bfloat16": ("tc",), "float32": ("tf32x3", "tf32x3_swap")}
#: the fp32 routes' boundary, held on every run besides the flows' shapes
#: (and SWAP_MAX_M, SWAP_MAX_M + 1): M windows of the serving span's buffer,
#: N samples of 3-5 windows; 64 and 65 straddle the swapped kernel's
#: 64-window ring (6 stages at N = 64, 5 at N = 72)
FC1_BOUNDARY_M = (4, 64, 65)

#: every shape (dtype, N, F, C, s0, stride, n_win, Nout) that an fc1 kernel
#: ran at in a flow or the bench, with its launches there: filled by
#: _read_counts, the 2-rank groups' rank files and the bench phase, held
#: against the plain version by fc1_phase
FC1_SHAPES: Counter = Counter()

#: calls of ops/spans._pool4_from on CUDA tensors, the only pool left that
#: runs on its own (conv6_phases_patch_sites_c1's first; _count_standalone_pools
#: counts them); zeroed by _reset_counts, and every flow's read must find 0
STANDALONE_POOLS: Counter = Counter()
#: conv launches by route of each flow at the default seed before the pools
#: were fused (that tree's run): the fused epilogue must keep every one.
#: serve: the bf16 serve (tc) and the fp32 parity run (the fp32 route: simt
#: then, tf32x3 since); h5 and gene:
#: the timed calls; consensus: the last timed call of each mix, summed
PARENT_CONV_LAUNCHES = {"serve": (201, 61), "h5": (339, 339), "gene": (84, 84), "consensus": (580, 580)}

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

# entry and exit (the .pth converter, cli.closest_genes, cluster-attributed
# SED, the sed merge, the profiler trace): seeded labels of the 2,002 marks
# in ENTRY_CLUSTERS clusters and an RSAT-style membership of ENTRY_CLUSTERS
# clusters (each mark in each with probability ENTRY_RSAT_P); sed.tsv split
# into ENTRY_SED_CHUNKS chunk directories; the cluster proportions of a row
# sum to 1 within ENTRY_PROP_TOL wherever the row's contribution sum is not
# near zero: |sum| > ENTRY_NEAR_ZERO of the sum of the clusters' |contributions|
# (float64 proportions err by about 1e-16 of that ratio)
ENTRY_CLUSTERS = 20
ENTRY_RSAT_P = 0.2
ENTRY_SED_CHUNKS = 3
ENTRY_PROP_TOL = 1e-5
ENTRY_NEAR_ZERO = 1e-6

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

# pipeline: each flow at depth 1 and at its CLI's depth (BelugaRunner's
# default, or GENE_CLI_DEPTH, cli/compute_features.py's), PIPE_REPEATS timed
# calls a depth in turns; the median is reported. The gene flow runs
# PIPE_GENES_PER_STRAND seeded genes a strand: one gene block a strand at the
# CLI's depth (GENE_ROWS x GENE_CLI_DEPTH x 4), so each of its two runner
# calls carries 24 chunks, as every block of a genome-wide run does
GENE_CLI_DEPTH = 6
PIPE_REPEATS = 3
PIPE_GENES_PER_STRAND = GENE_ROWS * GENE_CLI_DEPTH * 4


# gblinear training (cli.train) at the published width: 24,338 genes of
# 2,002 tracks x 10 decay bases, 218 tissues, the reference's hyperparameters
# (eta 0.01, lambda 100, base_score 2) and 100 rounds; seeded features (the
# real Xreducedall.2002.npy is not in the repository)
TRAIN_GENES = 24_338
TRAIN_FEATURES = 20_020
TRAIN_TISSUES = 218
TRAIN_ROUNDS = 100
TRAIN_BOOT_SEEDS = 128
# (block, models) of the coordinate-update kernel: the three training calls'
# shapes, the bench's 256-model round and the reference's 1,000 bootstrap
# jobs (its planes entry runs them on the split route)
TRAIN_CD_SHAPES = ((512, 1), (512, 128), (512, 218), (512, 256), (512, 1000))
# (rows, models) of the K-model block step's two kernels, each K at the row
# count of the call that runs it: the K = 1 sharded trainer and the
# bootstrap CLI (128 seeds; 1,000, the reference's jobs) on 22,296 train
# genes, all tissues on 21,202, the bench on 18,000
TRAIN_BLOCK_SHAPES = ((22_296, 1), (22_296, 128), (21_202, 218), (18_000, 256), (22_296, 1_000))
# the block step's G and r (and r's increment alone) against float64, as a
# share of their max|.|: the fp32 fc1 kernels' limit (FC1_FP32_REL)
TRAIN_BLOCK_REL = 1e-5
# the training kernels, by the names their CUDA kernels carry (profiles)
TRAIN_KERNELS = ("gblinear_round", "gblinear_cd", "gblinear_block_grad", "gblinear_block_resid")
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
# the round kernel (K = 1) against the plain round (the per-block loop) on
# the card, whole training calls and single rounds: fp32 products summed in
# another order, so the card-vs-CPU limits (tests/test_torch_card.py):
# weights over max|w|, the bias, and the per-round RMSE
TRAIN_ROUND_LIMITS = {"w_over_max_w": 1e-5, "bias": 1e-6, "rmse": 1e-5}
# a smoke test that the models learned the labels' signal: unrelated
# predictions of the 900 chr8 genes would read about 0 +- 0.03 (a model at
# a tenth of the width, trained on the CPU, read 0.37)
TRAIN_MIN_SPEARMAN = 0.1

# the analysis toolkit (cli.analysis) on the card's machine, over the
# earlier phases' outputs. The subcommands run here, fixed; the rest need
# packages that machine lacks and are proven by the CPU tests only
# (tests/test_torch_cli_analysis.py), each with the package it needs
ANALYSIS_ON_CARD = (
    "bootstrap-coefficients --no_plots", "fimo-query --fimo_engine builtin", "fimo-enrich --no_plots",
    "fimo-enrich --no_plots --rank_int", "enriched-motifs", "rank-int --group_by gene",
    "rank-int --group_by gene --deterministic", "make-profile --rank_match_col", "collect-pwms (Lambert/HGNC)",
    "collect-pwms", "cluster-viz --method louvain",
)
ANALYSIS_CPU_ONLY = {
    "interpret-features": "scikit-learn, joblib", "svd": "scikit-learn, joblib",
    "svd-transform": "scikit-learn, joblib", "cluster-viz --method kmeans": "scikit-learn, joblib",
    "cluster-viz --tsne": "scikit-learn, matplotlib", "extract-consensus": "h5py", "extract-dataset": "h5py",
    "plot-metrics": "h5py, matplotlib", "plot-distributions": "matplotlib",
    "every subcommand's plots (without --no_plots)": "matplotlib",
}
ANALYSIS_SUBS = 256  # the first substitutions of the phase inputs' VCF, queried for motifs
ANALYSIS_MOTIFS = 24  # seeded MEME motifs, widths 6-20
ANALYSIS_MOTIF_WIDTHS = (6, 20)
ANALYSIS_BP_PAD = 30  # fimo-query's default: the +-30-bp window around the variant
ANALYSIS_NEG_CLUSTERS = 5  # of the entry phase's 20 RSAT clusters: 15 rank cutoffs
ANALYSIS_QVAL = 0.01  # enriched-motifs' default threshold
ANALYSIS_EMB_GROUPS = 11  # planted groups of the (2,002 x 20) Louvain embedding
ANALYSIS_EMB_DIM = 20
ANALYSIS_TF_POOL = 160  # TF symbols the seeded features table, JASPAR files and Lambert list draw from

# multi-process runs (torchrun, this card shared by every rank over gloo):
# ranks a group, host threads a rank, and each group's time limit
MP_RANKS = 2
MP_OMP_THREADS = 4
MP_TIMEOUT_S = 300
# the planted all-reduce fault trains the first 8 bootstrap seeds: a seed's
# resample weights and model do not depend on the other seeds of the sweep,
# so they are held against the 1-rank sweep's models of the same seeds
MP_FAULT_SEEDS = 8
# bf16 serving (bf16 compute, fp16 wire) against fp32, per (row, model),
# REF, ALT and SED over max|fp32 REF|: asserted on the fp32 serve's rows at
# one rank, and between the 2-rank and the 1-rank bf16 runs on every row; the
# 2-rank rows shifted by one must exceed it
SERVE_BF16_GAP = 1e-2


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


def conv_stack(span_len: int, phases) -> list[tuple[str, int, tuple]]:
    """(layer, input length, pool phases) of each conv launch of
    ops/spans.conv6_phases over spans of ``span_len`` bases: conv0..conv3
    once, conv4/conv5 once per pool-2 phase. conv1 pools phase 0 and conv3
    each pool-2 phase in their kernel's epilogue (``conv8_relu_pool4``); the
    others pool nothing (())."""
    phases = tuple(sorted(phases))
    launches, length = [], span_len
    for i in range(4):
        launches.append((f"conv{i}", length, {1: (0,), 3: phases}.get(i, ())))
        length -= 7
        if i == 1:
            length //= 4  # pool1
    for ph in phases:
        l4 = (length - ph) // 4  # pool2 from this phase
        launches += [("conv4", l4, ()), ("conv5", l4 - 7, ())]
    return launches


def chunk_launches() -> Counter:
    """{(layer, L, pool phases): launches} of one substitution chunk of the main path
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
        frames = dict(zip(phases, (length - 7 for name, length, _pool in full if name == "conv5")))
        s0, s1 = conv6_patch_subspan(conv6_patch_ranges(mut, 1, phases, frames), SPAN_LEN)
        tally.update(full + conv_stack(s1 - s0, phases))
    return tally


def h5_chunk_launches() -> Counter:
    """{(layer, L, pool phases): launches} of one pair chunk of the h5 path
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


def _misses(got, want, atol: float, rtol: float) -> bool:
    """Whether ``got`` lies outside atol + rtol·|want| of ``want`` somewhere
    (over their common frames)."""
    f = min(got.shape[1], want.shape[1])
    return not bool(((got[:, :f].float() - want[:, :f]).abs() <= atol + rtol * want[:, :f].abs()).all())


def _fp32_exactness(x, w, b, y, what: str) -> dict:
    """The fp32 route's conv output ``y`` (unpooled) against a float64
    product of the same inputs: within FP32_F64_REL of max|y|, a limit that
    one TF32 pass (the plain version in float64 on x and W rounded to TF32,
    the planted fault) must miss; and a second launch equal bit for bit."""
    import torch

    from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_plain
    from expecto_tpu_torch.ops.fc1 import split_tf32

    if not torch.equal(y, conv8_relu(x, w, b)):
        raise AssertionError(f"{what}: a second launch differs from the first")
    y64 = conv8_relu_plain(x.double(), w.double(), b.double())
    scale = float(y64.abs().max())
    f64 = float((y - y64).abs().max()) / scale
    one_pass = float((conv8_relu_plain(split_tf32(x)[0].double(), split_tf32(w)[0].double(), b.double()) - y64)
                     .abs().max()) / scale
    if f64 > FP32_F64_REL or one_pass <= FP32_F64_REL:
        raise AssertionError(f"{what}: {f64:.3g} of max|y| off float64 (limit {FP32_F64_REL}); one TF32 pass "
                             f"{one_pass:.3g} off must miss it")
    return {"f64_rel": f64, "one_pass_f64_rel": one_pass}


def _conv8_cell(x, w, b, pool: tuple, tag: str, what: str, yardsticks: bool) -> dict:
    """One conv1-conv5 shape in one dtype on its main-path route (CONV_ROUTE:
    fp32 on the tf32x3 kernel, bf16 on the tc kernel): unpooled (``pool``
    ()) on ``conv8_relu``, pooled on ``conv8_relu_pool4``, as the flows
    launch it. Held against the fp32 plain version within the route's
    limits; a pooled launch is also bit-equal to the route's unfused kernel
    followed by ops/spans._pool4_from (the path it replaced), and a pool
    read one row late and another phase's buffer must miss the limits. fp32
    also by _fp32_exactness (float64, one TF32 pass, a repeat). Timed
    (``ms``; a pooled one also the replaced path, ``replaced_ms``, and its
    pools alone, ``pools_ms``); with ``yardsticks`` (always when pooled)
    also the plain version in the working dtype, the library call
    (``F.relu(F.conv1d)``, then ``F.max_pool1d`` on each phase's slice when
    pooled; TF32 off; the port never calls it) and the bound (the conv's
    operations, in fp32 three TF32 passes of them at the TF32 peak, the one
    pass at the FFMA peak beside it as ``ffma_bound_ms``; bytes: x, W and b
    read once, the output or the pooled buffers written once); fp32 also the
    SIMT kernel on the same work (``simt_ms``, route "simt")."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.ops import spans
    from expecto_tpu_torch.ops.conv8 import (_route, conv8_relu, conv8_relu_plain, conv8_relu_pool4,
                                             conv8_relu_pool4_plain)

    n, length, cin = x.shape
    cout, l_out = w.shape[2], length - 7
    route = _route("cuda", x.dtype, cin, x.data_ptr())
    if route != CONV_ROUTE[str(x.dtype).removeprefix("torch.")]:
        raise AssertionError(f"{what} would take the {route} route")
    atol, rtol = (FP32_ATOL, FP32_RTOL) if tag == "fp32" else (BF16_ATOL, BF16_RTOL)
    pool_from = spans._pool4_from

    def plain_fp32():
        if pool:
            return conv8_relu_pool4_plain(x.float(), w.float(), b.float(), pool)
        return conv8_relu_plain(x.float(), w.float(), b.float())

    if pool:
        launch = lambda: conv8_relu_pool4(x, w, b, pool)  # noqa: E731
        plain = lambda: conv8_relu_pool4_plain(x, w, b, pool)  # noqa: E731
        got, y = launch(), conv8_relu(x, w, b)
        for ph in pool:
            if not torch.equal(got[ph], pool_from(y, ph)):
                raise AssertionError(f"{what}: phase {ph} differs from the unfused kernel + pool")
        want = plain_fp32()
        err = max(_check_close(got[ph], want[ph], atol, rtol, f"{what} phase {ph}") for ph in pool)
        for i, ph in enumerate(pool):
            other = got[pool[(i + 1) % len(pool)]] if len(pool) > 1 else pool_from(y, (ph + 1) % 4)
            if not _misses(pool_from(y[:, 1:], ph), want[ph], atol, rtol):
                raise AssertionError(f"{what}: the pool read one row late meets the limits at phase {ph}")
            if not _misses(other, want[ph], atol, rtol):
                raise AssertionError(f"{what}: another phase's buffer meets the limits of phase {ph}")
        del got, want, other

        def replaced():
            yk = conv8_relu(x, w, b)
            return [pool_from(yk, ph) for ph in pool]

        cell = {"route": route, "max_abs_err": err, "ms": cuda_ms(launch), "replaced_ms": cuda_ms(replaced),
                "pools_ms": cuda_ms(lambda: [pool_from(y, ph) for ph in pool])}
        simt = lambda: conv8_relu_pool4(x, w, b, pool, route="simt")  # noqa: E731
        out_elems = sum(n * (max(0, l_out - ph) // 4) * cout for ph in pool)
    else:
        launch = lambda: conv8_relu(x, w, b)  # noqa: E731
        plain = lambda: conv8_relu_plain(x, w, b)  # noqa: E731
        simt = lambda: conv8_relu(x, w, b, route="simt")  # noqa: E731
        y = launch()
        err = _check_close(y, plain_fp32(), atol, rtol, what)
        cell = {"route": route, "max_abs_err": err, "ms": cuda_ms(launch)}
        out_elems = n * l_out * cout
    if tag == "fp32":
        cell.update(_fp32_exactness(x, w, b, y, what))
    del y
    if yardsticks or pool:
        xt = x.transpose(1, 2).contiguous()
        wt = w.permute(2, 1, 0).contiguous()  # (Cout, Cin, 8)

        def library():
            yc = F.relu(F.conv1d(xt, wt, b))
            return [F.max_pool1d(yc[:, :, ph:], 4) for ph in pool] if pool else yc

        nbytes = (x.numel() + w.numel() + b.numel() + out_elems) * x.element_size()
        ops = 2.0 * n * l_out * cin * cout * 8
        cell.update(_bound(nbytes, 3 * ops, "tf32") if tag == "fp32" else _bound(nbytes, ops, tag),
                    plain_ms=cuda_ms(plain), library_ms=cuda_ms(library))
        if tag == "fp32":
            got, want = simt(), plain_fp32()
            simt_err = (max(_check_close(got[ph], want[ph], atol, rtol, f"{what} phase {ph} on simt") for ph in pool)
                        if pool else _check_close(got, want, atol, rtol, f"{what} on simt"))
            del got, want
            cell.update(ffma_bound_ms=1e3 * ops / PEAK_FLOPS["fp32"], simt_ms=cuda_ms(simt), simt_max_abs_err=simt_err)
        del xt, wt
    return cell


def _conv8_simt_bf16(x, w, b, pool: tuple, what: str) -> dict:
    """The SIMT kernel on a bf16 shape of the tc route, for the tc kernel's
    comparison: the unfused kernel (and the pools after it when pooled: the
    same work as the tc launch), held against the fp32 plain version and
    timed."""
    from expecto_tpu_torch.ops import spans
    from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_plain

    err = _check_close(conv8_relu(x, w, b, route="simt"), conv8_relu_plain(x.float(), w.float(), b.float()),
                       BF16_ATOL, BF16_RTOL, f"{what} on simt")

    def on_simt():
        y = conv8_relu(x, w, b, route="simt")
        return [spans._pool4_from(y, ph) for ph in pool] if pool else y

    return {"ms": cuda_ms(on_simt), "max_abs_err": err}


def _pooled_log(c: dict) -> str:
    """A pooled cell's replaced path, for a log line ('' when unpooled)."""
    return f", replaced path {c['replaced_ms']:.3f} ms (pools {c['pools_ms']:.3f})" if "replaced_ms" in c else ""


def kernel_phase(report: dict) -> None:
    """conv1-conv5 at every shape of a substitution chunk, conv1 and conv3
    with their pools fused, as the flows launch them (_conv8_cell): fp32 on
    the three-pass TF32 kernel (the fp32 main path's route) beside the SIMT
    kernel on the same work; bf16 on the tensor-core kernel (the bf16 main
    path's route) and on the SIMT kernel too (unfused, the pools after it),
    so each redesign shows shape by shape."""
    import torch

    from expecto_tpu_torch.models.beluga import CONV_SPECS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {f"conv{i}": (cin, cout) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    rows, n = [], CHUNK
    for (name, length, pool), per_chunk in sorted(chunk_launches().items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        if name == "conv0":  # on the code-gather kernel: conv0_phase
            continue
        cin, cout = specs[name]
        x32 = torch.randn((n, length, cin), generator=gen, device=dev)
        w32 = torch.randn((8, cin, cout), generator=gen, device=dev) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=dev) * 0.1
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "pool": list(pool),
               "launches_per_chunk": per_chunk}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            what = f"conv8 {tag} {name} N={n} L={length} pool {list(pool)}"
            row[tag] = _conv8_cell(x, w, b, pool, tag, what, yardsticks=True)
            if tag == "bf16":
                row[tag]["simt"] = _conv8_simt_bf16(x, w, b, pool, what)
            del x, w, b
        bf, fp = row["bf16"], row["fp32"]
        log(f"kernel {name} N={n} L={length} {cin}->{cout} pool {list(pool)} x{per_chunk} per chunk: bf16 "
            f"tc {bf['ms']:.3f} ms (err {bf['max_abs_err']:.3g}){_pooled_log(bf)} simt {bf['simt']['ms']:.3f} ms "
            f"(err {bf['simt']['max_abs_err']:.3g}) plain {bf['plain_ms']:.3f} ms library {bf['library_ms']:.3f} ms "
            f"bound {bf['bound_ms']:.3f} ms ({bf['bound_by']}); fp32 tf32x3 {fp['ms']:.3f} ms (err "
            f"{fp['max_abs_err']:.3g}, {fp['f64_rel']:.3g} of max|y| off float64, one pass {fp['one_pass_f64_rel']:.3g})"
            f"{_pooled_log(fp)} simt {fp['simt_ms']:.3f} ms plain {fp['plain_ms']:.3f} ms library "
            f"{fp['library_ms']:.3f} ms 3xTF32 bound {fp['bound_ms']:.3f} ms ({100 * fp['bound_ms'] / fp['ms']:.1f} % of "
            f"it) FFMA bound {fp['ffma_bound_ms']:.3f} ms")
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
    for (name, length, pool), per_chunk in sorted(chunk_launches().items(), key=lambda kv: -kv[0][1]):
        if name != "conv0":
            continue
        codes = _conv0_codes(n, length, gen)
        w32 = torch.randn((8, cin, cout), generator=gen, device=gen.device) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=gen.device) * 0.1
        l_out = length - 7
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "pool": list(pool),
               "launches_per_chunk": per_chunk}
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
    """Every conv of one chunk of ``n`` spans (``launches``: {(layer, L,
    pool phases): launches a chunk}) on each dtype's route of the main path:
    conv0 on the code-gather kernel, conv1-conv5 as _conv8_cell launches,
    checks and times them (conv1 and conv3 pooled). conv0 is held against
    the fp32 plain version and timed; with ``yardsticks`` also beside the
    plain version in the working dtype, ``F.conv1d`` (TF32 off) and the
    bound. Returns the per-shape rows and {dtype: the chunk's
    launch-weighted kernel ms}."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu, conv0_codes_relu_plain, onehot_from_codes

    torch.backends.cudnn.allow_tf32 = False
    rows, chunk_ms = [], {"fp32": 0.0, "bf16": 0.0}
    for (name, length, pool), per_chunk in sorted(launches.items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        _kw, cin, cout = CONV_SPECS[int(name[4:])]
        if name == "conv0":
            x32 = _conv0_codes(n, length, gen)
        else:
            x32 = torch.randn((n, length, cin), generator=gen, device=gen.device)
        w32 = torch.randn((8, cin, cout), generator=gen, device=gen.device) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=gen.device) * 0.1
        l_out = length - 7
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "pool": list(pool),
               "launches_per_chunk": per_chunk}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            w, b = w32.to(dtype), b32.to(dtype)
            if name != "conv0":
                x = x32.to(dtype)
                cell = _conv8_cell(x, w, b, pool, tag, f"{what} {name} {tag} N={n} L={length} pool {list(pool)}",
                                   yardsticks)
            else:
                x = x32
                want = conv0_codes_relu_plain(x, w.float(), b.float())
                atol = rtol = CONV0_FP32_TOL if tag == "fp32" else BF16_ATOL
                launch = lambda: conv0_codes_relu(x, w, b)  # noqa: E731
                err = _check_close(launch(), want, atol, rtol, f"{what} {name} codes {tag} N={n} L={length}")
                del want
                cell = {"route": "codes", "max_abs_err": err, "ms": cuda_ms(launch)}
                if yardsticks:
                    xt = onehot_from_codes(x, dtype).transpose(1, 2).contiguous()
                    wt = w.permute(2, 1, 0).contiguous()  # (Cout, Cin, 8)
                    # codes read once, W and b once, the output written once; 8 adds an output
                    nbytes = x.numel() + (w.numel() + b.numel() + n * l_out * cout) * w.element_size()
                    cell.update(_bound(nbytes, 8.0 * n * l_out * cout, "fp32"),
                                plain_ms=cuda_ms(lambda: conv0_codes_relu_plain(x, w, b)),
                                library_ms=cuda_ms(lambda: F.relu(F.conv1d(xt, wt, b))))
                    del xt, wt
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
    """{(layer, L, pool phases): launches} of one gene chunk (parallel/runner.
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
    fp = {k: _weighted(conv8, "fp32", k) for k in ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms",
                                                    "ffma_bound_ms")}
    fp["min_shape_share"] = min(r["fp32"]["bound_ms"] / r["fp32"]["ms"] for r in conv8)
    fp["simt_min_shape_ffma_share"] = min(r["fp32"]["ffma_bound_ms"] / r["fp32"]["simt_ms"] for r in conv8)
    report["fp32_conv_chunk"] = fp
    log(f"fp32 conv1-conv5 chunk: tf32x3 {fp['ms']:.3f} ms, {100 * fp['bound_ms'] / fp['ms']:.1f} % of its 3xTF32 "
        f"bound {fp['bound_ms']:.3f} ms (lowest share of a shape's {100 * fp['min_shape_share']:.1f} %); SIMT "
        f"{fp['simt_ms']:.3f} ms ({fp['simt_ms'] / fp['ms']:.2f}x, {100 * fp['ffma_bound_ms'] / fp['simt_ms']:.1f} % of "
        f"the FFMA bound {fp['ffma_bound_ms']:.3f} ms); plain {fp['plain_ms']:.3f} ms; F.conv1d (TF32 off) "
        f"{fp['library_ms']:.3f} ms ({fp['library_ms'] / fp['ms']:.2f}x)")


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
    from expecto_tpu_torch.ops import conv0, conv8, fc1

    conv8.reset_launch_counts()
    conv0.reset_launch_counts()
    fc1.reset_launch_counts()
    STANDALONE_POOLS.clear()


def _count_standalone_pools() -> None:
    """Wrap ops/spans._pool4_from so that each call on a CUDA tensor counts
    in STANDALONE_POOLS: a flow whose pools all run in the conv kernels'
    epilogue counts none."""
    from expecto_tpu_torch.ops import spans

    pool = spans._pool4_from

    def counted(x, phase):
        STANDALONE_POOLS["calls"] += x.is_cuda
        return pool(x, phase)

    spans._pool4_from = counted


def _fc1_shapes_now() -> list:
    """The fc1 kernels' launches by shape since the last _reset_counts, as
    JSON: [[[dtype, N, F, C, s0, stride, n_win, Nout], launches], ...]."""
    from expecto_tpu_torch.ops.fc1 import fc1_strided

    return [[list(shape), n] for shape, n in sorted(fc1_strided.launches_by_shape.items())]


def _fc1_routes_of(shapes: dict) -> dict:
    """{route: launches} that ops/fc1.py::_route gives the fc1 launches
    ``shapes`` ({(dtype, N, F, C, s0, stride, n_win, Nout): launches})."""
    import torch

    from expecto_tpu_torch.ops import fc1

    out = Counter()
    for (dtype, n, _f, _c, _s0, _stride, n_win, _n_out), k in shapes.items():
        out[fc1._route("cuda", getattr(torch, dtype), n * n_win)] += k
    return dict(out)


def _fc1_on_routes(dtype: str, by_route: dict, shapes: dict, split: int) -> bool:
    """Whether a run's fc1 launches went where ops/fc1.py::_route sends each
    of their shapes, on ``dtype``'s kernels alone, one split pass a launch
    of the swapped kernel."""
    return (by_route == _fc1_routes_of(shapes) and set(by_route) <= set(FC1_ROUTES[dtype])
            and split == by_route.get("tf32x3_swap", 0))


def _on_conv_route(by_route: dict, dtype: str) -> bool:
    """conv1-conv5 launched on ``dtype``'s route (CONV_ROUTE) and on no other."""
    route = CONV_ROUTE[dtype]
    return by_route[route] > 0 and not any(n for r, n in by_route.items() if r != route)


def _off_route(by_route: dict, dtype: str) -> int:
    """conv8_relu launches on the routes other than ``dtype``'s."""
    return sum(n for r, n in by_route.items() if r != CONV_ROUTE[dtype])


def _read_counts(dtype: str) -> dict:
    """Every kernel's launches since the last _reset_counts, checked: the
    route counts add up, no float one-hot reached conv8_relu (no launch at
    Cin 4), every conv0 ran on the code-gather kernel in ``dtype``, and each
    conv stack ran its conv0 there (conv1 and conv2, the two Cin-320 convs
    of a stack, launch twice as often as conv0), and fc1 ran on ``dtype``'s
    kernels alone, each shape on its route (bf16: "tc"; fp32: "tf32x3_swap",
    after one split pass, or "tf32x3" by M); the flow's fc1 shapes join
    FC1_SHAPES. No pool ran on its own, and each conv stack pooled twice in
    its convs' epilogue (conv1 and conv3), on the route of its convs."""
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu
    from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_pool4
    from expecto_tpu_torch.ops.fc1 import fc1_strided, split_planes

    by_route, kinds = dict(conv8_relu.launches_by_route), Counter(conv8_relu.launches_by_kind)
    n0, kind0 = conv0_codes_relu.launches, dict(conv0_codes_relu.launches_by_kind)
    pooled = dict(conv8_relu_pool4.launches_by_route)
    counts = {"conv8_relu": conv8_relu.launches, "conv8_relu_by_route": by_route,
              "conv8_relu_by_kind": {f"{r} {dt} Cin {cin}": k for (r, dt, cin), k in sorted(kinds.items())},
              "conv0_codes": n0, "conv0_codes_by_kind": kind0, "fc1_strided": fc1_strided.launches,
              "fc1_strided_by_route": dict(fc1_strided.launches_by_route), "fc1_split_tf32": split_planes.launches,
              "conv8_relu_pool4_by_route": pooled, "pool4_standalone": STANDALONE_POOLS["calls"]}
    if counts["pool4_standalone"]:
        raise AssertionError(f"{counts['pool4_standalone']} standalone pools ran on the card in a {dtype} flow")
    route = CONV_ROUTE[dtype]
    if pooled != {r: 2 * n0 * (r == route) for r in pooled}:
        raise AssertionError(f"a {dtype} flow's pooled convs: {pooled}, expected {2 * n0} on {route} ({n0} conv stacks)")
    if not _fc1_on_routes(dtype, counts["fc1_strided_by_route"], fc1_strided.launches_by_shape,
                          counts["fc1_split_tf32"]):
        raise AssertionError(f"a {dtype} flow's fc1 did not run on its routes {FC1_ROUTES[dtype]} as ops/fc1.py::"
                             f"_route sends its shapes: {counts['fc1_strided_by_route']}, split passes "
                             f"{counts['fc1_split_tf32']}, shapes {_fc1_shapes_now()}")
    FC1_SHAPES.update(fc1_strided.launches_by_shape)
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
    if not _on_conv_route(by_route, "bfloat16"):
        raise AssertionError(f"bf16 conv1-conv5 did not all run on the tc kernel: {by_route}")
    if counts["fc1_strided"] <= 0:
        raise AssertionError(f"the bf16 serve launched no fc1 kernel: {counts}")
    fc1_shapes = _fc1_shapes_now()
    _df, ref, _alt, sed = check_output(out_csv, inputs["n_rows"])
    n_var = len(inputs["variants"])
    report["main_path"] = {
        "variants": n_var, "rows": inputs["n_rows"], "models": N_MODELS, "maxshift": MAXSHIFT,
        "cli_wall_s": wall, "launches": counts, "fc1_launches_by_shape": fc1_shapes,
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


def serve(vcf: Path, genes: Path, n_rows: int, *, fp32: bool, warmup: int, repeats: int,
          output_csv: Path | None = None) -> list[float]:
    """Wall times of repeats of the serving call itself on the card, with
    the CLI's settings (bf16 compute and fp16 wire, or ``--fp32``'s fp32 and
    fp32): one runner and its models built once, ``warmup`` calls first,
    launch counts zeroed just before the timed calls. ``output_csv``: the
    last call's table, written as the score CLI writes ``--output``."""
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
    if output_csv is not None:
        df.to_csv(output_csv, header=True, index=False)
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
    the SIMT kernel. Its table is FP32_SERVE_CSV, the yardstick of the entry
    and exit phase."""
    vcf, genes, n_rows = subset(inputs, range(N_FP32_SERVE), "fp32_serve")
    wall = serve(vcf, genes, n_rows, fp32=True, warmup=1, repeats=1, output_csv=FP32_SERVE_CSV)[0]
    counts = _read_counts("float32")
    if not _on_conv_route(counts["conv8_relu_by_route"], "float32"):
        raise AssertionError(f"fp32 serve: conv1-conv5 did not all run on the tf32x3 kernel: {counts}")
    if counts["fc1_strided"] <= 0:
        raise AssertionError(f"the fp32 serve launched no fc1 kernel: {counts}")
    report["fp32_serve"] = {"variants": N_FP32_SERVE, "rows": n_rows, "models": N_MODELS, "wall_s": wall,
                            "rows_per_s": n_rows / wall, "launches": counts, "fc1_launches_by_shape": _fc1_shapes_now()}
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
            fc1_shapes = _fc1_shapes_now()
            if not _on_conv_route(counts["conv8_relu_by_route"], "float32"):
                raise AssertionError(f"fp32 conv1-conv5 did not all run on the tf32x3 kernel: {counts}")
            if counts["fc1_strided"] <= 0:
                raise AssertionError(f"the fp32 parity run launched no fc1 kernel: {counts}")
        frames[tag] = check_output(out, n_rows)
    _dg, ref_g, alt_g, sed_g = frames["card"]
    _dc, ref_c, alt_c, sed_c = frames["cpu"]
    sed_atol = 1e-5 * max(1.0, float(np.abs(ref_c).max()))
    errs = {"REF": float(np.abs(ref_g - ref_c).max()), "ALT": float(np.abs(alt_g - alt_c).max()),
            "SED": float(np.abs(sed_g - sed_c).max())}
    for name, g, c, atol in (("REF", ref_g, ref_c, PARITY_ATOL), ("ALT", alt_g, alt_c, PARITY_ATOL),
                             ("SED", sed_g, sed_c, sed_atol)):
        np.testing.assert_allclose(g, c, rtol=PARITY_RTOL, atol=atol, err_msg=f"card vs CPU fp32 {name}")
    report["parity"] = {"rows": n_rows, "max_abs_err": errs, "sed_atol": sed_atol, "launches": counts,
                        "fc1_launches_by_shape": fc1_shapes}
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


def h5_contract_phase(report: dict, inputs: dict, card: str) -> tuple[dict, object]:
    """The h5 contract on every main-path variant, fp32 then bf16, with the
    chromatin CLI's settings; the fp32 effects scored as the predict CLI
    scores them and checked against the CPU and the fused scorer. Returns
    the fp32 effects as ``load_shift_effects`` returns the files, and
    ``score_sed``'s table of them (model 0)."""
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
            dtype = "float32" if tag == "fp32" else "bfloat16"
            route, by_route = CONV_ROUTE[dtype], counts["conv8_relu_by_route"]
            if (counts["conv0_codes"], by_route[route], _off_route(by_route, dtype)) != (want0, want8, 0):
                raise AssertionError(f"h5 {tag}: launches {counts}, expected {want0} conv0 and {want8} {route}")
            # fc1 over both orientations' two pool-2 phases a pair chunk, on
            # the dtype's kernel; the window rows' fc1 is the per-window matmul
            if counts["fc1_strided"] != 4 * chunks:
                raise AssertionError(f"h5 {tag}: {counts['fc1_strided']} fc1 kernel launches for {chunks} pair chunks")
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
    return eff32, sed


# ---- entry and exit: the converter, closest genes, cluster SED, merges --------

def _torch_state_dict(params: dict) -> dict:
    """The npz pytree written back in the published checkpoint's layout (the
    keys of models/convert.py's TORCH_CONV_KEYS and TORCH_FC_KEYS): OIHW
    ``(out, in, 1, 8)`` convs, a channel-major ``(2003, 67840)`` fc1 (input
    ``c * 106 + l`` from the npz's row ``l * 640 + c``) and ``(out, in)``
    dense; the inverse of the converter, written here on its own."""
    import numpy as np
    import torch

    conv_keys = ["model.0.0", "model.0.2", "model.0.6", "model.0.8", "model.0.12", "model.0.14"]
    sd = {}
    for i, key in enumerate(conv_keys):
        w = params[f"conv{i}"]["w"]  # (8, in, out)
        sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)[:, :, None, :]))
        sd[f"{key}.bias"] = torch.from_numpy(params[f"conv{i}"]["b"].copy())
    w1 = params["fc1"]["w"]  # (106 * 640, 2003), row l * 640 + c
    sd["model.1.2.1.weight"] = torch.from_numpy(
        np.ascontiguousarray(w1.reshape(106, 640, w1.shape[1]).transpose(2, 1, 0)).reshape(w1.shape[1], -1))
    sd["model.1.2.1.bias"] = torch.from_numpy(params["fc1"]["b"].copy())
    sd["model.1.4.1.weight"] = torch.from_numpy(np.ascontiguousarray(params["fc2"]["w"].T))
    sd["model.1.4.1.bias"] = torch.from_numpy(params["fc2"]["b"].copy())
    return sd


def _score_fp32(vcf: Path, genes: Path, out_csv: Path, n_rows: int, what: str, *extra: str):
    """``cli.score --fp32`` on the card, launch counts zeroed just before and
    checked just after (conv1-conv5 on the SIMT kernel alone, conv0 on the
    code-gather kernel in fp32): the checked table, the counts and the wall."""
    from expecto_tpu_torch.cli.score import main as score_main

    _reset_counts()
    t0 = time.perf_counter()
    if score_main(score_args(vcf, genes, "--fp32", *extra, "--output", str(out_csv))) != 0:
        raise AssertionError(f"{what}: cli.score --fp32 returned non-zero")
    wall = time.perf_counter() - t0
    counts = _read_counts("float32")
    if not _on_conv_route(counts["conv8_relu_by_route"], "float32"):
        raise AssertionError(f"{what}: conv1-conv5 did not all run on the tf32x3 kernel: {counts}")
    if counts["fc1_strided"] <= 0:
        raise AssertionError(f"{what}: cli.score --fp32 launched no fc1 kernel: {counts}")
    return check_output(out_csv, n_rows)[0], counts, wall


def _entry_converter(out: dict, inputs: dict, card: str) -> None:
    """The published checkpoint's way in: chip_smoke's Beluga weights written
    as a reference-layout ``.pth``, ``python -m expecto_tpu_torch.models.
    convert`` on it (a subprocess, timed), every array of its npz equal to
    beluga.npz's bit for bit, and ``cli.score --fp32`` on the card with it
    held to the fp32 serve phase's table (bit for bit expected; else within
    that phase's limits, and the log says so); the same serve on an fc1
    converted without the permutation must miss those limits."""
    import os

    import numpy as np
    import torch

    from expecto_tpu_torch.models.convert import load_params_npz, save_params_npz

    d = WORK / "entry"
    d.mkdir(exist_ok=True)
    pth, npz, bad_npz = d / "deepsea.beluga.pth", d / "beluga_converted.npz", d / "beluga_unpermuted.npz"
    params = load_params_npz(WORK / "beluga.npz")
    t0 = time.perf_counter()
    sd = _torch_state_dict(params)
    torch.save(sd, pth)
    write_s = time.perf_counter() - t0
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "expecto_tpu_torch.models.convert", str(pth), str(npz)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"python -m expecto_tpu_torch.models.convert exited {res.returncode}: {res.stderr[-3000:]}")
    pth_bytes = pth.stat().st_size
    pth.unlink()
    got = load_params_npz(npz)
    keys = sorted((layer, name) for layer, dd in params.items() for name in dd)
    if sorted((layer, name) for layer, dd in got.items() for name in dd) != keys:
        raise AssertionError("the converted npz holds other arrays than beluga.npz")
    for layer, name in keys:
        a, b = got[layer][name], params[layer][name]
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"converted {layer}/{name} differs from beluga.npz ({a.dtype} {a.shape})")
    out["converter"] = {"pth_bytes": pth_bytes, "fc1_bytes": int(params["fc1"]["w"].nbytes), "write_pth_s": write_s,
                        "convert_s": convert_s}
    log(f"entry: .pth ({pth_bytes / 1e6:.1f} MB, fc1 {params['fc1']['w'].nbytes / 1e6:.1f} MB) written in "
        f"{write_s:.2f} s; python -m expecto_tpu_torch.models.convert in {convert_s:.2f} s (a process: interpreter, "
        f"torch import, load, convert, savez); all {len(keys)} arrays equal to beluga.npz bit for bit [{card}]")

    vcf, genes, n_rows = subset(inputs, range(N_FP32_SERVE), "fp32_serve")
    want = check_output(FP32_SERVE_CSV, n_rows)[0]
    served, counts, wall = _score_fp32(vcf, genes, d / "converted_output.csv", n_rows, "converted weights",
                                       "--beluga_weights", str(npz))
    bit_equal = served.equals(want)
    gaps = _serve_check(served, want, "converted weights vs the fp32 serve")
    out["converted_serve"] = {"rows": n_rows, "wall_s": wall, "bit_equal": bit_equal, "gaps": gaps, "launches": counts}
    log(f"entry: cli.score --fp32 on the converted npz, {n_rows} rows x {N_MODELS} models in {wall:.3f} s (weights "
        f"loaded): " + ("equal bit for bit to the fp32 serve phase's table" if bit_equal else
                        f"NOT bit-equal to the fp32 serve phase's table (the CLI and the in-process serve differ in "
                        f"their calls, not their weights), within its limits: {gaps}") + f"; launches {counts} [{card}]")
    npz.unlink()

    # the planted fault: fc1 transposed without the channel-major -> length-major permutation
    bad = {layer: dict(dd) for layer, dd in params.items()}
    bad["fc1"]["w"] = np.ascontiguousarray(sd["model.1.2.1.weight"].numpy().T)
    save_params_npz(bad, bad_npz)
    del sd, bad
    served_bad, _counts, _wall = _score_fp32(vcf, genes, d / "unpermuted_output.csv", n_rows, "unpermuted fc1",
                                             "--beluga_weights", str(bad_npz))
    bad_npz.unlink()
    try:
        _serve_check(served_bad, want, "unpermuted fc1")
    except AssertionError:
        pass
    else:
        raise AssertionError("an fc1 converted without fc1_permutation stays within the fp32 serve's limits")
    names = [f"Tissue{j:03d}" for j in range(N_MODELS)]
    out["unpermuted_fault_gaps"] = _serve_gaps(
        *[[f[[f"{p}{m}" for m in names]].to_numpy(np.float64) for p in ("REF_", "ALT_", "")] for f in (served_bad, want)])
    log(f"entry: the same serve on an fc1 converted without the permutation misses the limits: max |err| "
        f"{out['unpermuted_fault_gaps']}")


def _entry_closest_genes(out: dict, card: str) -> None:
    """The way from a VCF to scored rows: ``cli.closest_genes`` on the fp32
    serve's 256 substitutions, plain and with ``--all_in_receptive_field``,
    against the seeded ``geneanno.csv`` extended by the fp32 serve table's
    genes (so that its rows can turn up); each table scored by ``cli.score
    --fp32`` on the card (its VCF the CLI's ``snps_hg19.vcf``): a row a table
    row, finite, every variant present, the field's table at least the
    plain one, every row also in the fp32 serve's table within that phase's
    limits, the conv kernels' launch counts."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.cli.closest_genes import main as cg_main

    d = WORK / "entry"
    d.mkdir(exist_ok=True)
    anno = pd.read_csv(WORK / "geneanno.csv", index_col=0)
    serve_genes = pd.read_csv(WORK / "fp32_serve_genes.tsv", sep="\t", header=None)
    extra = pd.DataFrame({"symbol": serve_genes[9].values, "seqnames": "chr" + serve_genes[5].astype(str).values,
                          "strand": serve_genes[8].values, "TSS": serve_genes[7].values,
                          "CAGE_representative_TSS": serve_genes[7].values, "type": "protein_coding"},
                         index=pd.Index(serve_genes[9].values, name=anno.index.name))
    pd.concat([anno, extra[~extra.index.duplicated()]]).to_csv(d / "geneanno.csv")
    variants = pd.read_csv(WORK / "fp32_serve.vcf", sep="\t", header=None)
    want_keys = set(zip(variants[0], variants[1], variants[3], variants[4]))
    want = check_output(FP32_SERVE_CSV, len(serve_genes))[0]
    key_cols = ["0", "1", "3", "4", "gene", "dist", "strand"]
    want_pos = {k: i for i, k in enumerate(zip(*(want[c] for c in key_cols)))}
    rows = {}
    for mode, flags in (("closest", []), ("receptive_field", ["--all_in_receptive_field"])):
        odir = d / f"closest_{mode}"
        t0 = time.perf_counter()
        if cg_main([str(WORK / "fp32_serve.vcf"), "--annoFile", str(d / "geneanno.csv"), "-o", str(odir), *flags]) != 0:
            raise AssertionError(f"cli.closest_genes ({mode}) returned non-zero")
        cg_s = time.perf_counter() - t0
        n_table = len(pd.read_csv(odir / "closest_genes.tsv", sep="\t", header=None))
        got, counts, wall = _score_fp32(odir / "snps_hg19.vcf", odir / "closest_genes.tsv", odir / "output.csv", n_table,
                                        f"closest genes ({mode})")
        if set(zip(got["0"], got["1"], got["3"], got["4"])) != want_keys:
            raise AssertionError(f"closest genes ({mode}): the scored rows miss variants of the VCF")
        common = [(i, want_pos[k]) for i, k in enumerate(zip(*(got[c] for c in key_cols))) if k in want_pos]
        if not common:
            raise AssertionError(f"closest genes ({mode}): no row in common with the fp32 serve's table")
        gi, wi = (list(t) for t in zip(*common))
        gaps = _serve_check(got.iloc[gi].reset_index(drop=True), want.iloc[wi].reset_index(drop=True),
                            f"closest genes ({mode}) vs the fp32 serve")
        rows[mode] = n_table
        out[f"closest_{mode}"] = {"variants": len(variants), "rows": n_table, "closest_genes_s": cg_s,
                                  "score_wall_s": wall, "rows_in_fp32_serve": len(common), "gaps": gaps,
                                  "launches": counts}
        log(f"entry: cli.closest_genes ({mode}) on {len(variants)} variants x {len(anno) + len(extra)} genes in "
            f"{cg_s:.3f} s: {n_table} rows; cli.score --fp32 on them in {wall:.3f} s ({N_MODELS} models, weights "
            f"loaded), every variant present, {len(common)} rows also in the fp32 serve's table, within its "
            f"limits: {gaps}; launches {counts} [{card}]")
    if rows["receptive_field"] < rows["closest"]:
        raise AssertionError(f"the receptive-field table has fewer rows than the closest-gene one: {rows}")
    # every fp32 serve gene lies within 20 kb of its variant: inside the receptive field
    if out["closest_receptive_field"]["rows_in_fp32_serve"] != len(serve_genes):
        raise AssertionError(f"the receptive-field table holds {out['closest_receptive_field']['rows_in_fp32_serve']} "
                             f"of the fp32 serve's {len(serve_genes)} rows")


def _cluster_contribs(eff: dict, vcf, gene, model, labels, membership):
    """The clusters' SED contributions of every row, computed here in
    float64 from the scorer's features: labels -> (rows, clusters) sums over
    each label's marks, membership -> per-mark sums @ membership."""
    import numpy as np

    from expecto_tpu_torch.pipeline.sed import _project, align_variants_with_genes

    feats = _project(align_variants_with_genes(vcf, gene, eff), MAXSHIFT, None, 2002, keys=("ref", "alt"))
    contrib = np.asarray(model.weight, np.float64) * (feats["alt"].astype(np.float64) - feats["ref"])
    per_mark = contrib.reshape(len(contrib), 10, -1).sum(axis=1)
    by_label = np.stack([per_mark[:, labels == k].sum(axis=1) for k in np.unique(labels)], axis=1)
    return by_label, per_mark @ membership


def _entry_clusters(out: dict, eff: dict, sed_table, card: str, seed: int) -> None:
    """Cluster-attributed SED on the h5 phase's fp32 effects, in memory:
    ``score_sed_with_clusters`` with model 0, seeded labels and a seeded
    RSAT membership; REF and ALT equal to the h5 phase's ``score_sed``; the
    proportions against the contributions computed here, summing to 1 where
    a row's sum is not near zero; sed.tsv split into chunk directories and
    ``merge_sed_batches`` equal to the unsplit rows."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.io.xgb import load_expression_model
    from expecto_tpu_torch.pipeline.merge import merge_sed_batches
    from expecto_tpu_torch.pipeline.sed import score_sed_with_clusters

    d = WORK / "entry"
    d.mkdir(exist_ok=True)
    vcf = standardize_chroms(read_vcf(WORK / "variants.vcf"))
    gene = load_closest_genes(WORK / "genes.tsv")
    model = load_expression_model(load_modellist(WORK / "modellist").iloc[0, 0])
    rng = np.random.default_rng(seed + 3)
    labels = rng.permutation(np.arange(2002) % ENTRY_CLUSTERS)  # every cluster has marks
    membership = (rng.random((2002, ENTRY_CLUSTERS)) < ENTRY_RSAT_P).astype(np.float64)
    rsat_names = [f"rsat_{j}" for j in range(ENTRY_CLUSTERS)]
    tables, walls = {}, {}
    for kind, clusters, member in (("labels", labels, None), ("rsat", rsat_names, membership)):
        t0 = time.perf_counter()
        tables[kind] = score_sed_with_clusters(eff, vcf, gene, model, clusters, maxshift=MAXSHIFT,
                                               out_dir=d / f"clusters_{kind}", membership=member)
        walls[kind] = time.perf_counter() - t0
    want = dict(zip(("labels", "rsat"), _cluster_contribs(eff, vcf, gene, model, labels, membership)))
    res = {"rows": len(sed_table), "walls_s": walls}
    for kind, df in tables.items():
        for col in ("REF", "ALT"):
            if not np.array_equal(df[col].to_numpy(), sed_table[col].to_numpy()):
                raise AssertionError(f"score_sed_with_clusters ({kind}) {col} differs from the h5 phase's score_sed")
        names = [f"cluster_{k}" for k in range(ENTRY_CLUSTERS)] if kind == "labels" else rsat_names
        if list(df.columns[-ENTRY_CLUSTERS:]) != names or len(df) != len(sed_table):
            raise AssertionError(f"score_sed_with_clusters ({kind}): columns or rows are not the expected ones")
        got, c = df[names].to_numpy(np.float64), want[kind]
        total = c.sum(axis=1)
        sound = np.abs(total) > ENTRY_NEAR_ZERO * np.abs(c).sum(axis=1)
        sum_gap = float(np.abs(got[sound].sum(axis=1) - 1.0).max())
        np.testing.assert_allclose(got[sound], (c / total[:, None])[sound], rtol=1e-6, atol=1e-9,
                                   err_msg=f"cluster proportions ({kind}) vs the contributions")
        if sum_gap > ENTRY_PROP_TOL or sound.sum() < 0.9 * len(sound):
            raise AssertionError(f"cluster proportions ({kind}): sums off 1 by {sum_gap} on {int(sound.sum())} rows")
        res[kind] = {"rows_checked": int(sound.sum()), "rows_near_zero": int((~sound).sum()), "sum_gap": sum_gap}
    out["clusters"] = res
    log(f"entry: score_sed_with_clusters on the h5 phase's fp32 effects, model 0, {len(sed_table)} rows: labels "
        f"({ENTRY_CLUSTERS} clusters) {walls['labels']:.3f} s, RSAT membership {walls['rsat']:.3f} s (host numpy); "
        f"REF and ALT equal to score_sed's; proportions sum to 1 within {ENTRY_PROP_TOL}: {res['labels']} and "
        f"{res['rsat']} [{card}]")

    # the file's own lines split into chunks (no float is rewritten), each
    # chunk with the header, as a chunked run's per-job sed.tsv files
    header, *lines = (d / "clusters_labels" / "sed.tsv").read_text().splitlines(keepends=True)
    unsplit = pd.read_csv(d / "clusters_labels" / "sed.tsv", sep="\t")
    batches = d / "sed_batches"
    for i, part in enumerate(np.array_split(np.arange(len(lines)), ENTRY_SED_CHUNKS)):
        (batches / f"chunk_{i}").mkdir(parents=True, exist_ok=True)
        (batches / f"chunk_{i}" / "sed.tsv").write_text(header + "".join(lines[j] for j in part))
    t0 = time.perf_counter()
    merged = merge_sed_batches(str(batches), str(d / "sed_merged"), ENTRY_SED_CHUNKS)
    merge_s = time.perf_counter() - t0
    # the merged file holds the merged values' shortest round-trip text
    reread = pd.read_csv(d / "sed_merged" / "sed.tsv", sep="\t", index_col=0, float_precision="round_trip")
    if not (merged.reset_index(drop=True).equals(unsplit) and reread.reset_index(drop=True).equals(unsplit)):
        raise AssertionError("merge_sed_batches of the split sed.tsv differs from the unsplit rows")
    out["sed_merge"] = {"chunks": ENTRY_SED_CHUNKS, "rows": len(unsplit), "merge_s": merge_s}
    log(f"entry: sed.tsv split into {ENTRY_SED_CHUNKS} chunk directories, merge_sed_batches in {merge_s:.3f} s: "
        f"equal to the unsplit {len(unsplit)} rows")


def _entry_trace(out: dict, eff: dict, card: str) -> None:
    """``utils.profiling.trace`` around one projection call of
    ``score_sed_with_clusters`` (``_project``) and one card step (the SIMT
    kernel on a chunk's conv1): its Chrome trace must hold CUDA kernel
    events, the conv kernel's among them."""
    import numpy as np
    import torch

    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes
    from expecto_tpu_torch.ops.conv8 import conv8_relu
    from expecto_tpu_torch.pipeline.sed import _project, align_variants_with_genes
    from expecto_tpu_torch.utils.profiling import trace

    vcf = standardize_chroms(read_vcf(WORK / "variants.vcf"))
    inputs = align_variants_with_genes(vcf, load_closest_genes(WORK / "genes.tsv"), eff)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = torch.randn((CHUNK, 120, 320), device=DEVICE, generator=gen)
    w = torch.randn((8, 320, 480), device=DEVICE, generator=gen) / 40
    b = torch.zeros(480, device=DEVICE)
    log_dir = WORK / "entry" / "trace"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(str(log_dir)):
        _project(inputs, MAXSHIFT, None, 2002, keys=("ref", "alt"))
        conv8_relu(x, w, b)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    files = sorted(log_dir.glob("trace_*.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {len(files)} trace files under {log_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels or not any("conv8_relu" in e.get("name", "") for e in kernels):
        raise AssertionError(f"the trace holds no CUDA kernel event of conv8_relu: {len(kernels)} kernel events")
    out["trace"] = {"events": len(events), "kernel_events": len(kernels), "wall_s": wall,
                    "bytes": files[0].stat().st_size,
                    "kernel_us": float(np.sum([e.get("dur", 0) for e in kernels]))}
    log(f"entry: utils.profiling.trace around a projection call and one conv8_relu launch: {len(events)} events, "
        f"{len(kernels)} CUDA kernel events ({out['trace']['kernel_us']:.1f} us), {wall:.3f} s with the export "
        f"[{card}]")


def entry_exit_phase(report: dict, inputs: dict, eff32: dict, sed_table, card: str, seed: int) -> None:
    """The user's way in and out with the port alone: the ``.pth``
    converter, ``cli.closest_genes`` into ``cli.score``, cluster-attributed
    SED and the sed merge on the h5 phase's effects, and a profiler trace;
    each sub-phase's wall logged with the card."""
    import torch

    torch.cuda.empty_cache()
    out = {}
    for name, fn in (("converter", lambda: _entry_converter(out, inputs, card)),
                     ("closest_genes", lambda: _entry_closest_genes(out, card)),
                     ("clusters_and_merge", lambda: _entry_clusters(out, eff32, sed_table, card, seed)),
                     ("trace", lambda: _entry_trace(out, eff32, card))):
        t0 = time.perf_counter()
        fn()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        log(f"entry and exit: {name} {out[f'{name}_wall_s']:.1f} s [{card}]")
    report["entry_exit"] = out


def _gene_route_plan(runner, genes, genome) -> list[dict]:
    """How each strand group of compute_gene_features ships its chunks: the
    2-bit wire with the N sideband, or 4 bits a base for a chunk that passes
    the sideband's N budget (the runner decides per chunk); with each
    chunk's N count."""
    import numpy as np

    from expecto_tpu_torch.genome.windows import gene_shifts
    from expecto_tpu_torch.pipeline.features import _offset_groups, gene_span_and_offsets

    groups = []
    for offsets, idxs in _offset_groups(genes, gene_shifts(), 2000).items():
        spans = np.stack([gene_span_and_offsets(genome, genes[j].chrom, genes[j].tss, genes[j].strand)[0]
                          for j in idxs])
        n_per_chunk = [int((spans[i : i + GENE_ROWS] == 4).sum()) for i in range(0, len(idxs), GENE_ROWS)]
        routes = [f"{runner._chunk_wire(spans[i : i + GENE_ROWS])[0]}-bit" for i in range(0, len(idxs), GENE_ROWS)]
        groups.append({"strand": "+" if offsets[0] == 0 else "-", "genes": len(idxs), "route_per_chunk": routes,
                       "n_bases_per_chunk": n_per_chunk})
    return groups


def _gene_counts_checked(dtype: str, chunks: int, what: str) -> dict:
    """The launch counts since the last _reset_counts, checked for a gene
    run of ``chunks`` chunks: 16 launches a chunk, 2 conv0 on the
    code-gather kernel and 14 conv8_relu on the dtype's route only; 4 fc1
    launches a chunk on the dtype's kernel (two orientations x two pool-2
    phases)."""
    counts = _read_counts(dtype)
    route, by_route = CONV_ROUTE[dtype], counts["conv8_relu_by_route"]
    want = (2 * chunks, 14 * chunks, 0, 4 * chunks)
    if (counts["conv0_codes"], by_route[route], _off_route(by_route, dtype), counts["fc1_strided"]) != want:
        raise AssertionError(f"{what}: launches {counts}, expected {2 * chunks} conv0, {14 * chunks} {route} and "
                             f"{want[3]} fc1 for {chunks} gene chunks of 16 launches")
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
    """{(layer, L, pool phases): launches} of one consensus conv batch over spans of
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
    backbone's span forward once. Each span chunk (not the backbone)
    launches the dtype's fc1 kernel 4 times (two orientations x two pool-2
    phases); a window batch's fc1 is the per-window matmul."""
    want0 = want8 = want_fc1 = 0
    span_rows = runner._span_rows(GENE_SHIFTS)
    for name, rows, _k in calls:
        if name == "predict_codes":
            c = -(-rows // runner.batch_size)
            want0, want8 = want0 + 2 * c, want8 + 10 * c
        else:
            c = -(-rows // span_rows)
            want_fc1 += 4 * c
            c += name == "project_spans_backbone_patch"
            want0, want8 = want0 + 2 * c, want8 + 14 * c
    counts = _read_counts(kind)
    route, by_route = CONV_ROUTE[kind], counts["conv8_relu_by_route"]
    if (counts["conv0_codes"], by_route[route], _off_route(by_route, kind), counts["fc1_strided"]) != (
            want0, want8, 0, want_fc1):
        raise AssertionError(f"{what}: launches {counts}, expected {want0} conv0, {want8} {route} and {want_fc1} "
                             f"fc1 for {calls}")
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
        x = torch.from_numpy(np.ascontiguousarray(rows)).to(DEVICE)
        base_x = torch.from_numpy(np.ascontiguousarray(bb[None])).to(DEVICE)
        base = conv6_phases(p, base_x, phases)
        base_c1 = conv1_acts(p, base_x)
        w0, d0 = (torch.from_numpy(np.ascontiguousarray(sf[..., i])).to(DEVICE) for i in (0, 1))
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


# ---- pipeline: each flow at depth 1 and at its CLI's depth --------------------


def pipeline_gene_records(seed: int) -> list:
    """PIPE_GENES_PER_STRAND seeded genes a strand on make_inputs' genome,
    plus-strand genes first, as ``records_from_geneanno`` reads them."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.pipeline.features import records_from_geneanno

    rng = np.random.default_rng(seed + 2)  # apart from make_inputs' and make_gene_inputs' streams
    n = 2 * PIPE_GENES_PER_STRAND
    tss = rng.integers(21000, CONTIG_LEN - 21000, n)
    return records_from_geneanno(pd.DataFrame({
        "id": [f"ENSG9{i:06d}" for i in range(n)], "seqnames": np.array(["chr1", "chr2"])[rng.integers(0, 2, n)],
        "strand": ["+"] * PIPE_GENES_PER_STRAND + ["-"] * PIPE_GENES_PER_STRAND, "CAGE_representative_TSS": tss}))


def _pipeline_flows(seed: int):
    """([(name, dtype, batch, CLI depth, call(runner), equal(a, b))], close)
    of the pipeline phase's flows on the earlier phases' inputs: serving
    (``cli.score``'s runner, default depth) in bf16 on every row and in fp32
    on the fp32 serve's rows; the chromatin CLI's streaming h5 step (fp32,
    default depth); the gene call (bf16, ``cli.compute_features``' depth 6)
    on :func:`pipeline_gene_records`; the consensus private mix's track
    predictions (bf16, default depth); ``close`` closes their genome."""
    import inspect

    import numpy as np
    import torch

    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.features import compute_gene_features
    from expecto_tpu_torch.pipeline.sed import score_sed_serving

    default = inspect.signature(BelugaRunner).parameters["pipeline_depth"].default
    genome = FastaIndex(WORK / "genome.fa")
    ml = load_modellist(WORK / "modellist")
    vcf = standardize_chroms(read_vcf(WORK / "variants.vcf"))

    def serving(vcf_path, genes_path):
        vcf_df, gene = standardize_chroms(read_vcf(vcf_path)), load_closest_genes(genes_path)
        return lambda runner: score_sed_serving(vcf_df, gene, genome, runner, ml.iloc[:, 0].tolist(),
                                                maxshift=MAXSHIFT, model_names=ml.iloc[:, 1].tolist())

    def arrays_equal(a, b):
        return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b, strict=True) for k in x)

    genes = pipeline_gene_records(seed)
    private = consensus_cohort(seed, 64, private=True, n_sites=42)
    flows = [
        ("serve_bf16", torch.bfloat16, BATCH, default, serving(WORK / "variants.vcf", WORK / "genes.tsv"),
         lambda a, b: a.equals(b)),
        ("serve_fp32", torch.float32, BATCH, default,
         serving(WORK / "fp32_serve.vcf", WORK / "fp32_serve_genes.tsv"), lambda a, b: a.equals(b)),
        ("h5_stream_fp32", torch.float32, H5_BATCH, default, lambda runner: _chromatin_streaming(runner, vcf, genome),
         arrays_equal),
        ("gene_bf16", torch.bfloat16, GENE_BATCH, GENE_CLI_DEPTH,
         lambda runner: compute_gene_features(genes, genome, runner), np.array_equal),
        ("consensus_private_bf16", torch.bfloat16, CONS_BATCH, default,
         lambda runner: _consensus_call(runner, private, "preds"), np.array_equal),
    ]
    return flows, genome.close


def _chunks_per_call(runner, call) -> list:
    """The chunks of each runner call that ``call(runner)`` makes, counted
    as ``_run_pipelined`` draws them (the runner is left as it was)."""
    counts, run = [], runner._run_pipelined

    def counted(jobs, write):
        n = 0

        def each():
            nonlocal n
            for job in jobs:
                n += 1
                yield job

        try:
            run(each(), write)
        finally:
            counts.append(n)

    runner._run_pipelined = counted
    try:
        call(runner)
    finally:
        del runner._run_pipelined
    return counts


def _pipeline_call(runner, call, depth: int, kind: str) -> tuple:
    """One call at ``depth``: (output, wall s, launch counts, peak device MiB
    over what was resident before it)."""
    import torch

    runner.pipeline_depth = depth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    _reset_counts()
    t0 = time.perf_counter()
    out = call(runner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, _read_counts(kind), (torch.cuda.max_memory_allocated() - resident) / 2**20


def _runs(counts: list) -> str:
    """``[24, 24, 1]`` as "2 x 24, 1"."""
    import itertools

    return ", ".join(f"{len(g)} x {k}" if len(g) > 1 else str(k)
                     for k, g in ((k, list(g)) for k, g in itertools.groupby(counts)))


def _pipeline_profiled(runner, call, depth: int) -> dict:
    """One call at ``depth`` under ``torch.profiler`` and torch's sync debug
    mode "warn": its wall, the card's busy time (the union of the kernel
    and copy intervals, as scripts/profile_serving_torch.py takes it), the
    idle share, the synchronizing operations torch reported (its prototype
    notice aside) and the chunks of each runner call."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    runner.pipeline_depth = depth
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                chunks = _chunks_per_call(runner, call)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    busy_us = _union_us([(start, end) for start, end, _name in profiled_events(prof)])
    syncs = [str(w.message).splitlines()[0] for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    return {"profiled_wall_s": wall, "busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / 1e6 / wall,
            "syncs": len(syncs), "sync_kinds": sorted(set(syncs)), "chunks_per_call": chunks}


def pipeline_phase(report: dict, card: str, seed: int) -> None:
    """Each flow of :func:`_pipeline_flows` on one runner, at depth 1 and at
    its CLI's depth: a warm-up call, then PIPE_REPEATS timed calls a depth
    in turns (1, N, 1, N, ...), launch counts zeroed just before each and
    read just after (equal across every call of the flow), the outputs of
    the two depths equal bit for bit, the peak device memory a depth, and
    one profiled call a depth for the card's idle share and the
    synchronizing operations (none allowed)."""
    import numpy as np
    import torch

    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner

    params = load_params_npz(WORK / "beluga.npz")
    flows, close = _pipeline_flows(seed)
    out = {}
    try:
        for name, dtype, batch, depth, call, equal in flows:
            t_flow = time.perf_counter()
            kind = str(dtype).removeprefix("torch.")
            wire = np.float16 if dtype == torch.bfloat16 else np.float32
            runner = BelugaRunner(params, batch_size=batch, device=DEVICE, compute_dtype=dtype, out_dtype=wire)
            call(runner)  # warm-up
            depths = (1, depth)
            walls, peaks, counts, outs = {d: [] for d in depths}, dict.fromkeys(depths, 0.0), [], {}
            for _ in range(PIPE_REPEATS):
                for d in depths:
                    outs[d], wall, c, peak = _pipeline_call(runner, call, d, kind)
                    walls[d].append(wall)
                    peaks[d] = max(peaks[d], peak)
                    counts.append(c)
            if any(c != counts[0] for c in counts):
                raise AssertionError(f"pipeline {name}: launch counts differ between calls or depths: {counts}")
            if counts[0]["fc1_strided"] <= 0:
                raise AssertionError(f"pipeline {name}: a {kind} flow launched no fc1 kernel: {counts[0]}")
            if not equal(outs[1], outs[depth]):
                raise AssertionError(f"pipeline {name}: the output at depth {depth} differs from depth 1")
            prof = {d: _pipeline_profiled(runner, call, d) for d in depths}
            if any(p["syncs"] for p in prof.values()):
                raise AssertionError(f"pipeline {name}: synchronizing operations in a call: {prof}")
            if name.startswith("gene") and prof[depth]["chunks_per_call"] != [GENE_CLI_DEPTH * 4] * 2:
                raise AssertionError(f"pipeline {name}: runner calls of {prof[depth]['chunks_per_call']} chunks at "
                                     f"depth {depth}, not one full gene block a strand")
            out[name] = {"cli_depth": depth, "dtype": kind, "batch": batch, "launches": counts[0],
                         **{f"depth{d}": {"wall_s": statistics.median(walls[d]), "walls_s": walls[d],
                                          "peak_over_resident_mib": peaks[d], **prof[d]} for d in depths},
                         "phase_s": time.perf_counter() - t_flow}
            log(f"pipeline {name}: " + "; ".join(
                f"depth {d} median {statistics.median(walls[d]):.3f} s of {[round(w, 3) for w in walls[d]]}, idle "
                f"{100 * prof[d]['idle_share']:.1f} % (profiled {prof[d]['profiled_wall_s']:.3f} s), peak +{peaks[d]:.0f} MiB"
                f", runner calls of {_runs(prof[d]['chunks_per_call'])} chunks"
                for d in depths) + f"; outputs bit-equal, launches equal {counts[0]} [{card}]")
            del runner
            torch.cuda.empty_cache()
    finally:
        close()
    report["pipeline"] = out


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
    ``device`` ("cuda": kernels, copies and the ``gblinear_round`` ranges;
    "cpu": host ops and spans), read from the profiler's raw results:
    building ``prof.events()`` takes seconds for a run of 100 training
    rounds. The card-side ranges of every other ``record_function`` span
    (the program's stage spans among them) are left out: they are no
    work of the card's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    if device != "cuda":
        return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
                for e in events if e.device_type() != cuda]
    host = {e.name() for e in events if e.device_type() != cuda}

    def kept(e) -> bool:
        flag = getattr(e, "is_user_annotation", None)
        return e.name() == "gblinear_round" or not ((flag is not None and flag()) or e.name() in host)

    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
            for e in events if e.device_type() == cuda and kept(e)]


def _union_us(intervals) -> float:
    """The length of the union of (start, end) intervals: the card's busy
    time over its kernel and copy events."""
    busy, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


def _cd_checked(b: int, k: int, alpha: float, gen):
    """The coordinate-update kernel against its plain version, bit for bit,
    on :func:`_cd_inputs` of shape (b, k); returns those (g, h, w)."""
    import torch

    from expecto_tpu_torch.ops.gblinear_cd import coord_update, coord_update_plain

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
    return g, h, w


def train_kernel_phase(out: dict, card: str) -> None:
    """The coordinate-update kernel against its plain version, bit for bit,
    at each (block, models) shape of the training calls, the bench's round
    and 1,000 models, with alpha 0 and > 0; then timed beside the plain version and its bound (g, h and
    w read once, w and dw written once: 20 bytes an element): the card's
    time a call (the kernel, or the plain version's kernels) and the
    time a call back to back, which the host's issue rate sets. Then the
    K-model block step's two kernels at each (rows, K) of
    TRAIN_BLOCK_SHAPES (:func:`block_step_row`): checked, timed beside
    their bounds, the plain block step and the torch block step they
    replaced, which they must beat."""
    import torch

    from expecto_tpu_torch.ops.gblinear_cd import coord_update, coord_update_plain

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for b, k in TRAIN_CD_SHAPES:
        for alpha in (0.0, 0.7, 25.0):
            g, h, w = _cd_checked(b, k, alpha, gen)
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
    out["block_layers"] = []
    for n, k in TRAIN_BLOCK_SHAPES:
        row = block_step_row(n, k, gen)
        out["block_layers"].append(row)
        log(f"kernels gblinear_block_grad + gblinear_block_resid (512 x {n:,} rows x K {k}, route {row['route']}): G "
            f"{row['g_rel']:.3g}, r's increment {row['inc_rel']:.3g}, r {row['r_rel']:.3g} of max|.| off float64 (limit "
            f"{TRAIN_BLOCK_REL:g}; late-row faults {row['g_late_row_fault_rel']:.3g}, "
            f"{row['r_late_rows_fault_rel']:.3g}); w and dw the coordinate step on the kernel's G bit for bit, the "
            f"fused update equal to the split route, a rerun equal; a block {row['ms'] * 1e3:.1f} us (gradient "
            f"{row['grad_ms'] * 1e3:.1f}, bound {row['grad_bound']['bound_ms'] * 1e3:.1f} {row['grad_bound']['bound_by']}"
            f"; residual {row['resid_ms'] * 1e3:.1f}, bound {row['resid_bound']['bound_ms'] * 1e3:.1f} "
            f"{row['resid_bound']['bound_by']}; the block's bound {row['block_bound']['bound_ms'] * 1e3:.1f}), plain "
            f"block step {row['plain_ms'] * 1e3:.1f}, the torch block step it replaced {row['yardstick_ms'] * 1e3:.1f} "
            f"({row['speedup_vs_yardstick']:.2f}x), torch.addmm for the residual {row['library_ms'] * 1e3:.1f} [{card}]")
        if k > 1 and row["ms"] >= row["yardstick_ms"]:  # K = 1 (byte-bound both ways) may tie
            raise AssertionError(f"the block step at K = {k} is not faster than the torch block step it replaced: "
                                 f"{row['ms']} against {row['yardstick_ms']} ms")


def block_step_row(n: int, k: int, gen, *, checked: bool = True, timed: bool = True) -> dict:
    """The K-model block step's two kernels (ops/gblinear_block.py) on one
    block of 512 seeded features (the last 7 zero, as a last block's padded
    rows) x ``n`` rows and ``k`` models with integer row weights: G (the
    split route's output) and r's increment (the residual kernel on r = 0)
    within TRAIN_BLOCK_REL of their max|.| against float64, r updated
    within it of max|r|; G from X with its last row changed and r with its
    last 128 rows not advanced (planted faults) must miss; the fused update
    equal to the split route and to ``coord_update_plain`` on the kernel's
    own G bit for bit (w, and dw's planes against ``split_tf32``); a rerun
    equal bit for bit. Then timed
    in turns with CUDA events: each kernel, the two together, the plain
    block step (SGEMM, the plain update), the torch block step they
    replaced (SGEMM and ``gblinear_cd``: the yardstick) and ``torch.addmm``
    (the residual kernel's one-call library equivalent); each kernel's bound
    (three TF32 passes at the tf32 peak against its bytes: X, rw and r read,
    h and w read, w and dw written; X, r and dw read, r written) and the
    block's (both products' passes against X twice, r read twice and
    written once, rw read once).
    ``checked=False`` records the failed checks in the row instead of
    raising (to time a kernel cut down on purpose); ``timed=False`` stops
    after the checks."""
    import torch

    from expecto_tpu_torch.ops import gblinear_block as gbb
    from expecto_tpu_torch.ops.fc1 import split_tf32
    from expecto_tpu_torch.ops.gblinear_cd import coord_update, coord_update_plain, coord_update_planes

    b, eta, lam, alpha = 512, 0.01, 100.0, 0.7
    X = torch.randn((n, b), generator=gen, device=DEVICE)
    X[:, -7:] = 0.0
    Xt = gbb.block_layout(X, b)
    X[n - 1] += 1.0
    Xt_fault = gbb.block_layout(X, b)
    del X
    Xb = Xt[0]
    rw = torch.randint(0, 3, (n, k), generator=gen, device=DEVICE).float()
    rw[n - 1] = 1.0  # the changed last row reaches G in every model
    rw = gbb.transposed_rows(rw)
    r = gbb.transposed_rows(torch.randn((n, k), generator=gen, device=DEVICE) * 2)
    h = (Xb * Xb) @ rw.T
    w0 = torch.randn((b, k), generator=gen, device=DEVICE) * 0.05
    s = gbb.block_scratch(Xt, k, 1)
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    rel = lambda got, want: float((got.double() - want.double()).abs().max() / want.double().abs().max())  # noqa: E731

    def fused_step():
        w, rn = w0.clone(), gbb.transposed_rows(r.T)
        gbb._launch_grad(Xb, rw, rn, s, h, w, eta, lam, alpha, fused=True)
        planes = s.dw.clone()
        gbb.residual_update(Xb, s.dw, rn, scratch=s)
        torch.cuda.synchronize()
        return w, planes, rn

    g64 = Xb.double() @ (rw.double() * r.double()).T
    gbb._launch_grad(Xt_fault[0], rw, r, s, h, w0.clone(), eta, lam, alpha, fused=False)
    g_fault = rel(s.g, g64)
    gbb._launch_grad(Xb, rw, r, s, h, w0.clone(), eta, lam, alpha, fused=False)
    G = s.g.clone()
    w_split = w0.clone()
    coord_update_planes(G, h, w_split, s.dw, eta, lam, alpha)
    planes_split = s.dw.clone()
    w_plain = w0.clone()
    dw = coord_update_plain(G, h, w_plain, eta, lam, alpha)
    inc = gbb.transposed_rows(torch.zeros_like(r.T))
    gbb.residual_update(Xb, s.dw, inc, scratch=s)
    inc64 = dw.double().T @ Xb.double()
    runs = [fused_step(), fused_step()]
    w, planes, rn = runs[0]
    r_fault = rn.clone()
    r_fault[:, -128:] = r[:, -128:]
    row = {"n": n, "B": b, "K": k, "route": s.route._asdict(), "grad_schedule": s.grad._asdict(),
           "resid_grid": s.resid_grid, "g_rel": rel(G, g64), "inc_rel": rel(inc, inc64),
           "r_rel": rel(rn, r.double() + inc64), "g_late_row_fault_rel": g_fault,
           "r_late_rows_fault_rel": rel(r_fault, r.double() + inc64), "limit": TRAIN_BLOCK_REL,
           "max_abs_err": float((G.double() - g64).abs().max()),
           "inc_max_abs_err": float((inc.double() - inc64).abs().max())}
    checks = {
        "G, r's increment and r within the limit of float64": max(row["g_rel"], row["inc_rel"], row["r_rel"])
        <= TRAIN_BLOCK_REL,
        "the planted faults miss": min(g_fault, row["r_late_rows_fault_rel"]) > TRAIN_BLOCK_REL,
        "w and dw equal the coordinate step on the kernel's G": torch.equal(bits(w), bits(w_plain)) and torch.equal(
            planes[:, :k, :b], torch.stack(split_tf32(dw.T.contiguous()))),
        "the fused update equals the split route": torch.equal(bits(w), bits(w_split)) and torch.equal(
            bits(planes), bits(planes_split)),
        "a rerun is equal": all(torch.equal(bits(x), bits(y)) for x, y in zip(runs[0], runs[1])),
    }
    bad = [what for what, ok in checks.items() if not ok]
    row["failed_checks"] = bad
    if bad and checked:
        raise AssertionError(f"block step (n {n}, K {k}): {bad}; {row}")
    del runs, r_fault, Xt_fault, g64, inc64
    if not timed:
        del s, Xt, rw, r
        torch.cuda.empty_cache()
        return row

    wt, rt = w0.clone(), gbb.transposed_rows(r.T)
    calls = {
        "grad_ms": lambda: gbb._launch_grad(Xb, rw, rt, s, h, wt, eta, lam, alpha, fused=True),
        "resid_ms": lambda: gbb.residual_update(Xb, s.dw, rt, scratch=s),
        "grad_plain_ms": lambda: gbb.grad_update_plain(Xb, rw, rt, h, wt, eta, lam, alpha, update=coord_update_plain),
        "resid_plain_ms": lambda: gbb.residual_update_plain(Xb, dw, rt),
        "plain_ms": lambda: gbb.residual_update_plain(
            Xb, gbb.grad_update_plain(Xb, rw, rt, h, wt, eta, lam, alpha, update=coord_update_plain), rt),
        "yardstick_ms": lambda: gbb.residual_update_plain(
            Xb, gbb.grad_update_plain(Xb, rw, rt, h, wt, eta, lam, alpha, update=coord_update), rt),
        "library_ms": lambda: torch.addmm(rt, dw.T, Xb),
    }
    calls["ms"] = lambda: (calls["grad_ms"](), calls["resid_ms"]())
    times = {key: [] for key in calls}
    for order in (list(calls), list(calls)[::-1]):
        for key in order:
            slow = "plain" in key or key == "yardstick_ms"
            times[key].append(cuda_ms(calls[key], reps=5 if slow else 20, warmup=2))
    row.update({key: min(v) for key, v in times.items()}, times=times)
    flops = 3 * 2.0 * b * n * k
    row["grad_bound"] = _bound(4.0 * (b * n + 2 * n * k + 4 * b * k), flops, "tf32")
    row["resid_bound"] = _bound(4.0 * (b * n + 2 * n * k + b * k), flops, "tf32")
    row["block_bound"] = _bound(4.0 * (2 * b * n + 4 * n * k), 2 * flops, "tf32")
    row["speedup_vs_yardstick"] = row["yardstick_ms"] / row["ms"]
    if not bool(torch.isfinite(wt).all() and torch.isfinite(rt).all()):
        raise AssertionError(f"block step (n {n}, K {k}): the timed steps left non-finite weights or residuals")
    del s, Xt, rw, r, rt
    torch.cuda.empty_cache()
    return row


def _round_trace(prof, rounds: int) -> dict:
    """From a ``torch.profiler`` run of one training call: each round's
    device range (the ``gblinear_round`` annotation: first kernel to last),
    the card's busy time inside those ranges (the union of kernel and copy
    intervals) and its kernel time by kind: the round kernel, the
    coordinate-update kernel, the block step's gradient and residual
    kernels, torch's elementwise and reduction kernels, and the products
    (every other kernel: cuBLAS's GEMV/GEMM); and the whole call's busy
    time."""
    ranges, dev = [], []
    for ev in profiled_events(prof):
        (ranges if ev[2] == "gblinear_round" else dev).append(ev)
    if len(ranges) != rounds:
        raise AssertionError(f"the profile holds {len(ranges)} gblinear_round ranges on the card, not {rounds}")
    ranges.sort()
    by_kind = {"gblinear_round": 0.0, "gblinear_cd": 0.0, "gblinear_block_grad": 0.0, "gblinear_block_resid": 0.0,
               "elementwise": 0.0, "products": 0.0, "copies": 0.0}
    inside = []
    j = 0
    dev.sort()
    for s, e, name in dev:
        while j < len(ranges) and ranges[j][1] < s:
            j += 1
        if j < len(ranges) and ranges[j][0] <= s and e <= ranges[j][1]:
            inside.append((s, e))
            kind = next((k for k in TRAIN_KERNELS if k in name), None) or (
                "copies" if "Memcpy" in name or "Memset" in name else "elementwise" if "at::native" in name
                else "products")
            by_kind[kind] += (e - s) / 1e3
    sweep_ms = sum(e - s for s, e, _ in ranges) / 1e3
    busy_ms = _union_us(inside) / 1e3
    return {"rounds": rounds, "ms_per_round": (ranges[-1][1] - ranges[0][0]) / 1e3 / rounds,
            "sweep_ms_per_round": sweep_ms / rounds, "sweep_idle_share": 1 - busy_ms / sweep_ms,
            "kernel_ms_by_kind": by_kind, "call_busy_ms": _union_us([(s, e) for s, e, _ in dev]) / 1e3}


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


def _train_counts() -> dict:
    """The training kernels' launches since their counts were zeroed: the
    round kernel, the coordinate-update kernel (both entries), the block
    step's gradient kernel (by route) and residual kernel."""
    from expecto_tpu_torch.ops import gblinear_block, gblinear_cd, gblinear_round

    return {"gblinear_round": gblinear_round.gblinear_round.launches, "gblinear_cd": gblinear_cd.coord_update.launches,
            "gblinear_block_grad": gblinear_block.grad_update.launches,
            "gblinear_block_grad_by_route": dict(gblinear_block.grad_update.launches_by_route),
            "gblinear_block_resid": gblinear_block.residual_update.launches}


def _reset_train_counts() -> None:
    from expecto_tpu_torch.ops import gblinear_block, gblinear_cd, gblinear_round

    gblinear_cd.reset_launch_counts()
    gblinear_round.reset_launch_counts()
    gblinear_block.reset_launch_counts()


def _launch_checked(fn, what: str, *, rounds: int = 0, blocks: int = 0, block_steps: int = 0):
    """``fn()`` timed on the host clock (ending in a synchronize), with the
    training kernels' counts zeroed just before and read just after: the
    round kernel's must be ``rounds``, the coordinate update's ``blocks``,
    and the block step's two kernels' ``block_steps`` each (the gradient
    kernel's on the fused route: one process)."""
    import torch

    torch.cuda.synchronize()
    _reset_train_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _train_counts()
    want = {"gblinear_round": rounds, "gblinear_cd": blocks, "gblinear_block_grad": block_steps,
            "gblinear_block_grad_by_route": {"fused": block_steps, "split": 0}, "gblinear_block_resid": block_steps}
    if got != want:
        raise AssertionError(f"{what}: training kernel launches {got}, expected {want}")
    return res, wall


def _log_train_call(what: str, c: dict, card: str) -> None:
    log(f"{what}: wall {c['wall_s']:.3f} s (profiled {c['profiled_wall_s']:.3f} s), {c['ms_per_round']:.3f} ms a "
        f"round ({c['sweep_ms_per_round']:.3f} ms of it the block sweep, idle {100 * c['sweep_idle_share']:.1f} %), "
        f"call idle {100 * c['call_idle_share']:.1f} %; sweep kernels " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in c["kernel_ms_by_kind"].items()) + f"; launches {c['launches']} [{card}]")


def stale_residual_round(Xt, col_hess, w_blocks, bias, r, scratch, denom, eta, lam, alpha, *, update):
    """A planted fault: the plain round (ops/gblinear_round.py) with r left
    unadvanced after the first block, so the second block's gradient is
    stale. Swapped in for ``models/gblinear.gblinear_round``."""
    db = eta * (-r.sum() / denom)
    bias += db
    r += db
    for i, (Xb, hb, wb) in enumerate(zip(Xt, col_hess, w_blocks)):
        dw = update(Xb @ r, hb, wb, eta, lam, alpha)
        if i != 0:
            r += dw @ Xb


def _model_gaps(want, got) -> dict:
    """A single-model training run against another: weights over max|w|
    of ``want``, the bias and the per-round RMSE of every watchlist set."""
    import numpy as np

    return {"w_over_max_w": float(np.abs(got.weight - want.weight).max() / np.abs(want.weight).max()),
            "bias": abs(float(got.bias) - float(want.bias)),
            "rmse": max(float(np.abs(np.subtract(got.eval_history[k], want.eval_history[k])).max())
                        for k in want.eval_history)}


def _within_train_limits(gaps: dict) -> bool:
    return all(gaps[k] <= v for k, v in TRAIN_ROUND_LIMITS.items())


def _gaps_text(gaps: dict) -> str:
    return ", ".join(f"{k} {gaps[k]:.3g} (limit {v:g})" for k, v in TRAIN_ROUND_LIMITS.items())


def _check_round_geometry(g, n: int, b: int) -> None:
    """The round kernel's plan (``ops/gblinear_round.device_geometry``) for n
    rows and blocks of ``b`` features, held to what the kernel needs: one
    CTA an SM, every CTA's rows within its tiles, whole stages over the
    block, at least two ring slots beside the cache, the (C) groups within
    the consumer threads (512) and the shared memory within the card's
    limit. Raises if any fails."""
    import numpy as np
    import torch

    from expecto_tpu_torch.ops.gblinear_round import row_plan

    lo, hi = row_plan(n, g.ctas)
    checks = {
        "one CTA an SM": g.ctas == torch.cuda.get_device_properties(0).multi_processor_count,
        "rows within the tiles": int(np.max(hi - lo)) <= g.rows_max <= g.tile * g.tiles_max,
        "tile of float4s": g.tile % 4 == 0 and 0 < g.tile <= 256,
        "whole stages": g.stage_rows * g.stages >= b > g.stage_rows * (g.stages - 1),
        "two ring slots": 0 <= g.cache <= min(g.slots - 2, g.stages),
        "groups": 1 <= g.groups and g.groups * g.tile // 4 <= 512,
        "r's floats": g.r_floats == (g.tile if g.streamed else g.tile * g.tiles_max),
        "shared memory": g.smem <= g.optin,
    }
    if not all(checks.values()):
        raise AssertionError(f"the round kernel's plan at {n} rows x blocks of {b} fails "
                             f"{[k for k, v in checks.items() if not v]}: {g}")


def train_round_phase(out: dict, X, n_rows: int, card: str) -> None:
    """The round kernel at the published shape: the first ``n_rows`` rows of
    the features (the K = 1 call's training-row count), 40 blocks of 512,
    the reference's hyperparameters. One round from zero weights against the
    plain round on the same inputs (weights, bias and the RMSE of r within
    TRAIN_ROUND_LIMITS) and against a rerun (bit for bit); then timed with
    CUDA events, the state advancing round by round, in turns beside the
    plain round (the per-block loop: two GEMVs, the coordinate-update kernel
    and an add a block), a CUDA-graph replay of one plain round (a
    yardstick: what removing the launches alone buys) and the bound (X, the
    hessians and the weights read once; the weights, bias and r written
    once; 4 flops an element of X)."""
    import numpy as np
    import torch

    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops import cuda_build
    from expecto_tpu_torch.ops.gblinear_cd import coord_update
    from expecto_tpu_torch.ops.gblinear_round import (device_geometry, gblinear_round, gblinear_round_plain,
                                                      round_scratch)

    hp = gblinear.GBLinearParams()
    Xt, n_blocks = gblinear._pad_blocks(torch.from_numpy(X[:n_rows]).to(DEVICE).T, hp.block_size)
    hess = torch.stack([Xb.double().square().sum(1) for Xb in Xt]).float()
    r0 = torch.randn(n_rows, generator=torch.Generator(device=DEVICE).manual_seed(10), device=DEVICE)
    denom, scratch, args = float(n_rows), round_scratch(Xt), (hp.eta, hp.reg_lambda, hp.reg_alpha)

    def state():
        return torch.zeros((n_blocks, hp.block_size), device=DEVICE), torch.zeros(1, device=DEVICE), r0.clone()

    runs = {}
    for tag, fn in (("kernel", gblinear_round), ("again", gblinear_round), ("plain", gblinear_round_plain)):
        w, b, r = state()
        fn(Xt, hess, w, b, r, scratch, denom, *args, update=coord_update)
        torch.cuda.synchronize()
        runs[tag] = (w, b, r)
    if not all(torch.equal(a.view(torch.int32), z.view(torch.int32)) for a, z in zip(runs["kernel"], runs["again"])):
        raise AssertionError("the round kernel differs from a rerun on the same inputs")
    (wk, bk, rk), (wp, bp, rp) = runs["kernel"], runs["plain"]
    gaps = {"w_over_max_w": float((wk - wp).abs().max() / wp.abs().max()), "bias": float((bk - bp).abs().max()),
            "rmse": float((rk.square().mean().sqrt() - rp.square().mean().sqrt()).abs())}
    if not _within_train_limits(gaps):
        raise AssertionError(f"one round: the round kernel vs the plain round {gaps} exceeds {TRAIN_ROUND_LIMITS}")
    row = {"n": n_rows, "n_blocks": n_blocks, "B": hp.block_size, "gaps_vs_plain": gaps,
           "max_abs_err": float((wk - wp).abs().max()), "r_max_abs_err": float((rk - rp).abs().max())}
    del runs

    w, b, r = state()
    calls = {"ms": lambda: gblinear_round(Xt, hess, w, b, r, scratch, denom, *args),
             "plain_ms": lambda: gblinear_round_plain(Xt, hess, w, b, r, None, denom, *args, update=coord_update)}
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls["plain_ms"]()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        calls["plain_ms"]()
    calls["graph_ms"] = graph.replay
    times = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            times[k].append(cuda_ms(calls[k], reps=5 if k == "plain_ms" else 20, warmup=2))
    row.update({k: min(v) for k, v in times.items()}, times=times)
    row.update(_bound(4.0 * (Xt.numel() + 3 * w.numel() + 2 * n_rows + 2), 4.0 * Xt.numel(), "fp32"))
    if not bool(torch.isfinite(w).all() and torch.isfinite(r).all()):
        raise AssertionError("the timed rounds left non-finite weights or residuals")
    geom = device_geometry(torch.cuda.current_device(), n_rows, hp.block_size)
    row["smem_bytes"], row["ctas"] = geom.smem, geom.ctas
    _check_round_geometry(geom, n_rows, hp.block_size)
    row["geometry"] = geom._asdict()
    row["sass_local"] = {op: cuda_build.sass_count("gblinear_round", op) for op in ("LDL", "STL")}
    if any(row["sass_local"].values()):
        raise AssertionError(f"the round kernel's SASS spills to local memory: {row['sass_local']}")
    out["round"] = row
    del graph, Xt, hess
    torch.cuda.empty_cache()
    log(f"kernel gblinear_round ({n_blocks} blocks of {hp.block_size} x {n_rows} rows): {row['ms']:.3f} ms a round, "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f} % of it); plain "
        f"round {row['plain_ms']:.3f} ms, CUDA graph of the plain round {row['graph_ms']:.3f} ms; one round vs the "
        f"plain round: " + _gaps_text(gaps) + f"; a rerun equal bit for bit; {row['ctas']} CTAs of "
        f"{row['smem_bytes']} bytes of dynamic shared memory ({geom.slots} ring slots of {geom.stage_rows} x "
        f"{geom.tile}, {geom.cache} kept for the residual update); SASS local loads {row['sass_local']['LDL']}, "
        f"stores {row['sass_local']['STL']} [{card}]")


def train_phase(report: dict, card: str, seed: int):
    """gblinear training at the published width: the coordinate-update
    kernel's checks; three timed calls (one tissue with its watchlist, K =
    1, on the round kernel; all 218 tissues in one sweep; 128 bootstrap
    seeds through the CLI), each launch-checked and profiled once for its
    round time and idle share; K = 1 against a second run (bit for bit), the
    plain round swapped in (within TRAIN_ROUND_LIMITS) and a planted stale
    residual (beyond them); the round kernel at the published shape
    (:func:`train_round_phase`); the CLI's models against the in-process
    sweep; card vs CPU on a reduced problem with two planted faults. Returns
    the one-tissue (K = 1) model, the analysis phase's main model."""
    import numpy as np
    import torch

    from expecto_tpu_torch.cli import train as train_cli
    from expecto_tpu_torch.io.xgb import load_expression_model
    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops.gblinear_round import gblinear_round, gblinear_round_plain
    from expecto_tpu_torch.pipeline import train as ptrain

    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    inp = make_train_inputs(seed)
    out["inputs_s"] = time.perf_counter() - t0
    X, geneanno, expression = inp["X"], inp["geneanno"], inp["expression"]
    n_blocks = -(-TRAIN_FEATURES // gblinear.GBLinearParams().block_size)
    launches = n_blocks * TRAIN_ROUNDS
    log(f"train inputs: {X.shape} features, {expression.shape[1] - 1} tissues ({out['inputs_s']:.1f} s)")
    train_kernel_phase(out, card)

    # one tissue, its watchlist on: the round kernel's run, a rerun, the plain round swapped in, a planted fault
    def one_tissue():
        return ptrain.train_expression_model(X, geneanno, expression.iloc[:, 1].values, device=DEVICE)

    def product_form(X_tr, y_tr, hp=None, *, evals, **kw):
        """train_gblinear with the training set passed as a copy: its RMSE from
        a product with X each round, as before the residual's form"""
        return gblinear.train_gblinear(X_tr, y_tr, hp, evals=[(Xe.copy() if Xe is X_tr else Xe, ye, name)
                                                              for Xe, ye, name in evals], **kw)

    peak = {}
    for form in ("product", "r"):  # the call's peak device memory over what the process held before it
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if form == "r":
            k1, wall = _launch_checked(one_tissue, "train_expression_model", rounds=TRAIN_ROUNDS)
        else:
            ptrain.train_gblinear = product_form
            try:
                k1_product, wall_product = _launch_checked(one_tissue, "train_expression_model, product form",
                                                           rounds=TRAIN_ROUNDS)
            finally:
                ptrain.train_gblinear = gblinear.train_gblinear
        peak[form] = (torch.cuda.max_memory_allocated() - base) / 2**20
    rmse_gap = float(np.abs(np.subtract(k1.model.eval_history["train"], k1_product.model.eval_history["train"])).max())
    if not (rmse_gap <= TRAIN_ROUND_LIMITS["rmse"] and np.array_equal(k1.model.weight, k1_product.model.weight)
            and k1.model.eval_history["eval"] == k1_product.model.eval_history["eval"]):
        raise AssertionError(f"train_expression_model: the training RMSE from r differs from the product form by "
                             f"{rmse_gap} (limit {TRAIN_ROUND_LIMITS['rmse']}), or the weights or eval history differ")
    gblinear.gblinear_round = gblinear_round_plain
    try:
        k1_plain, wall_plain = _launch_checked(one_tissue, "train_expression_model, plain round", blocks=launches)
        gblinear.gblinear_round = stale_residual_round
        k1_stale, _ = _launch_checked(one_tissue, "train_expression_model, stale residual", blocks=launches)
    finally:
        gblinear.gblinear_round = gblinear_round
    k1_again, c = _profiled_train_call(one_tissue, TRAIN_ROUNDS)
    if not (np.array_equal(k1_again.model.weight, k1.model.weight) and k1_again.model.bias == k1.model.bias
            and k1_again.model.eval_history == k1.model.eval_history):
        raise AssertionError("train_expression_model with the round kernel differs from a second run")
    gaps = {what: _model_gaps(k1.model, other.model) for what, other in (("plain", k1_plain), ("stale", k1_stale))}
    if not _within_train_limits(gaps["plain"]):
        raise AssertionError(f"train_expression_model: the round kernel vs the plain round {gaps['plain']} exceeds "
                             f"{TRAIN_ROUND_LIMITS}")
    if _within_train_limits(gaps["stale"]):
        raise AssertionError(f"the planted stale residual stays within {TRAIN_ROUND_LIMITS}: {gaps['stale']}")
    n_tr = len(k1.train_true)
    c.update(wall_s=wall, wall_plain_s=wall_plain, launches=TRAIN_ROUNDS, launches_gblinear_cd=0, train_genes=n_tr,
             test_genes=len(k1.test_true), spearman=k1.spearman, gaps_vs_plain=gaps["plain"],
             gaps_stale_fault=gaps["stale"], round_kernel_ms=c["kernel_ms_by_kind"]["gblinear_round"] / TRAIN_ROUNDS,
             train_rmse_from_r_vs_product=rmse_gap, wall_product_form_s=wall_product, peak_mib=peak["r"],
             peak_mib_product_form=peak["product"])
    out["k1"] = c
    _log_train_call(f"train_expression_model (1 tissue, {n_tr} train genes, watchlist on)", c, card)
    log(f"  equal bit for bit to a second (profiled) run; the plain round swapped in (wall {wall_plain:.3f} s): "
        + _gaps_text(gaps["plain"]) + "; the plain round with a stale residual: " + _gaps_text(gaps["stale"])
        + f"; the round kernel {c['round_kernel_ms']:.3f} ms a round on the card; chr8 spearman {k1.spearman:.4f}; "
        f"the training RMSE from r vs the product form: {rmse_gap:.3g} (limit {TRAIN_ROUND_LIMITS['rmse']:g}); peak "
        f"device memory {peak['r']:.1f} MiB (product form {peak['product']:.1f} MiB, wall {wall_product:.3f} s)")
    if not (np.isfinite(k1.model.weight).all() and k1.spearman > TRAIN_MIN_SPEARMAN):
        raise AssertionError(f"one-tissue model: finite weights and a chr8 Spearman above {TRAIN_MIN_SPEARMAN} "
                             f"expected, got {k1.spearman}")
    del k1_again, k1_plain, k1_stale, k1_product
    train_round_phase(out, X, n_tr, card)

    # every tissue in one sweep
    def all_tissues():
        return ptrain.train_all_tissues(X, geneanno, expression, vectorized=True, metrics_path=None, device=DEVICE)

    allt, wall = _launch_checked(all_tissues, "train_all_tissues(vectorized=True)", block_steps=launches)
    allt_again, c = _profiled_train_call(all_tissues, TRAIN_ROUNDS)
    names = list(allt)
    if names != list(expression.columns[1:]) or not all(
            np.array_equal(allt[t].model.weight, allt_again[t].model.weight) for t in names):
        raise AssertionError("train_all_tissues: tissues missing or two runs differ")
    n_tr = len(allt[names[0]].train_true)
    c.update(wall_s=wall, launches=launches, launches_gblinear_cd=0, train_genes=n_tr, tissues=len(names),
             spearman_median=float(np.median([r.spearman for r in allt.values()])))
    f_pad = n_blocks * gblinear.GBLinearParams().block_size
    block_ms = c["kernel_ms_by_kind"]["gblinear_block_grad"] + c["kernel_ms_by_kind"]["gblinear_block_resid"]
    # the block sweep's two products (2 x 2 F n K flops a round) on the block kernels' time, and the three
    # TF32 passes they run against the TF32 peak
    c["products_tflop_per_s"] = 4 * f_pad * n_tr * len(names) * TRAIN_ROUNDS / (block_ms * 1e9)
    c["products_share_of_peak_tf32_three_pass"] = 3 * c["products_tflop_per_s"] * 1e12 / PEAK_FLOPS["tf32"]
    out["k218"] = c
    _log_train_call(f"train_all_tissues (vectorized, {len(names)} tissues, {n_tr} train genes)", c, card)
    log(f"  block-sweep products {c['products_tflop_per_s']:.2f} TFLOP/s of fp32 work on the two block kernels "
        f"(three TF32 passes: {100 * c['products_share_of_peak_tf32_three_pass']:.1f} % of "
        f"{PEAK_FLOPS['tf32'] / 1e12:.0f}); median chr8 spearman {c['spearman_median']:.4f}")
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
    rc, wall = _launch_checked(lambda: train_cli.main(argv), "cli.train --bootstrap_seeds", block_steps=launches)
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
    c.update(cli_wall_s=wall, launches=launches, launches_gblinear_cd=0, seeds=TRAIN_BOOT_SEEDS,
             spearman_mean=float(np.nanmean([r.spearman for r in boot])))
    out["boot"] = c
    log(f"cli.train --bootstrap_seeds {TRAIN_BOOT_SEEDS}: wall {wall:.3f} s (the npy and CSVs loaded, "
        f"{2 * TRAIN_BOOT_SEEDS} model files written); every seed's .save equal to the in-process sweep")
    c["wall_s"] = c["profiled_wall_s"]
    _log_train_call(f"train_bootstrap in process ({TRAIN_BOOT_SEEDS} seeds, profiled only)", c, card)
    del boot

    train_cpu_check(out, X, expression)
    del X, inp
    train_row_cap_check(out, card, seed)
    report["train"] = out
    return k1.model


def train_row_cap_check(out: dict, card: str, seed: int) -> None:
    """The round kernel's two shared-memory plans (csrc/gblinear_round.cu's
    ``plan``): the most rows its "shared" plan takes at F = B = 512 on this
    card (one block), then ``train_gblinear`` with the rows drawn on the card
    and passed as the user's numpy X, at that cap (the "shared" plan) and
    one row past it (the "streamed" plan): one round-kernel launch a round
    either way and no coordinate update, each held to the plain round
    (``gblinear_round_plain`` with ``coord_update_plain`` swapped in) within
    TRAIN_ROUND_LIMITS. Each plan's round is also timed alone on the drawn
    X against the plain round and its bound (as in
    :func:`train_round_phase`)."""
    import numpy as np
    import torch

    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops import gblinear_cd
    from expecto_tpu_torch.ops import gblinear_round as gr

    b = 512
    lo, hi = 1, 1 << 26
    while lo < hi:  # the most rows of the "shared" plan
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if gr.round_plan(0, mid, b) == "shared" else (lo, mid - 1)
    cap = lo
    rounds = 3
    hp = gblinear.GBLinearParams(num_round=rounds, block_size=b)
    res = {"block": b, "cap_rows": cap, "rounds": rounds}
    for n, plan in ((cap, "shared"), (cap + 1, "streamed")):
        _check_round_geometry(gr.device_geometry(0, n, b), n, b)
        torch.cuda.empty_cache()
        gen = torch.Generator(device=DEVICE).manual_seed(seed + n % 1009)
        t0 = time.perf_counter()
        X_dev = torch.randn((n, b), device=DEVICE, generator=gen)
        y_dev = 2.0 + X_dev[:, :16] @ torch.randn(16, device=DEVICE, generator=gen) + 0.3 * torch.randn(
            n, device=DEVICE, generator=gen)
        X, y = X_dev.cpu().numpy(), y_dev.cpu().numpy()
        draw_s = time.perf_counter() - t0
        timed = _row_cap_round_ms(X_dev, y_dev)
        del X_dev, y_dev
        torch.cuda.empty_cache()

        def fit():
            return gblinear.train_gblinear(X, y, hp, evals=[(X, y, "train")], device=DEVICE)

        got, wall = _launch_checked(fit, f"train_gblinear at {n} rows", rounds=rounds)
        by_plan = dict(gr.gblinear_round.launches_by_plan)
        if by_plan[plan] != rounds:
            raise AssertionError(f"train_gblinear at {n} rows: round-kernel launches by plan {by_plan}, expected "
                                 f"{rounds} in the {plan} plan")
        torch.cuda.empty_cache()
        gblinear.gblinear_round, gblinear.coord_update = gr.gblinear_round_plain, gblinear_cd.coord_update_plain
        try:
            want, wall_plain = _launch_checked(fit, f"train_gblinear at {n} rows, plain round")
        finally:
            gblinear.gblinear_round, gblinear.coord_update = gr.gblinear_round, gblinear_cd.coord_update
        gaps = _model_gaps(want, got)
        if not (_within_train_limits(gaps) and np.isfinite(got.weight).all()):
            raise AssertionError(f"train_gblinear at {n} rows ({plan} plan) vs the plain round: {gaps}")
        res[plan] = {"rows": n, "x_gb": X.nbytes / 1e9, "draw_s": draw_s, "wall_s": wall, "wall_plain_s": wall_plain,
                     "launches_by_plan": by_plan, "gaps": gaps, **timed}
        log(f"round row cap: train_gblinear at {n:,} rows x {b} features ({X.nbytes / 1e9:.2f} GB, drawn on the card "
            f"and fetched in {draw_s:.1f} s), {rounds} rounds, {rounds} launches of the round kernel's {plan} plan, "
            f"in {wall:.2f} s (plain round {wall_plain:.2f} s): " + _gaps_text(gaps) + f"; one round alone "
            f"{timed['ms']:.3f} ms, bound {timed['bound_ms']:.3f} ms ({timed['bound_by']}, "
            f"{100 * timed['bound_ms'] / timed['ms']:.1f} % of it), plain round {timed['plain_ms']:.3f} ms [{card}]")
        del X, y, got, want
    out["row_cap"] = res


def _row_cap_round_ms(X_dev, y_dev) -> dict:
    """One round of the round kernel and of the plain round on ``X_dev``
    (n, B) as one block of B features (r = 2 - y, the trainer's hyper-
    parameters), ms a round by CUDA events (the least of two), and the
    round's bound: X, the hessians and weights read once, the weights, bias
    and r written once, 4 flops an element of X."""
    import torch

    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops.gblinear_cd import coord_update
    from expecto_tpu_torch.ops.gblinear_round import gblinear_round, gblinear_round_plain, round_scratch

    n, b = X_dev.shape
    hp = gblinear.GBLinearParams(block_size=b)
    Xt, _ = gblinear._pad_blocks(X_dev.T, b)
    hess = torch.linalg.vector_norm(Xt[0], dim=1).square().view(1, b)
    w, bias, r = torch.zeros((1, b), device=DEVICE), torch.zeros(1, device=DEVICE), 2.0 - y_dev
    scratch, args = round_scratch(Xt), (float(n), hp.eta, hp.reg_lambda, hp.reg_alpha)
    calls = {"ms": lambda: gblinear_round(Xt, hess, w, bias, r, scratch, *args),
             "plain_ms": lambda: gblinear_round_plain(Xt, hess, w, bias, r, None, *args, update=coord_update)}
    times = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            times[k].append(cuda_ms(calls[k], reps=3, warmup=1))
    if not bool(torch.isfinite(w).all() and torch.isfinite(r).all()):
        raise AssertionError(f"the timed rounds at {n} rows left non-finite weights or residuals")
    row = {k: min(v) for k, v in times.items()}
    row.update(_bound(4.0 * (Xt.numel() + 3 * b + 2 * n + 2), 4.0 * Xt.numel(), "fp32"))
    return row


def train_cpu_check(out: dict, X, expression) -> None:
    """``train_gblinear_multi`` on the card against the CPU on a reduced
    problem (the first rows, the first tissues, the published feature width,
    an L1 weight), weights within TRAIN_CPU_RTOL of max|w|; one round fewer
    and alpha's sign swapped, both on the card, must exceed that limit. The
    card's sound run launches the block step's two kernels once a block a
    round each, and no coordinate update."""
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
    card, card_s = _launch_checked(lambda: run(DEVICE), "train_gblinear_multi (card vs CPU)",
                                   block_steps=TRAIN_SMALL_ROUNDS * -(-TRAIN_FEATURES // 512))
    gaps = {}
    for what, res in (("card", card), ("one round fewer", run(DEVICE, rounds=TRAIN_SMALL_ROUNDS - 1)),
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
                        "bias_gap": bias_gap, "cpu_s": cpu_s, "card_s": card_s,
                        "block_steps": TRAIN_SMALL_ROUNDS * -(-TRAIN_FEATURES // 512),
                        **{f"gap_{k}": v for k, v in gaps.items()}}
    fewer, swapped = gaps["one round fewer"], gaps["alpha's sign swapped"]
    log(f"train card vs CPU ({TRAIN_SMALL_ROWS} rows x {TRAIN_FEATURES} features, K {TRAIN_SMALL_K}, "
        f"{TRAIN_SMALL_ROUNDS} rounds, alpha {TRAIN_SMALL_ALPHA}): weights {gaps['card']:.3g} (limit {limit:.3g} = "
        f"{TRAIN_CPU_RTOL:g} x max|w|), biases {bias_gap:.3g}; planted faults: one round fewer {fewer:.3g}, "
        f"alpha's sign swapped {swapped:.3g}")


def make_analysis_inputs(seed: int, main_model) -> dict:
    """The analysis phase's seeded inputs under build/chip_smoke/analysis
    beside the earlier phases' outputs: a 2,002-mark features table
    (``features.tsv``: TF, DNase and histone marks over a pool of TF
    symbols), its ``all_feature_clusters.tsv`` (the port's
    ``feature_clusters_table`` over seeded labels, plus each row's mark),
    the training phase's K = 1 model as ``main.save`` (the port's writer),
    the first substitutions of the phase inputs' VCF with IDs, a MEME file
    of seeded motifs, an RSAT cluster -> motif table over the entry phase's
    20 clusters, the entry phase's RSAT table with those IDs, an enrichment
    table over the motifs, a counts table over the training genes, JASPAR
    and HOCOMOCO files with a Lambert list and an HGNC mapping, and a
    (2,002 x 20) embedding of planted groups."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.analysis.cluster import feature_clusters_table
    from expecto_tpu_torch.io.tables import load_beluga_features
    from expecto_tpu_torch.io.xgb import save_expression_model

    d = WORK / "analysis"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed + 12)
    n_marks = TRAIN_FEATURES // 10
    tfs = [f"TF{i}" if i % 3 else f"Tf{i}" for i in range(ANALYSIS_TF_POOL)] + ["Pol2", "POLR2A"]
    kinds = rng.choice(["TF", "DNase", "Histone"], size=n_marks, p=[0.7, 0.1, 0.2])
    assays = np.where(kinds == "TF", rng.choice(tfs, size=n_marks),
                      np.where(kinds == "DNase", "DNase", rng.choice(["H3K4me3", "H3K27ac", "H3K36me3"], size=n_marks)))
    pd.DataFrame({"Cell type": [f"cell{i % 97}" for i in range(n_marks)], "Assay": assays, "Treatment": "None",
                  "Assay type": kinds, "Source": "ENCODE"}).to_csv(d / "features.tsv", sep="\t")
    features = load_beluga_features(d / "features.tsv")
    table = feature_clusters_table(features, rng.integers(0, 10, size=(n_marks, 10)))
    table["mark"] = np.repeat(np.arange(n_marks), 10)
    table.to_csv(d / "all_feature_clusters.tsv", sep="\t")
    save_expression_model(main_model, d / "main.save")

    # the first substitutions, each with an ID, for fimo-query
    subs = [line.split("\t") for line in (WORK / "variants.vcf").read_text().splitlines()]
    subs = [r for r in subs if len(r[3]) == len(r[4]) == 1][:ANALYSIS_SUBS]
    ids = {(r[0], int(r[1]), r[3], r[4]): f"rs{i}" for i, r in enumerate(subs)}
    (d / "subs.vcf").write_text("".join(f"{c}\t{p}\t{ids[(c, int(p), ref, alt)]}\t{ref}\t{alt}\t.\t.\t.\n"
                                        for c, p, _id, ref, alt in subs))

    lines = ["MEME version 4", "", "ALPHABET= ACGT", "", "strands: + -", "", "Background letter frequencies",
             "A 0.29 C 0.21 G 0.21 T 0.29", ""]
    motif_alt = []
    for m in range(ANALYSIS_MOTIFS):
        w = int(rng.integers(ANALYSIS_MOTIF_WIDTHS[0], ANALYSIS_MOTIF_WIDTHS[1] + 1))
        motif_alt.append(tfs[int(rng.integers(len(tfs) - 2))])
        lines += [f"MOTIF MA{m:04d}.1 {motif_alt[-1]}",
                  f"letter-probability matrix: alength= 4 w= {w} nsites= {int(rng.integers(8, 60))} E= 0"]
        lines += [" " + " ".join(f"{p:.6f}" for p in row) for row in rng.dirichlet([0.3] * 4, size=w)] + [""]
    (d / "motifs.meme").write_text("\n".join(lines) + "\n")

    # the entry phase's 20 RSAT clusters, each holding 2-5 of the motifs' TF names
    (d / "rsat_motifs.tsv").write_text("".join(
        f"rsat_{k}\t{','.join(sorted(set(rng.choice(motif_alt, int(rng.integers(2, 6))))))}\n"
        for k in range(ENTRY_CLUSTERS)))
    contribs = pd.read_csv(WORK / "entry" / "clusters_rsat" / "sed.tsv", sep="\t")
    contribs["2"] = [ids.get((c, int(p), ref, alt), ".") for c, p, ref, alt in
                     zip(contribs["0"], contribs["1"], contribs["3"], contribs["4"])]
    contribs.to_csv(d / "contribs.tsv", sep="\t", index=False)
    q = rng.random(ANALYSIS_MOTIFS) * 0.05
    pd.DataFrame({"hypergeom_qval": q}, index=pd.Index([f"MA{m:04d}.1" for m in range(ANALYSIS_MOTIFS)],
                                                       name="motif")).to_csv(d / "enrichment.tsv", sep="\t")

    genes = pd.read_csv(WORK / "train" / "geneanno.csv", usecols=["id"])["id"].to_numpy()
    picked = rng.permutation(genes)[: int(0.95 * len(genes))]
    pd.DataFrame({f"t{j}": rng.gamma(1.0 + j, 4.0, len(picked)) for j in range(1, 5)},
                 index=pd.Index(picked, name="gene")).to_csv(d / "counts.tsv", sep="\t")

    jdir = d / "jaspar"
    jdir.mkdir(exist_ok=True)
    for i, name in enumerate(rng.choice(tfs[:-2], 60, replace=False)):
        name = f"{name}::TF{i}" if i % 11 == 0 else str(name)  # heterodimers are skipped
        counts = rng.integers(0, 40, size=(4, int(rng.integers(6, 15))))
        (jdir / f"MA{i:04d}.1.jaspar").write_text(f">MA{i:04d}.1 {name}\n" + "".join(
            f"{b} [ {' '.join(map(str, row))} ]\n" for b, row in zip("ACGT", counts)))
    hoco = []
    for i, name in enumerate(rng.choice(tfs[:-2], 40, replace=False)):
        counts = rng.integers(0, 40, size=(4, 8))
        hoco.append(f">H{i} {str(name).upper()}_HUMAN.H11MO.0.A\n" + "".join(
            f"{b} [ {' '.join(map(str, row))} ]\n" for b, row in zip("ACGT", counts)))
    (d / "hocomoco.jaspar").write_text("".join(hoco))
    pd.DataFrame({"Approved symbol": sorted({t.upper() for t in rng.choice(tfs, 90, replace=False)})}).to_csv(
        d / "lambert.csv")
    pd.DataFrame({"assay": tfs, "Match type": "Approved symbol", "Approved symbol": [t.upper() for t in tfs]}
                 ).set_index("assay").to_csv(d / "hgnc_mapping.csv")

    sizes = rng.multinomial(n_marks - 10 * ANALYSIS_EMB_GROUPS, [1 / ANALYSIS_EMB_GROUPS] * ANALYSIS_EMB_GROUPS) + 10
    planted = np.repeat(np.arange(ANALYSIS_EMB_GROUPS), sizes)
    centers = rng.normal(0, 10.0, size=(ANALYSIS_EMB_GROUPS, ANALYSIS_EMB_DIM))
    np.save(d / "embedding.npy", centers[planted] + rng.normal(0, 0.5, size=(n_marks, ANALYSIS_EMB_DIM)))
    return {"dir": d, "planted": planted, "contrib_rows": len(contribs)}


def _analysis_cli(argv: list, what: str, walls: dict, card: str) -> None:
    """One subcommand through ``cli.analysis.main`` in process, timed; it
    must exit 0."""
    from expecto_tpu_torch.cli.analysis import main as analysis_main

    t0 = time.perf_counter()
    rc = analysis_main([str(a) for a in argv])
    walls[what] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.analysis {what} exited {rc}")
    log(f"analysis: {what} {walls[what]:.3f} s [{card}]")


def _check_bootstrap(d: Path, out: Path, boot_dir: Path) -> dict:
    """se_weight.npy against np.std(ddof=1) over the trainer's models as
    loaded, and every z-score row against its own feature's (weight index
    coeff_idx * marks + mark); the reference's positional assignment must
    fail that check."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.io.xgb import load_expression_model

    weights = np.vstack([load_expression_model(boot_dir / f"bootstrap_seed{j}.save").weight
                         for j in range(TRAIN_BOOT_SEEDS)])
    se = np.std(weights, axis=0, ddof=1)
    got = np.load(out / "se_weight.npy")
    if got.shape != (TRAIN_FEATURES,) or not np.array_equal(got, se):
        raise AssertionError("bootstrap-coefficients: se_weight.npy is not np.std(ddof=1) of the 128 models")
    z = load_expression_model(d / "main.save").weight / se
    n_marks = TRAIN_FEATURES // 10
    table = pd.read_csv(out / "input_features_sorted_by_zscore.csv", sep="\t", index_col=0,
                        float_precision="round_trip")
    want = z[table["coeff_idx"].to_numpy() * n_marks + table["mark"].to_numpy()]
    # z is float32; the table holds each value's shortest float32 text
    if len(table) != TRAIN_FEATURES or not np.array_equal(table["z_score"].to_numpy(np.float32), want,
                                                          equal_nan=True):
        raise AssertionError("bootstrap-coefficients: a row's z_score is not its own feature's")
    absz = np.abs(table["z_score"].to_numpy())
    if not (absz[:-1] >= absz[1:]).all():
        raise AssertionError("bootstrap-coefficients: rows not sorted by |z|")
    rows = pd.read_csv(d / "all_feature_clusters.tsv", sep="\t", index_col=0)
    positional = z  # the reference: basis-major z assigned to mark-major rows in order
    wrong = int((positional != z[rows["coeff_idx"].to_numpy() * n_marks + rows["mark"].to_numpy()]).sum())
    if wrong == 0:
        raise AssertionError("the planted positional z-score assignment passed the per-feature check")
    return {"models": TRAIN_BOOT_SEEDS, "features": TRAIN_FEATURES, "se_max": float(se.max()),
            "max_abs_z": float(absz[0]), "positional_fault_rows_wrong": wrong}


def _log_odds(probs, nsites: float, bg):
    """MEME's pseudocount-smoothed log2 odds (pseudo 0.1), written out here
    to check the scanner's scores."""
    import numpy as np

    return np.log2(((probs * nsites + 0.1 * bg) / (nsites + 0.1)) / bg)


def _check_fimo_query(out: Path, d: Path) -> dict:
    """Every query record is the +-30-bp genome window around its variant;
    every printed window's matched_sequence is the slice of its record at
    start/stop (reverse complemented on '-'), its score the log-odds sum of
    that sequence within the text's 4 significant digits, its p-value in
    (0, 1]; the rows are every window without an N over motifs, records and
    strands, less the windows at a motif's lowest score where the scanner's
    float survival function reads above 1 (the scanner leaves those out)."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.analysis.motif_scan import log_odds, parse_meme, pvalue_lookup
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.pipeline.consensus import parse_fasta

    genome = FastaIndex(WORK / "genome.fa")
    records = dict(parse_fasta(out / "fimo_in.fasta"))
    pad = ANALYSIS_BP_PAD
    for line in (d / "subs.vcf").read_text().splitlines():
        chrom, pos, rid, ref = line.split("\t")[:4]
        seq = records[rid]
        if len(seq) != 2 * pad + 1 or seq[pad] != ref or seq != genome.sequence(chrom, int(pos) - pad, int(pos) + pad):
            raise AssertionError(f"fimo-query: record {rid} is not the +-{pad}-bp genome window around its variant")
    lut = np.full(256, -1, dtype=np.int64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    comp = str.maketrans("ACGT", "TGCA")
    strands = [lut[np.frombuffer(s.upper().encode(), np.uint8)] for seq in records.values()
               for s in (seq, seq.upper().translate(comp)[::-1])]
    motifs, bg = parse_meme(str(d / "motifs.meme"))
    df = pd.read_csv(out / "fimo_out.txt", sep="\t", keep_default_na=False, dtype={"q-value": str})
    want_rows, left_out = 0, 0
    for m in motifs:
        q, lookup = pvalue_lookup(log_odds(m, bg), bg)
        drop_lowest = lookup(np.array([q.min(axis=1).sum()]))[0] > 1.0
        for codes in strands:
            wins = np.lib.stride_tricks.sliding_window_view(codes, m.width)
            clean = wins[(wins >= 0).all(axis=1)]
            lowest = int((q[np.arange(m.width), clean] == q.min(axis=1)).all(axis=1).sum()) if drop_lowest else 0
            want_rows += len(clean) - lowest
            left_out += lowest
        sub = df[df["motif_id"] == m.motif_id]
        pieces = [records[r][a - 1 : b].upper() for r, a, b in zip(sub["sequence_name"], sub["start"], sub["stop"])]
        pieces = [x if s == "+" else x.translate(comp)[::-1] for x, s in zip(pieces, sub["strand"])]
        if pieces != list(sub["matched_sequence"]):
            raise AssertionError(f"fimo-query: {m.motif_id}: a matched_sequence is not its record's slice")
        codes = lut[np.frombuffer("".join(pieces).encode(), np.uint8)].reshape(len(sub), m.width)
        scores = _log_odds(m.probs, m.nsites, bg)[np.arange(m.width), codes].sum(axis=1)
        step = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(scores), 1e-300))) - 3)
        if (np.abs(sub["score"].to_numpy(np.float64) - scores) > 0.5 * step * (1 + 1e-9) + 1e-12).any():
            raise AssertionError(f"fimo-query: {m.motif_id}: a score is not its log-odds sum to 4 digits")
    p = df["p-value"].to_numpy(np.float64)
    if not ((p > 0) & (p <= 1)).all():
        raise AssertionError("fimo-query: a p-value outside (0, 1]")
    if len(df) != want_rows:
        raise AssertionError(f"fimo-query: {len(df)} rows, expected {want_rows} windows without N")
    filtered = pd.read_csv(out / "fimo_filtered.tsv", sep="\t", index_col=0)
    return {"records": len(records), "motifs": len(motifs), "rows": len(df),
            "lowest_score_windows_left_out": left_out, "filtered_rows": len(filtered)}


def _check_enrichment(out: Path, sed_column: str) -> dict:
    """Every hypergeom*.tsv has one row a rank cutoff (20 clusters less 5
    negatives) of finite p-values in [0, 1], the four percentile tables
    among them."""
    import numpy as np
    import pandas as pd

    tables = sorted(p.name for p in out.glob("hypergeom*.tsv"))
    want = {"hypergeom.tsv", "hypergeom_shuffled_clusters.tsv", "hypergeom_shuffled_variants.tsv",
            *(f"hypergeom_percentile_{p}_{p + 25}.tsv" for p in (0, 25, 50, 75))}
    if set(tables) != want:
        raise AssertionError(f"fimo-enrich ({sed_column}): tables {tables}, expected {sorted(want)}")
    res = {}
    for name in tables:
        df = pd.read_csv(out / name, sep="\t")
        pv = df["hypergeom_pval"].to_numpy(np.float64)
        if list(df["top_cluster_idx"]) != list(range(ENTRY_CLUSTERS - ANALYSIS_NEG_CLUSTERS)) or not (
                np.isfinite(pv).all() and ((pv >= 0) & (pv <= 1)).all()):
            raise AssertionError(f"fimo-enrich ({sed_column}) {name}: rows or p-values out of range")
        res[name] = float(pv.min())
    return res


def _check_rank_int(stoch: Path, det: Path) -> dict:
    """--deterministic: per gene, norm.ppf of the Blom average ranks; the
    stochastic mode: per gene, the sorted values are norm.ppf of ranks 1..n
    (ties broken at random)."""
    import numpy as np
    import pandas as pd
    from scipy.stats import norm, rankdata

    c = 3.0 / 8
    for path, average in ((det, True), (stoch, False)):
        df = pd.read_csv(path, sep="\t", float_precision="round_trip")
        for _gene, g in df.groupby("gene"):
            sed, got = g["SED"].to_numpy(), g["SED_RINT"].to_numpy()
            n = len(sed)
            if average:
                want = norm.ppf((rankdata(sed, method="average") - c) / (n - 2 * c + 1))
                if not np.array_equal(got, want):
                    raise AssertionError("rank-int --deterministic differs from norm.ppf of the Blom average ranks")
            else:
                want = norm.ppf((np.arange(1, n + 1) - c) / (n - 2 * c + 1))
                order = np.argsort(sed, kind="stable")
                rises = np.diff(sed[order]) > 0
                if not np.array_equal(np.sort(got), want) or not (np.diff(got[order])[rises] > 0).all():
                    raise AssertionError("rank-int: a gene's values are not norm.ppf of its SED ranks 1..n")
    return {"rows": len(df), "genes": int(df["gene"].nunique())}


def _check_collect(out: Path, d: Path, lambert: bool) -> dict:
    """The written JASPAR file holds exactly the motifs of the TF assays the
    features table names (with Lambert/HGNC: mapped, Pol marks and non-TF
    marks dropped, and kept where the Lambert list holds the symbol):
    single-TF JASPAR files and HOCOMOCO motifs by the name before '_'."""
    import pandas as pd

    from expecto_tpu_torch.analysis.pwm import parse_jaspar

    feats = pd.read_csv(d / "features.tsv", sep="\t", index_col=0)
    tf = feats[feats["Assay type"] == "TF"]["Assay"]
    if lambert:
        listed = set(pd.read_csv(d / "lambert.csv", index_col=0)["Approved symbol"])
        included = {a.upper() for a in tf if not a.startswith("Pol") and a.upper() in listed}
    else:
        included = {a.upper() for a in tf}
    want = []
    for f in sorted((d / "jaspar").glob("*.jaspar")):
        head = f.read_text().splitlines()[0][1:].split(None, 1)
        if "::" not in head[1] and head[1].upper() in included:
            want.append(head[0])
    want += [m.matrix_id for m in parse_jaspar((d / "hocomoco.jaspar").read_text())
             if m.name.split("_")[0].upper() in included]
    got = [m.matrix_id for m in parse_jaspar((out / "cluster_motifs.jaspar").read_text())]
    if sorted(got) != sorted(want) or not got:
        raise AssertionError(f"collect-pwms (lambert={lambert}): motifs {sorted(got)} != {sorted(want)}")
    return {"motifs": len(got), "tf_symbols": len(included)}


def analysis_phase(report: dict, card: str, seed: int, main_model) -> None:
    """The analysis toolkit (``python -m expecto_tpu_torch.cli.analysis``,
    each subcommand's ``main`` in process under build/chip_smoke/analysis)
    over the card's own outputs: the training phase's 128 bootstrap
    ``.save`` files and K = 1 model, the phase inputs' genome and VCF, the
    entry-and-exit phase's cluster tables and sed.tsv, the training genes.
    The subcommands of ANALYSIS_ON_CARD run, fixed, each wall logged with
    the card; ANALYSIS_CPU_ONLY need packages this machine lacks. No kernel
    may launch in the phase."""
    import numpy as np
    import pandas as pd

    from expecto_tpu_torch.ops import conv0, conv8, gblinear_block, gblinear_cd, gblinear_round

    log("analysis: subcommands run here: " + "; ".join(ANALYSIS_ON_CARD))
    log("analysis: proven by the CPU tests only (the packages this machine lacks): "
        + "; ".join(f"{k} ({v})" for k, v in ANALYSIS_CPU_ONLY.items()))
    for mod in (conv8, conv0, gblinear_block, gblinear_cd, gblinear_round):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    inp = make_analysis_inputs(seed, main_model)
    d, walls, out = inp["dir"], {}, {"inputs_s": time.perf_counter() - t0}
    boot_dir = WORK / "train" / "boot"

    o = d / "bootstrap"
    _analysis_cli(["bootstrap-coefficients", "--bootstrap_model_dir", boot_dir, "--pattern", "bootstrap_seed*.save",
                   "--main_model", d / "main.save", "--input_features_file", d / "all_feature_clusters.tsv",
                   "--no_plots", "-o", o], "bootstrap-coefficients --no_plots", walls, card)
    out["bootstrap"] = _check_bootstrap(d, o, boot_dir)
    log(f"analysis: bootstrap SEs of {TRAIN_BOOT_SEEDS} card-trained models equal np.std(ddof=1); every z-score row "
        f"its own feature's; the positional assignment puts {out['bootstrap']['positional_fault_rows_wrong']} of "
        f"{TRAIN_FEATURES} rows wrong (caught)")

    o = d / "fimo_query"
    _analysis_cli(["fimo-query", "--vcf_file", d / "subs.vcf", "--motif_file", d / "motifs.meme", "--hg19_fasta",
                   WORK / "genome.fa", "--fimo_engine", "builtin", "-o", o], "fimo-query --fimo_engine builtin",
                  walls, card)
    out["fimo_query"] = _check_fimo_query(o, d)
    log(f"analysis: fimo-query {out['fimo_query']}: windows, scores and p-values checked")

    # fimo-enrich reads a FIMO table without a header row or with MEME 4.x's
    # '#'-commented one (both packages); the scanner writes MEME 5's plain
    # header, so it is commented here
    header, rows = (o / "fimo_out.txt").read_text().split("\n", 1)
    (d / "fimo_out_meme4.txt").write_text(f"#{header}\n{rows}")
    for rank_int in (False, True):
        o = d / ("fimo_enrich_rint" if rank_int else "fimo_enrich")
        what = "fimo-enrich --no_plots" + (" --rank_int" if rank_int else "")
        _analysis_cli(["fimo-enrich", "--cluster_contribs_file", d / "contribs.tsv", "--rsat_clusters_file",
                       d / "rsat_motifs.tsv", "--fimo_out_file", d / "fimo_out_meme4.txt",
                       "--n_neg_clusters", ANALYSIS_NEG_CLUSTERS, "--no_plots", *(["--rank_int"] if rank_int else []),
                       "-o", o], what, walls, card)
        out[what] = _check_enrichment(o, "SED_RINT" if rank_int else "SED_PROPORTION")
    log(f"analysis: fimo-enrich on the entry phase's RSAT table ({inp['contrib_rows']} rows, {ENTRY_CLUSTERS} "
        f"clusters): 7 tables of {ENTRY_CLUSTERS - ANALYSIS_NEG_CLUSTERS} finite p-values in [0, 1] each, with and "
        "without --rank_int")

    o = d / "enriched"
    _analysis_cli(["enriched-motifs", "--hypergeom_enrichment_tsv", d / "enrichment.tsv", "--motif_db_file",
                   d / "motifs.meme", "-o", o], "enriched-motifs", walls, card)
    q = pd.read_csv(d / "enrichment.tsv", sep="\t", index_col=0)["hypergeom_qval"]
    got = {ln.split()[1] for ln in (o / "enriched_motifs.meme").read_text().splitlines() if ln.startswith("MOTIF")}
    if got != set(q.index[q < ANALYSIS_QVAL]):
        raise AssertionError(f"enriched-motifs: {sorted(got)} are not the motifs under q {ANALYSIS_QVAL}")
    out["enriched_motifs"] = len(got)

    sed_tsv = WORK / "entry" / "clusters_labels" / "sed.tsv"
    for det in (False, True):
        what = "rank-int --group_by gene" + (" --deterministic" if det else "")
        _analysis_cli(["rank-int", sed_tsv, "--column", "SED", "--group_by", "gene",
                       *(["--deterministic"] if det else []), "-o", d / f"rank_int_{'det' if det else 'stoch'}.tsv"],
                      what, walls, card)
    out["rank_int"] = _check_rank_int(d / "rank_int_stoch.tsv", d / "rank_int_det.tsv")

    o = d / "profile.csv"
    _analysis_cli(["make-profile", "--annoFile", WORK / "train" / "geneanno.csv", "--countsFile", d / "counts.tsv",
                   "--rank_match_col", "t1", "-o", o], "make-profile --rank_match_col", walls, card)
    prof = pd.read_csv(o, index_col=0, float_precision="round_trip")
    ref = np.sort(prof["t1"].dropna().to_numpy())
    if len(prof) != TRAIN_GENES or any(not np.array_equal(np.sort(prof[c].dropna().to_numpy()), ref)
                                       for c in prof.columns):
        raise AssertionError("make-profile: a column's sorted values are not the reference column's")
    out["make_profile"] = {"genes": len(prof), "matched_genes": len(ref), "columns": list(prof.columns)}

    for lambert in (True, False):
        o = d / ("pwms_lambert" if lambert else "pwms")
        extra = ["--lambert_hgnc", d / "lambert.csv", "--hgnc_mapping", d / "hgnc_mapping.csv"] if lambert else []
        _analysis_cli(["collect-pwms", "--belugaFeatures", d / "features.tsv", "--jaspar_motif_db", d / "jaspar",
                       "--hocomoco_jaspar_motif_file", d / "hocomoco.jaspar", *extra, "--out_dir", o],
                      "collect-pwms" + (" (Lambert/HGNC)" if lambert else ""), walls, card)
        out[f"collect_pwms{'_lambert' if lambert else ''}"] = _check_collect(o, d, lambert)

    o = d / "louvain"
    _analysis_cli(["cluster-viz", d / "embedding.npy", "--method", "louvain", "--out_dir", o],
                  "cluster-viz --method louvain", walls, card)
    labels = pd.read_csv(o / "clusters.tsv", sep="\t", index_col=0)["cluster"].to_numpy()
    pairs = set(zip(inp["planted"], labels))
    if len(pairs) != ANALYSIS_EMB_GROUPS or len(set(labels)) != ANALYSIS_EMB_GROUPS:
        raise AssertionError(f"cluster-viz --method louvain: {len(set(labels))} clusters do not recover the "
                             f"{ANALYSIS_EMB_GROUPS} planted groups")
    out["louvain_clusters"] = int(len(set(labels)))

    launches = {"conv8_relu": conv8.conv8_relu.launches, "conv0_codes": conv0.conv0_codes_relu.launches,
                "gblinear_cd": gblinear_cd.coord_update.launches,
                "gblinear_round": gblinear_round.gblinear_round.launches,
                "gblinear_block_grad": gblinear_block.grad_update.launches,
                "gblinear_block_resid": gblinear_block.residual_update.launches}
    if any(launches.values()):
        raise AssertionError(f"a kernel launched in the analysis phase: {launches}")
    out.update(walls_s=walls, launches=launches, on_card=list(ANALYSIS_ON_CARD), cpu_only=ANALYSIS_CPU_ONLY)
    report["analysis"] = out
    log(f"analysis: no kernel launched in the phase {launches}; {len(walls)} subcommand runs, "
        f"{sum(walls.values()):.1f} s of CLI walls [{card}]")


def gblinear_cd_entry(train: dict, mp_train: dict) -> dict:
    """The kernel line's entry of the coordinate-update kernel: its time on
    the card, its plain version's and its bound at the all-tissue call's
    shape (512, 218); the times a call back to back (``call_ms``); the same
    at K = 1 (the shape of the per-block loop that the round kernel
    replaced, now the plain round's), 128, 256 (the bench's round) and
    1,000. Since the block step's kernels, the one-process K-model calls
    launch it no more: ``launches`` are the 2-rank bootstrap run's (the
    split route's planes entry, a block a round on each rank)."""
    cd = {r["K"]: r for r in train["cd_layers"]}
    per_rank = [r["gblinear_cd"] for r in mp_train["sound"]["ranks"]]
    return {
        "name": "gblinear_cd", "route": "cuda", "source": "expecto_tpu_torch/csrc/gblinear_cd.cu",
        "replaces": "expecto_tpu/models/gblinear.py:92",
        "replaces_what": "_coord_delta with the eta scale and weight update of the block steps (:125-127, "
                         ":249-251): an XLA fusion, no pallas_call",
        "launches": sum(per_rank), "max_abs_err": max(r["max_abs_err"] for r in cd.values()),
        "ms": cd[218]["ms"], "plain_ms": cd[218]["plain_ms"], "bound_ms": cd[218]["bound_ms"],
        "bound_by": cd[218]["bound_by"], "library_ms": None, "shape": [cd[218]["B"], 218],
        "call_ms": cd[218]["call_ms"], "plain_call_ms": cd[218]["plain_call_ms"],
        **{f"{key}_k{k}": cd[k][key] for k in (1, 128, 256, 1000) for key in ("ms", "plain_ms", "bound_ms", "call_ms")},
        "launches_k1": train["k1"]["launches_gblinear_cd"], "launches_k218": train["k218"]["launches_gblinear_cd"],
        "launches_bootstrap_k128": train["boot"]["launches_gblinear_cd"],
        "launches_bootstrap_k128_per_rank_of_2": per_rank,
    }


def gblinear_block_entries(train: dict, mp_train: dict) -> list:
    """The kernel line's entries of the block step's two kernels: time a
    block, the plain version's and the bound at the all-tissue call's shape
    (K = 218), whose timed run gives ``launches``; the same at every K of
    TRAIN_BLOCK_SHAPES; the torch block step they replaced (``yardstick``)
    beside each; the 2-rank bootstrap run's launches a rank (the gradient
    kernel on the split route). No single PyTorch call computes G with the
    coordinate update; ``torch.addmm`` computes the residual's."""
    rows = {r["K"]: r for r in train["block_layers"]}
    ranks = mp_train["sound"]["ranks"]
    out = []
    for name, key, library in (("gblinear_block_grad", "grad", None), ("gblinear_block_resid", "resid", "library_ms")):
        r218 = rows[218]
        out.append({
            "name": name, "route": "cuda", "source": f"expecto_tpu_torch/csrc/{name}.cu",
            "replaces": "expecto_tpu/models/gblinear.py:246",
            "replaces_what": "_multi_round_body's block_step (:246-251), "
                             + ("jnp.dot(Xb, row_w * r) and _coord_delta with the eta scale and weight update"
                                if key == "grad" else "r + jnp.dot(Xb.T, dw)") + ": XLA, no pallas_call",
            "launches": train["k218"]["launches"],
            "max_abs_err": r218["max_abs_err" if key == "grad" else "inc_max_abs_err"],
            "ms": r218[f"{key}_ms"], "plain_ms": r218[f"{key}_plain_ms"], "bound_ms": r218[f"{key}_bound"]["bound_ms"],
            "bound_by": r218[f"{key}_bound"]["bound_by"], "library_ms": r218[library] if library else None,
            "shape": [r218["B"], r218["n"], 218], "block_ms": r218["ms"], "block_yardstick_ms": r218["yardstick_ms"],
            "block_bound_ms": r218["block_bound"]["bound_ms"],
            **{f"{field}_k{k}": rows[k][src] for k in rows
               for field, src in (("ms", f"{key}_ms"), ("plain_ms", f"{key}_plain_ms"), ("block_ms", "ms"),
                                  ("yardstick_ms", "yardstick_ms"))},
            **{f"bound_ms_k{k}": rows[k][f"{key}_bound"]["bound_ms"] for k in rows},
            "rel_err_vs_float64": max(rows[k]["g_rel" if key == "grad" else "inc_rel"] for k in rows),
            "launches_bootstrap_k128": train["boot"]["launches"],
            "launches_bootstrap_k128_per_rank_of_2": [r[name] for r in ranks],
        })
    return out


def gblinear_round_entry(train: dict) -> dict:
    """The kernel line's entry of the round kernel: its time a round at the
    published shape beside its bound, the plain round's (the per-block
    loop) and a CUDA-graph replay of the plain round (``graph_ms``, a
    yardstick); ``launches`` from the one-tissue call's timed run, and the
    card's time for the kernel a round inside that call (profiled) and the
    SASS's local loads and stores. No single PyTorch call computes a round."""
    row, k1 = train["round"], train["k1"]
    return {
        "name": "gblinear_round", "route": "cuda", "source": "expecto_tpu_torch/csrc/gblinear_round.cu",
        "replaces": "expecto_tpu/models/gblinear.py:104",
        "replaces_what": "_round_body's one_round (:104-132, jitted at :169): the XLA program of one round of the "
                         "K = 1 sweep, no pallas_call",
        "launches": k1["launches"], "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None, "graph_ms": row["graph_ms"],
        "shape": [row["n_blocks"], row["B"], row["n"]], "r_max_abs_err": row["r_max_abs_err"],
        "in_call_ms": k1["round_kernel_ms"], "gaps_vs_plain_round": row["gaps_vs_plain"],
        "gaps_k1_call_vs_plain": k1["gaps_vs_plain"], "sass_local": row["sass_local"],
        "train_rmse_from_r_vs_product": k1["train_rmse_from_r_vs_product"],
    }


def _torchrun(target: list[str], what: str) -> tuple[float, str]:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    MP_RANKS <target>`` on this machine: its wall time and the ranks' stderr.
    Raises if it fails; on its time limit the launcher and every rank are
    killed (their own process group)."""
    import os
    import signal

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])),
           "OMP_NUM_THREADS": str(MP_OMP_THREADS)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(MP_RANKS), *target]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=MP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: torchrun exited {proc.returncode}\n{out[-3000:]}\n{err[-6000:]}")
    return wall, err


def _backend(err: str, what: str) -> str:
    """The backend every rank printed when it joined the group."""
    import re

    found = re.findall(r"torch\.distributed: rank (\d+) of (\d+), backend (\w+)", err)
    if sorted(int(r) for r, _w, _b in found) != list(range(MP_RANKS)) or len({b for *_x, b in found}) != 1:
        raise AssertionError(f"{what}: the ranks did not each join one group: {found}")
    return found[0][2]


def _no_leftovers(d: Path, what: str) -> None:
    left = [p.name for p in d.iterdir() if "shard" in p.name or "exchange" in p.name]
    if left:
        raise AssertionError(f"{what}: shard or exchange files left behind: {left}")


def _group(module: str, argv: list[str], what: str, *, identity_all_reduce: bool = False) -> dict:
    """``-m module argv`` as a 2-rank torchrun group, each rank under
    :func:`rank_worker`: its wall, backend and each rank's counts (checked:
    exit code 0)."""
    stats = WORK / "multiprocess" / f"stats_{what.replace(' ', '_')}"
    wall, err = _torchrun([str(REPO / "chip_smoke.py"), "--rank-worker", str(stats),
                           *(["--identity-all-reduce"] if identity_all_reduce else []), "--", "-m", module, *argv],
                          what)
    ranks = [json.loads(Path(f"{stats}.rank{r}.json").read_text()) for r in range(MP_RANKS)]
    if any(r["rc"] != 0 for r in ranks):
        raise AssertionError(f"{what}: a rank exited non-zero: {ranks}")
    return {"wall_2_s": wall, "backend": _backend(err, what), "ranks": ranks}


def _rank_routes(ranks: list, dtype: str, what: str) -> None:
    """Every rank ran its convs on the kernels of ``dtype``'s routes: conv1-
    conv5 on the tf32x3 kernel (fp32) or the tc kernel (bf16) alone, conv1 and
    conv3 pooled in the epilogue (two pooled launches a conv0, no standalone
    pool), conv0 on the code-gather kernel in ``dtype``, and fc1 on
    ``dtype``'s fc1 kernels alone, each shape on its route; a rank's fc1
    shapes join FC1_SHAPES."""
    route = CONV_ROUTE[dtype]
    for r in ranks:
        by, pooled = r["conv8_relu_by_route"], r["conv8_relu_pool4_by_route"]
        if not (_on_conv_route(by, dtype) and r["conv0_codes"] > 0 and r["pool4_standalone"] == 0
                and pooled == {p: 2 * r["conv0_codes"] * (p == route) for p in pooled}
                and r["conv0_codes_by_kind"] == {dtype: r["conv0_codes"]}
                and r["fc1_strided"] > 0
                and _fc1_on_routes(dtype, r["fc1_strided_by_route"],
                                   {tuple(shape): n for shape, n in r["fc1_strided_by_shape"]}, r["fc1_split_tf32"])):
            raise AssertionError(f"{what} rank {r['rank']}: convs or fc1 not on the {dtype} kernels: {r}")
        FC1_SHAPES.update({tuple(shape): n for shape, n in r["fc1_strided_by_shape"]})


def _launches(ranks: list) -> list:
    return [{"conv8_relu": r["conv8_relu_by_route"], "conv0_codes": r["conv0_codes"], "fc1_strided": r["fc1_strided"],
             "fc1_strided_by_route": r["fc1_strided_by_route"], "gblinear_cd": r["gblinear_cd"],
             "gblinear_round": r["gblinear_round"], "gblinear_block_grad": r["gblinear_block_grad"],
             "gblinear_block_resid": r["gblinear_block_resid"]}
            for r in ranks]


def _serve_gaps(got, want) -> dict:
    """REF/ALT/SED of two score CLI outputs: {name: max |got - want|}."""
    import numpy as np

    return {k: float(np.abs(g - w).max()) for k, g, w in zip(("REF", "ALT", "SED"), got, want)}


def _serve_check(got_df, want_df, what: str) -> dict:
    """The rows of ``got_df`` are ``want_df``'s, in order (every non-float
    column equal); REF/ALT within rtol PARITY_RTOL and SED within rtol 0,
    both with an absolute limit of 1e-5 of max|REF|: REF, ALT and their
    difference SED carry the summation-order noise of the same 20,020-term
    fp32 products, at the scale of |REF| (tests/torch_port_common.sed_atol).
    Returns the gaps, and how many elements pass only by that scaling
    (beyond PARITY_ATOL)."""
    import numpy as np

    names = [f"Tissue{j:03d}" for j in range(N_MODELS)]
    ids = [c for c in want_df.columns if want_df[c].dtype.kind != "f"]
    if list(got_df.columns) != list(want_df.columns) or not got_df[ids].equals(want_df[ids]):
        raise AssertionError(f"{what}: other rows, or rows in another order, than one rank's")
    got = [got_df[[f"{p}{m}" for m in names]].to_numpy(np.float64) for p in ("REF_", "ALT_", "")]
    want = [want_df[[f"{p}{m}" for m in names]].to_numpy(np.float64) for p in ("REF_", "ALT_", "")]
    atol = 1e-5 * max(1.0, float(np.abs(want[0]).max()))
    beyond = 0
    for name, g, w in zip(("REF", "ALT", "SED"), got, want):
        rtol = PARITY_RTOL if name != "SED" else 0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what}: {name}")
        if name != "SED":
            beyond += int((np.abs(g - w) > PARITY_ATOL + rtol * np.abs(w)).sum())
    return {**_serve_gaps(got, want), "atol": atol, "ref_alt_beyond_parity_atol": beyond, "elements": got[0].size}


def _bf16_serve_gap(got_df, want_df) -> float:
    """max |bf16 - fp32| of REF, ALT and SED over max|fp32 REF|, rows paired
    by position."""
    import numpy as np

    names = [f"Tissue{j:03d}" for j in range(N_MODELS)]
    got = np.stack([got_df[[f"{p}{m}" for m in names]].to_numpy(np.float64) for p in ("REF_", "ALT_", "")])
    want = np.stack([want_df[[f"{p}{m}" for m in names]].to_numpy(np.float64) for p in ("REF_", "ALT_", "")])
    return float(np.abs(got - want).max() / np.abs(want[0]).max())


def multiprocess_phase(report: dict, inputs: dict, card: str) -> None:
    """The port's multi-process runs: each flow's CLI as a 2-rank torchrun
    group on this card, against the same call at one rank (the earlier
    phases' outputs where they are the same call), with two planted faults;
    the backend, walls and the training collectives printed."""
    import numpy as np
    import pandas as pd
    import torch

    from expecto_tpu_torch.cli.score import main as score_main
    from expecto_tpu_torch.io.xgb import load_expression_model
    from expecto_tpu_torch.parallel import dist

    torch.cuda.empty_cache()
    out = {"ranks": MP_RANKS, "cards": torch.cuda.device_count()}
    backends = set()
    mp = WORK / "multiprocess"
    mp.mkdir(exist_ok=True)

    # serving, fp32: the fp32 serve phase's rows, one rank in this process, then two
    vcf, genes, n_rows = subset(inputs, range(N_FP32_SERVE), "fp32_serve")
    one, two = mp / "score_fp32_1", mp / "score_fp32_2"
    for d in (one, two):
        d.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    if score_main(score_args(vcf, genes, "--fp32", "--output", str(one / "output.csv"))) != 0:
        raise AssertionError("score CLI --fp32 at one rank failed")
    wall1 = time.perf_counter() - t0
    run = _group("expecto_tpu_torch.cli.score", score_args(vcf, genes, "--fp32", "--output", str(two / "output.csv")),
                 "score fp32")
    _rank_routes(run["ranks"], "float32", "score --fp32")
    backends.add(run["backend"])
    wall2 = run["wall_2_s"]
    want, got = check_output(one / "output.csv", n_rows)[0], check_output(two / "output.csv", n_rows)[0]
    gaps = _serve_check(got, want, "score --fp32 at 2 ranks")
    _no_leftovers(two, "score --fp32")
    # the merge fault: the ranks' blocks assembled in reverse rank order
    blocks = [dist.host_row_range(n_rows, r, MP_RANKS) for r in range(MP_RANKS)]
    names = [f"{p}Tissue{j:03d}" for p in ("REF_", "ALT_", "") for j in range(N_MODELS)]
    vals = got[names].to_numpy()
    starts = np.cumsum([0] + [hi - lo for lo, hi in blocks[::-1]])[:-1]
    swapped = got.copy()
    swapped[names] = dist.assemble_rows([(int(s), vals[lo:hi]) for s, (lo, hi) in zip(starts, blocks[::-1])], n_rows)
    try:
        _serve_check(swapped, want, "reverse rank order")
    except AssertionError:
        pass
    else:
        raise AssertionError("the serving blocks in reverse rank order pass the row check")
    names = [f"Tissue{j:03d}" for j in range(N_MODELS)]
    reverse = _serve_gaps(*[[d[[f"{p}{m}" for m in names]].to_numpy(np.float64) for p in ("REF_", "ALT_", "")]
                            for d in (swapped, want)])
    out["score_fp32"] = {"rows": n_rows, "wall_1_s": wall1, "wall_2_s": wall2, "max_abs_err": gaps,
                         "reverse_rank_order_max_abs_err": reverse, "launches_per_rank": _launches(run["ranks"])}
    log(f"multi-process score --fp32 ({n_rows} rows x {N_MODELS} models): 1 rank {wall1:.3f} s (in process, "
        f"weights loaded), 2 ranks {wall2:.3f} s (torchrun, process start included; CLI per rank " + ", ".join(
            f"{r['main_s']:.3f}" for r in run["ranks"]) + f" s); REF/ALT/SED gaps {gaps}; same rows in the same "
        f"order, no exchange files; the blocks in reverse rank order fail the check ({reverse}); launches per rank "
        f"{_launches(run['ranks'])} [{card}]")

    # serving, bf16 (the CLI's default) on every row
    two = mp / "score_bf16_2"
    two.mkdir(exist_ok=True)
    run = _group("expecto_tpu_torch.cli.score", score_args(WORK / "variants.vcf", WORK / "genes.tsv", "--output",
                                                           str(two / "output.csv")), "score bf16")
    _rank_routes(run["ranks"], "bfloat16", "score bf16")
    backends.add(run["backend"])
    wall2 = run["wall_2_s"]
    got = check_output(two / "output.csv", inputs["n_rows"])[0]
    want16 = check_output(WORK / "output.csv", inputs["n_rows"])[0]
    ids = [c for c in want16.columns if want16[c].dtype.kind != "f"]
    if not got[ids].equals(want16[ids]):
        raise AssertionError("score bf16 at 2 ranks: other rows, or rows in another order, than one rank's")
    _no_leftovers(two, "score bf16")
    # bf16 vs fp32 on the fp32 rows (one rank each), and 2 ranks vs 1 in bf16
    bf16_rows = want16.iloc[:n_rows].reset_index(drop=True)
    if not bf16_rows[ids].equals(want[ids]):
        raise AssertionError("the fp32 serve rows are not the first rows of the main path's output")
    gap = {"bf16_vs_fp32_1rank": _bf16_serve_gap(bf16_rows, want), "ranks_2_vs_1": _bf16_serve_gap(got, want16),
           "rows_shifted": _bf16_serve_gap(got.iloc[np.roll(np.arange(len(got)), 1)].reset_index(drop=True), want16)}
    out["score_bf16"] = {"rows": inputs["n_rows"], "wall_1_s": report["main_path"]["cli_wall_s"], "wall_2_s": wall2,
                         "limit": SERVE_BF16_GAP, **gap, "launches_per_rank": _launches(run["ranks"])}
    log(f"multi-process score bf16 ({inputs['n_rows']} rows): 1 rank {report['main_path']['cli_wall_s']:.3f} s (main "
        f"path, in process), 2 ranks {wall2:.3f} s (torchrun; CLI per rank " + ", ".join(
            f"{r['main_s']:.3f}" for r in run["ranks"]) + f" s); over max|REF|: 2 ranks vs 1 {gap['ranks_2_vs_1']:.4g}, "
        f"bf16 vs fp32 at 1 rank {gap['bf16_vs_fp32_1rank']:.4g}, rows shifted by one {gap['rows_shifted']:.4g} "
        f"(limit {SERVE_BF16_GAP}); launches per rank {_launches(run['ranks'])} [{card}]")
    if max(gap["ranks_2_vs_1"], gap["bf16_vs_fp32_1rank"]) > SERVE_BF16_GAP:
        raise AssertionError(f"score bf16 beyond the bf16 limit {SERVE_BF16_GAP}: {gap}")
    if gap["rows_shifted"] <= SERVE_BF16_GAP:
        raise AssertionError(f"the bf16 serve limit {SERVE_BF16_GAP} does not catch rows shifted by one: {gap}")

    # gene features, fp32, the 96 genes
    two = mp / "features_2"
    run = _group("expecto_tpu_torch.cli.compute_features", [str(WORK / "geneanno.csv"), "--genome",
                 str(WORK / "genome.fa"), "--beluga_weights", str(WORK / "beluga.npz"), "-o", str(two), "--device",
                 DEVICE], "compute_features")
    _rank_routes(run["ranks"], "float32", "compute_features")
    backends.add(run["backend"])
    wall2 = run["wall_2_s"]
    name = "Xreducedall.2002.representative_tss_top.npy"
    f1, f2 = np.load(WORK / "features_fp32" / name), np.load(two / name)
    limit = GENE_FEAT_RTOL * float(np.abs(f1).max())
    fgap = float(np.abs(f2 - f1).max()) if f1.shape == f2.shape else float("inf")
    shifted = float(np.abs(np.roll(f2, 1, axis=0) - f1).max())
    _no_leftovers(two, "compute_features")
    out["features"] = {"genes": int(f1.shape[0]), "wall_1_s": report["genes"]["fp32"]["cli_wall_s"],
                       "wall_2_s": wall2, "max_abs_err": fgap, "limit": limit, "rows_shifted": shifted,
                       "launches_per_rank": _launches(run["ranks"])}
    log(f"multi-process compute_features fp32 ({f1.shape[0]} genes): 1 rank {report['genes']['fp32']['cli_wall_s']:.3f}"
        f" s, 2 ranks {wall2:.3f} s; max |err| {fgap:.4g} (limit {limit:.4g}; rows shifted by one {shifted:.4g}); "
        f"launches per rank {_launches(run['ranks'])} [{card}]")
    if not (f2.shape == f1.shape and fgap <= limit < shifted):
        raise AssertionError(f"compute_features at 2 ranks: shape {f2.shape}, max |err| {fgap} (limit {limit})")

    # consensus ref, fp32
    cdir, cgenes = WORK / "consensus_ref", WORK / "consensus_genes.csv"
    two = mp / "consensus_ref_2"
    run = _group("expecto_tpu_torch.cli.consensus", ["ref", str(WORK / "models" / "tissue000.save"), str(cdir),
                 str(cgenes), "--beluga_weights", str(WORK / "beluga.npz"), "-o", str(two), "--device", DEVICE],
                 "consensus ref")
    _rank_routes(run["ranks"], "float32", "consensus ref")
    backends.add(run["backend"])
    wall2 = run["wall_2_s"]
    c1 = pd.read_csv(WORK / "consensus_ref_fp32" / "ref_preds.csv")
    c2 = pd.read_csv(two / "ref_preds.csv")
    climit = CONS_FEAT_RTOL * max(1.0, float(np.abs(c1["ref_preds"]).max()))
    if list(c2["genes"]) != list(c1["genes"]):
        raise AssertionError("consensus ref at 2 ranks: other genes, or genes in another order")
    cgap = float(np.abs(c2["ref_preds"] - c1["ref_preds"]).max())
    _no_leftovers(two, "consensus ref")
    out["consensus_ref"] = {"genes": len(c1), "wall_1_s": report["consensus"]["ref_cli"]["fp32"]["cli_wall_s"],
                            "wall_2_s": wall2, "max_abs_err": cgap, "limit": climit,
                            "launches_per_rank": _launches(run["ranks"])}
    log(f"multi-process consensus ref fp32 ({len(c1)} genes): 1 rank "
        f"{report['consensus']['ref_cli']['fp32']['cli_wall_s']:.3f} s, 2 ranks {wall2:.3f} s; max |err| {cgap:.4g} "
        f"(limit {climit:.4g}); launches per rank {_launches(run['ranks'])} [{card}]")
    if cgap > climit:
        raise AssertionError(f"consensus ref at 2 ranks: max |err| {cgap} over {climit}")

    # training at full width: the bootstrap CLI, 128 seeds, sound and with the identity all-reduce
    tdir = WORK / "train"
    n_blocks = -(-TRAIN_FEATURES // 512)
    want_calls = 3 + TRAIN_ROUNDS * (1 + n_blocks)
    saved1 = [load_expression_model(tdir / "boot" / f"bootstrap_seed{j}.save") for j in range(TRAIN_BOOT_SEEDS)]
    train = {"wall_1_s": report["train"]["boot"]["cli_wall_s"], "all_reduce_calls_expected": want_calls}
    for fault in ("", "identity"):
        odir = mp / f"boot_2{('_' + fault) if fault else ''}"
        seeds = MP_FAULT_SEEDS if fault else TRAIN_BOOT_SEEDS
        argv = ["--targetIndex", "1", "--bootstrap_seeds", str(seeds), "--expFile",
                str(tdir / "expression.csv"), "--inputFile", str(tdir / "Xreducedall.npy"), "--annoFile",
                str(tdir / "geneanno.csv"), "--output_dir", str(odir), "--device", DEVICE]
        run = _group("expecto_tpu_torch.cli.train", argv, f"train {fault or 'sound'}",
                     identity_all_reduce=bool(fault))
        backends.add(run["backend"])
        wall2, ranks = run["wall_2_s"], run["ranks"]
        wgap = bgap = 0.0
        for j in range(seeds):
            m2 = load_expression_model(odir / f"bootstrap_seed{j}.save")
            wgap = max(wgap, float(np.abs(m2.weight - saved1[j].weight).max()) / float(np.abs(saved1[j].weight).max()))
            bgap = max(bgap, abs(float(m2.bias) - float(saved1[j].bias)))
        row = {"seeds": seeds, "wall_2_s": wall2, "ranks": ranks, "w_gap_over_max_w": wgap, "bias_gap": bgap}
        steps = TRAIN_ROUNDS * n_blocks  # the split route: G, the all-reduce, the planes entry, the residual
        for r in ranks:
            if (r["gblinear_cd"] != steps or r["gblinear_round"] != 0 or r["all_reduce_calls"] != want_calls
                    or r["gblinear_block_grad_by_route"] != {"fused": 0, "split": steps}
                    or r["gblinear_block_resid"] != steps):
                raise AssertionError(f"train {fault or 'sound'} rank {r['rank']}: {r['gblinear_cd']} coordinate-update "
                                     f"launches (expected {steps}), {r['gblinear_round']} round-kernel launches "
                                     f"(expected 0), gradient kernel {r['gblinear_block_grad_by_route']} (expected "
                                     f"{steps} split), residual kernel {r['gblinear_block_resid']} (expected {steps}), "
                                     f"{r['all_reduce_calls']} all-reduce calls (expected {want_calls})")
        sound = wgap <= 1e-5 and bgap <= 1e-6
        log(f"multi-process cli.train --bootstrap_seeds {seeds}{' (identity all-reduce)' if fault else ''}: "
            f"2 ranks {wall2:.3f} s (torchrun; CLI main per rank " + ", ".join(
                f"{r['main_s']:.3f}" for r in ranks) + " s); every .save vs 1 rank: weights "
            f"{wgap:.4g} of max|w| (limit 1e-05), biases {bgap:.4g} (limit 1e-06); per rank "
            f"{ranks[0]['gblinear_block_grad']} gradient-kernel (split route), {ranks[0]['gblinear_cd']} "
            f"coordinate-update and {ranks[0]['gblinear_block_resid']} residual-kernel launches, "
            f"{ranks[0]['all_reduce_calls']} all-reduce calls "
            f"(3 + {TRAIN_ROUNDS} x (1 + {n_blocks})) taking " + ", ".join(
                f"{r['all_reduce_s']:.3f}" for r in ranks) + f" s of host time [{card}]")
        if fault and sound:
            raise AssertionError("the identity all-reduce stays within the training limits")
        if not fault and not sound:
            raise AssertionError(f"train at 2 ranks: weights {wgap} of max|w|, biases {bgap}")
        train["identity" if fault else "sound"] = row
    out["train"] = train
    log(f"  1 rank: cli.train --bootstrap_seeds {TRAIN_BOOT_SEEDS} {train['wall_1_s']:.3f} s (in process)")

    if len(backends) != 1:
        raise AssertionError(f"the groups took several backends: {backends}")
    out["backend"] = backends.pop()
    log(f"multi-process backend: {out['backend']} ({MP_RANKS} ranks, {out['cards']} card(s)); the ranks share one "
        f"card, so these walls measure the layer's cost, not scaling [{card}]")
    report["multiprocess"] = out


def rank_worker(args) -> int:
    """One rank of a multi-process group: ``args.cli_args`` is ``-m <module>
    <arguments>``, run as ``python -m`` runs it (``runpy``), with every
    kernel's launch count zeroed first and the training sweep's all-reduce
    calls and their host time counted (``--identity-all-reduce``: each rank
    keeps its local sums, a planted fault). Writes the counts to
    ``<rank_worker>.rank<r>.json`` and returns the module's exit code."""
    import runpy

    sys.path.insert(0, str(REPO))
    from expecto_tpu_torch.models import gblinear
    from expecto_tpu_torch.ops import conv0, conv8, fc1
    from expecto_tpu_torch.parallel import dist

    if args.cli_args[:1] != ["-m"] or len(args.cli_args) < 2:
        raise SystemExit("--rank-worker runs '-- -m <module> <arguments>'")
    module = args.cli_args[1]
    inner = (lambda t: t) if args.identity_all_reduce else gblinear._all_reduce
    stats = {"all_reduce_calls": 0, "all_reduce_s": 0.0}

    def counted(t):
        t0 = time.perf_counter()
        inner(t)
        stats["all_reduce_s"] += time.perf_counter() - t0
        stats["all_reduce_calls"] += 1
        return t

    gblinear._all_reduce = counted
    _count_standalone_pools()
    _reset_counts()
    _reset_train_counts()
    sys.argv = [module, *args.cli_args[2:]]
    t0 = time.perf_counter()
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    main_s = time.perf_counter() - t0  # the module's files are written from fetched results
    rank = dist.process_info()[0]
    Path(f"{args.rank_worker}.rank{rank}.json").write_text(json.dumps({
        "rank": rank, "rc": rc, "main_s": main_s, "conv8_relu": conv8.conv8_relu.launches,
        "conv8_relu_by_route": dict(conv8.conv8_relu.launches_by_route),
        "conv0_codes": conv0.conv0_codes_relu.launches,
        "conv0_codes_by_kind": dict(conv0.conv0_codes_relu.launches_by_kind),
        "fc1_strided": fc1.fc1_strided.launches, "fc1_strided_by_shape": _fc1_shapes_now(),
        "fc1_strided_by_route": dict(fc1.fc1_strided.launches_by_route), "fc1_split_tf32": fc1.split_planes.launches,
        **_train_counts(), "conv8_relu_pool4_by_route": dict(conv8.conv8_relu_pool4.launches_by_route),
        "pool4_standalone": STANDALONE_POOLS["calls"], **stats}))
    return rc


#: the launches the bench's training path makes: 3 warm and 10 timed rounds
#: of the K-model sweep, one block step a feature block (40 blocks of 512
#: over 20,020 features): each of its two kernels once
BENCH_BLOCK_STEPS = 13 * 40


def bench_phase(report: dict, card: str) -> None:
    """``python -m expecto_tpu_torch.bench`` (its ``main``) at full size, with
    every launch count zeroed just before it and read just after: the tc
    kernel, the code-gather conv0 in bf16 and the block step's two kernels
    must launch (the SIMT kernel, the round kernel and the coordinate
    update must not: the bench is bf16 and its training path is the
    K-model sweep in one process); its one result line must hold every path
    key, finite and positive."""
    import contextlib
    import math

    from expecto_tpu_torch import bench
    from expecto_tpu_torch.ops import gblinear_block, gblinear_cd
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu
    from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_pool4
    from expecto_tpu_torch.ops.fc1 import fc1_strided, split_planes

    _reset_counts()
    _reset_train_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    wall = time.perf_counter() - t0
    counts = {"conv8_relu_by_route": dict(conv8_relu.launches_by_route),
              "conv8_relu_by_kind": {f"{r} {dt} Cin {cin}": k for (r, dt, cin), k in
                                     sorted(conv8_relu.launches_by_kind.items())},
              "conv0_codes": conv0_codes_relu.launches, "conv0_codes_by_kind": dict(conv0_codes_relu.launches_by_kind),
              "fc1_strided": fc1_strided.launches, "fc1_strided_by_route": dict(fc1_strided.launches_by_route),
              "fc1_split_tf32": split_planes.launches,
              **_train_counts(), "conv8_relu_pool4_by_route": dict(conv8_relu_pool4.launches_by_route),
              "pool4_standalone": STANDALONE_POOLS["calls"]}
    FC1_SHAPES.update(fc1_strided.launches_by_shape)
    shapes = {"conv8_relu": dict(conv8_relu.launches_by_shape), "conv0_codes": dict(conv0_codes_relu.launches_by_shape),
              "gblinear_cd": dict(gblinear_cd.coord_update.launches_by_shape),
              "gblinear_block": dict(gblinear_block.grad_update.launches_by_shape)}
    lines = [line for line in out.getvalue().splitlines() if line.strip()]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"the bench returned {rc} and printed {len(lines)} lines: {lines[-3:]}")
    record = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "paths", "device"}
    if set(record) != keys or set(record["paths"]) != set(bench.PATH_KEYS):
        raise AssertionError(f"the bench's result keys {sorted(record)}, paths {sorted(record.get('paths', {}))}")
    for key, v in [("value", record["value"]), ("vs_baseline", record["vs_baseline"]), *record["paths"].items()]:
        if not (isinstance(v, float) and math.isfinite(v) and v > 0):
            raise AssertionError(f"bench {key} = {v!r}: not a finite number above 0")
    by_route, by_kind0 = counts["conv8_relu_by_route"], counts["conv0_codes_by_kind"]
    if not _on_conv_route(by_route, "bfloat16"):
        raise AssertionError(f"the bench's convs must run on the tc kernel alone: {by_route}")
    if counts["conv0_codes"] <= 0 or by_kind0 != {"bfloat16": counts["conv0_codes"]}:
        raise AssertionError(f"the bench's conv0 must run on the code-gather kernel in bf16: {by_kind0}")
    if (counts["fc1_strided"] <= 0 or counts["fc1_strided_by_route"] != {"tc": counts["fc1_strided"]}
            or counts["fc1_split_tf32"]):
        raise AssertionError(f"the bench's fc1 must run on the bf16 kernel alone: {counts}")
    if counts["pool4_standalone"] or counts["conv8_relu_pool4_by_route"] != {
            r: 2 * counts["conv0_codes"] * (r == "tc") for r in counts["conv8_relu_pool4_by_route"]}:
        raise AssertionError(f"the bench's pools must all run in the tc kernel's epilogue, two a conv stack: {counts}")
    want = {"gblinear_round": 0, "gblinear_cd": 0, "gblinear_block_grad": BENCH_BLOCK_STEPS,
            "gblinear_block_grad_by_route": {"fused": BENCH_BLOCK_STEPS, "split": 0},
            "gblinear_block_resid": BENCH_BLOCK_STEPS}
    if {key: counts[key] for key in want} != want:
        raise AssertionError(f"the bench's training path: launches {({key: counts[key] for key in want})}, expected "
                             f"{want}")
    report["bench"] = {"record": record, "wall_s": wall, "launches": counts,
                       "shape_checks": bench_shape_checks(shapes)}
    log(f"bench launches: tc {by_route['tc']}, simt {by_route['simt']}, tf32x3 {by_route['tf32x3']}, conv0_codes bf16 "
        f"{counts['conv0_codes']}, "
        f"fc1_strided {counts['fc1_strided']}, gblinear_cd {counts['gblinear_cd']}, "
        f"gblinear_round {counts['gblinear_round']}, gblinear_block_grad {counts['gblinear_block_grad']}, "
        f"gblinear_block_resid {counts['gblinear_block_resid']}")
    log(f"bench result: {lines[0]}")
    log(f"bench wall {wall:.1f} s [{card}]")


def bench_shape_checks(shapes: dict) -> dict:
    """Each kernel held against its plain version at every shape the bench's
    run launched it at (``shapes``: the wrappers' ``launches_by_shape``),
    on seeded inputs: the conv kernels against the fp32 plain version with
    the earlier phases' tolerances, the coordinate update bit for bit
    (alpha 0, the bench's, and 0.7), the block step's kernels by
    :func:`block_step_row`'s checks (``max_abs_err``: G's against float64
    for the gradient kernel, the increment's share of its max for the
    residual kernel). Returns {kernel: {"shapes", "launches",
    "max_abs_err"}}; the checks' own launches come after the bench's counts
    were read."""
    import torch

    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv0 import conv0_codes_relu, conv0_codes_relu_plain
    from expecto_tpu_torch.ops.conv8 import _route, conv8_relu, conv8_relu_plain

    t0 = time.perf_counter()
    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(7)
    out = {}

    def tally(kernel: str, launches: int, err: float) -> None:
        row = out.setdefault(kernel, {"shapes": 0, "launches": 0, "max_abs_err": 0.0})
        row["shapes"] += 1
        row["launches"] += launches
        row["max_abs_err"] = max(row["max_abs_err"], err)

    for (route, dtype, n, length, cin, cout), launches in sorted(shapes["conv8_relu"].items()):
        dt = getattr(torch, dtype)
        x = torch.randn((n, length, cin), generator=gen, device=gen.device).to(dt)
        w = (torch.randn((8, cin, cout), generator=gen, device=gen.device) / (8 * cin) ** 0.5).to(dt)
        b = (torch.randn((cout,), generator=gen, device=gen.device) * 0.1).to(dt)
        if _route("cuda", dt, cin, x.data_ptr()) != route:
            raise AssertionError(f"bench shape N={n} L={length} {cin}->{cout} {dtype} would not take the {route} route")
        atol, rtol = (FP32_ATOL, FP32_RTOL) if dt == torch.float32 else (BF16_ATOL, BF16_RTOL)
        name = {"tc": "conv8_relu_tc", "tf32x3": "conv8_relu_tf32x3"}.get(route, "conv8_relu")
        err = _check_close(conv8_relu(x, w, b, route=route), conv8_relu_plain(x.float(), w.float(), b.float()),
                           atol, rtol, f"bench shape {name} {dtype} N={n} L={length} {cin}->{cout}")
        tally(name, launches, err)
        del x
    for (dtype, n, length, cout), launches in sorted(shapes["conv0_codes"].items()):
        dt = getattr(torch, dtype)
        _kw, cin, _cout = CONV_SPECS[0]
        codes = _conv0_codes(n, length, gen)
        w = (torch.randn((8, cin, cout), generator=gen, device=gen.device) / (8 * cin) ** 0.5).to(dt)
        b = (torch.randn((cout,), generator=gen, device=gen.device) * 0.1).to(dt)
        tol = CONV0_FP32_TOL if dt == torch.float32 else BF16_ATOL
        err = _check_close(conv0_codes_relu(codes, w, b), conv0_codes_relu_plain(codes, w.float(), b.float()), tol, tol,
                           f"bench shape conv0_codes {dtype} N={n} L={length}")
        tally("conv0_codes", launches, err)
        del codes
    for (b, k), launches in sorted(shapes["gblinear_cd"].items()):
        for alpha in (0.0, 0.7):
            _cd_checked(b, k, alpha, gen)
        tally("gblinear_cd", launches, 0.0)
    for (b, n, k, _route), launches in sorted(shapes["gblinear_block"].items()):
        if b != 512:
            raise AssertionError(f"the bench's block step at {b} features: block_step_row checks blocks of 512")
        row = block_step_row(n, k, gen, timed=False)
        tally("gblinear_block_grad", launches, row["max_abs_err"])
        tally("gblinear_block_resid", launches, row["inc_max_abs_err"])
    torch.cuda.empty_cache()
    for name, row in out.items():
        log(f"bench shapes: {name} held against its plain version at {row['shapes']} shapes ({row['launches']} of the "
            f"bench's launches), max |err| {row['max_abs_err']:.3g}")
    log(f"bench shape checks {time.perf_counter() - t0:.1f} s")
    return out


def _fc1_tol(want) -> float:
    return FC1_TOL_STEPS * 2.0**-8 * float(want.float().abs().max())


def _fc1_boundary_shapes() -> Counter:
    """The fp32 routes' boundary shapes (FC1_BOUNDARY_M and SWAP_MAX_M, SWAP_MAX_M + 1
    windows of the serving span's buffer), each with 0 launches of the flows."""
    from expecto_tpu_torch.ops import fc1

    shapes = Counter()
    for m in sorted({*FC1_BOUNDARY_M, fc1.SWAP_MAX_M, fc1.SWAP_MAX_M + 1}):
        n_win = next(w for w in (5, 4, 3, 2, 1) if m % w == 0)
        shapes[("float32", m // n_win, 206, 640, 0, 25, n_win, 2003)] += 0
    return shapes


def fc1_phase(report: dict, card: str) -> None:
    """The fc1 kernels at every shape of FC1_SHAPES (what the flows, the
    2-rank serves and the bench launched them at) and, in fp32, at the
    routes' boundary (_fc1_boundary_shapes), on seeded inputs at Beluga's
    widths. bf16 (csrc/fc1_strided_tc.cu): held against the plain version
    (fp32 sum) within FC1_TOL_STEPS bf16 steps of max|y|. fp32 (the split
    pass and the swapped kernel, or the tf32x3 kernel, by M): held against a
    float64 product of the same inputs within FC1_FP32_REL of max|y| and
    against the plain version (SGEMM, TF32 off) within FC1_FP32_PLAIN_REL,
    which the plain version must meet against float64; at a boundary shape
    the other fp32 kernel too (through ops/fc1._launch), so both are held
    on every run. In both dtypes, the
    plain version with the first window read one frame late must miss the
    limit and two calls are equal bit for bit; each is timed beside its
    bound, the plain version, today's ``unfold`` + 2003-column
    ``torch.matmul`` (the path the kernel replaced; in fp32 the plain
    version itself) and the library yardstick, one ``torch.matmul`` of the
    same windows, as one contiguous (M, K) matrix, by the weight
    zero-padded to 2,048 columns (the port never calls it), timed twice,
    before and after a second timing of the kernel; ``vs_library`` is the
    kernel's best time over the yardstick's, and a shape where the kernel is
    slower than the yardstick by more than the yardstick's two timings
    differ is logged and listed under ``slower_than_library``. An fp32 row
    records its route and the bytes its launches stream
    (``fc1.streamed_bytes``); the split pass is held against its plain
    version bit for bit and timed alone beside it. These
    launches come after every flow's counts were read."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.ops import fc1

    t0 = time.perf_counter()
    if {key[0] for key in FC1_SHAPES} != set(FC1_ROUTES):
        raise AssertionError(f"the flows did not launch both dtypes' fc1 kernels: {sorted(FC1_SHAPES)}")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(15)
    weights = {}
    rows = []
    shapes = Counter(FC1_SHAPES)
    shapes.update(_fc1_boundary_shapes())
    boundary_m = {key[1] * key[6] for key in _fc1_boundary_shapes()}
    for (dtype, n, f, c, s0, stride, n_win, n_out), launches in sorted(shapes.items()):
        dt = getattr(torch, dtype)
        k, m = fc1.FC1_FRAMES * c, n * n_win
        if (dtype, k, n_out) not in weights:
            w = (torch.randn((k, n_out), generator=gen, device=dev) / k**0.5).to(dt)
            weights[(dtype, k, n_out)] = (w, F.pad(w, (0, -(-n_out // 256) * 256 - n_out)))
        w, w_pad = weights[(dtype, k, n_out)]
        buf = torch.rand((n, f, c), generator=gen, device=dev).to(dt)
        shape = f"{dtype} N={n} F={f} C={c} s0={s0} stride={stride} n_win={n_win} Nout={n_out}"
        route = fc1._route("cuda", dt, m)
        boundary = dtype == "float32" and m in boundary_m
        # the route's call, and at a boundary shape the other fp32 kernel
        calls = {route: lambda: fc1.fc1_strided(buf, w, s0, stride, n_win)}
        if boundary:
            other = "tf32x3" if route == "tf32x3_swap" else "tf32x3_swap"
            calls[other] = lambda r=other: fc1._launch(r, buf, w, s0, stride, n_win)
        want = fc1.fc1_strided_plain(buf, w, s0, stride, n_win)
        a = fc1._windows(buf, s0, stride, n_win).reshape(m, k)
        late_s0 = s0 + 1 if s0 + 1 + fc1.FC1_FRAMES <= f else s0 - 1  # one frame off, inside the buffer
        late = want.clone()
        late[:, 0] = fc1.fc1_strided_plain(buf, w, late_s0, stride, 1)[:, 0]
        exact = (a.double() @ w.double()).float().reshape(want.shape) if dtype == "float32" else None
        checked = {}
        for r, call in calls.items():
            y = call()
            bit_equal = torch.equal(y, call())
            err = float((y.float() - want.float()).abs().max())
            extra, ok = {}, True
            if exact is not None:
                # tol: the limit against the plain version; f64_tol: the
                # kernel's own against float64
                scale = float(exact.abs().max())
                tol = FC1_FP32_PLAIN_REL * scale
                extra = {"err_f64": float((y - exact).abs().max()), "plain_err_f64": float((want - exact).abs().max()),
                         "f64_tol": FC1_FP32_REL * scale}
                ok = extra["err_f64"] <= extra["f64_tol"] and extra["plain_err_f64"] <= tol
            else:
                tol = _fc1_tol(want)
            fault_err = float((y.float() - late.float()).abs().max())
            if not (bit_equal and ok) or err > tol or fault_err <= tol:
                raise AssertionError(f"fc1 {r} kernel at {shape}: bit-equal repeat {bit_equal}, max |err| {err} (limit "
                                     f"{tol}) {extra}, planted late window {fault_err} (must exceed the limit)")
            checked[r] = {"max_abs_err": err, "tol": tol, "planted_fault_err": fault_err, **extra}
            del y
        del exact
        span = (n_win - 1) * stride + fc1.FC1_FRAMES  # the frames the windows cover
        nbytes = buf.element_size() * (n * span * c + k * n_out + n * n_win * n_out)
        ops = 2.0 * n * n_win * k * n_out
        row = {"dtype": dtype, "route": route, "kernel": fc1.KERNELS[route], "N": n, "F": f, "C": c, "s0": s0,
               "stride": stride, "n_win": n_win, "Nout": n_out, "M": m, "launches": launches, "boundary": boundary,
               **checked[route],
               **(_bound(nbytes, 3 * ops, "tf32") if dtype == "float32" else _bound(nbytes, ops, "bf16")),
               "streamed_bytes": fc1.streamed_bytes(route, n, n_win, stride, c, n_out),
               "schedule": list(fc1.fc1_schedule(m, n_out, k, fc1.resident_ctas(dev), tiles=fc1.TILES[route])),
               "ms": cuda_ms(calls[route]),
               "plain_ms": cuda_ms(lambda: fc1.fc1_strided_plain(buf, w, s0, stride, n_win), reps=3, warmup=1),
               "unfold_matmul_ms": cuda_ms(lambda: fc1._windows(buf, s0, stride, n_win) @ w, reps=3, warmup=1)}
        if dtype == "float32":
            row["ffma_bound_ms"] = 1e3 * ops / PEAK_FLOPS["fp32"]  # one pass of fp32 operations outside the tensor cores
            # the split pass alone: equal to its plain version bit for bit
            planes, planes_plain = fc1.split_planes(buf, s0, span), fc1.split_planes_plain(buf, s0, span)
            if not torch.equal(planes.view(torch.int32), planes_plain.view(torch.int32)):
                raise AssertionError(f"the fc1 split pass differs from split_tf32 at {shape}")
            row["split_max_abs_err"] = float((planes - planes_plain).abs().max())
            del planes, planes_plain
            row["split_ms"] = cuda_ms(lambda: fc1.split_planes(buf, s0, span))
            row["split_plain_ms"] = cuda_ms(lambda: fc1.split_planes_plain(buf, s0, span), reps=3, warmup=1)
            row["split_bound_ms"] = 1e3 * 12 * n * span * c / PEAK_BYTES  # one fp32 read, two writes
        if boundary:
            row["other"] = {"route": other, **checked[other], "ms": cuda_ms(calls[other]),
                            "streamed_bytes": fc1.streamed_bytes(other, n, n_win, stride, c, n_out)}
        # the yardstick timed twice, before and after the kernel's second
        # timing: their difference is the noise that a slower kernel must
        # exceed to count as slower
        lib = [cuda_ms(lambda: a @ w_pad, reps=3, warmup=1)]
        row["ms_again"] = cuda_ms(calls[route])
        lib.append(cuda_ms(lambda: a @ w_pad, reps=3, warmup=1))
        row.update(library_ms=min(lib), library_noise_ms=abs(lib[0] - lib[1]), ms=min(row["ms"], row["ms_again"]))
        row.update(vs_library=row["ms"] / row["library_ms"], share_of_bound=row["bound_ms"] / row["ms"],
                   slower_than_library=row["ms"] > row["library_ms"] + row["library_noise_ms"])
        ffma = ""
        if dtype == "float32":
            row["share_of_ffma_peak"] = row["ffma_bound_ms"] / row["ms"]
            ffma = (f"; {100 * row['share_of_ffma_peak']:.1f} % of the FFMA peak; {row['streamed_bytes'] / 1e9:.3f} GB "
                    f"streamed; split pass {row['split_ms']:.3f} ms, bound {row['split_bound_ms']:.3f}")
            if boundary:
                ffma += f"; {other} {row['other']['ms']:.3f} ms, err_f64 {row['other']['err_f64']:.3g}"
        rows.append(row)
        errs = "".join(f", {key} {v:.3g}" for key, v in checked[route].items() if key not in ("max_abs_err", "tol"))
        log(f"fc1 {route} kernel {shape} (M={m}, schedule {row['schedule']}) x{launches}: {row['ms']:.3f} ms (err "
            f"{row['max_abs_err']:.3g}{errs}, limit {row['tol']:.3g}; bit-equal) bound {row['bound_ms']:.3f} "
            f"ms ({row['bound_by']}, {100 * row['share_of_bound']:.1f} % of it{ffma}) "
            f"plain {row['plain_ms']:.3f} ms unfold+matmul {row['unfold_matmul_ms']:.3f} ms padded matmul "
            f"{row['library_ms']:.3f} ms (noise {row['library_noise_ms']:.3f}; kernel/yardstick "
            f"{row['vs_library']:.3f}) [{card}]")
        if row["slower_than_library"]:
            log(f"fc1 kernel SLOWER than the padded matmul at {shape}: {row['ms']:.3f} ms against "
                f"{row['library_ms']:.3f} ms (noise {row['library_noise_ms']:.3f} ms) [{card}]")
        del buf, a, want, late
    torch.cuda.empty_cache()
    slower = [r for r in rows if r["slower_than_library"]]
    report["fc1"] = {"shapes": rows, "phase_s": time.perf_counter() - t0,
                     "slower_than_library": [{key: r[key] for key in ("dtype", "route", "N", "F", "s0", "stride",
                                                                       "n_win", "M", "ms", "library_ms",
                                                                       "library_noise_ms")}
                                             for r in slower]}
    for route in fc1.ROUTES:
        mine = [r for r in rows if r["route"] == route]
        if not mine:
            raise AssertionError(f"the fc1 phase held no shape on the {route} kernel")
        log(f"fc1 phase, {route}: {len(mine)} shapes, {sum(r['launches'] for r in mine)} launches of the flows and "
            f"the bench, kernel/yardstick {min(r['vs_library'] for r in mine):.3f}-"
            f"{max(r['vs_library'] for r in mine):.3f}, {100 * min(r['share_of_bound'] for r in mine):.1f}-"
            f"{100 * max(r['share_of_bound'] for r in mine):.1f} % of the bound, "
            f"{sum(r['slower_than_library'] for r in mine)} shapes slower than the yardstick beyond its noise")
    log(f"fc1 phase {time.perf_counter() - t0:.1f} s")


def _fc1_launch_run(report: dict, route: str) -> tuple[str, dict]:
    """(name, report entry) of the run whose fc1 launches a route's kernel
    line entry reports: the bf16 serve (the main path) for "tc"; for an fp32
    route the warm fp32 serve, or the fp32 parity run where the serve's
    chunks never took that route."""
    if route == "tc":
        return "bf16 serve (main path)", report["main_path"]
    runs = [("warm fp32 serve", report["fp32_serve"]), ("fp32 parity", report["parity"])]
    for name, run in runs:
        if run["launches"]["fc1_strided_by_route"].get(route, 0) > 0:
            return name, run
    raise AssertionError(f"neither the fp32 serve nor the parity run launched the {route} kernel: "
                         f"{[run['launches']['fc1_strided_by_route'] for _name, run in runs]}")


def fc1_entry(report: dict, route: str) -> dict:
    """The kernel line's entry of ``route``'s fc1 kernel: every number
    launch-weighted over the fc1 shapes that route took in its run
    (_fc1_launch_run), a mean per launch (the swapped kernel's ms include
    the split pass, which its calls run first); ``launches`` are that run's,
    ``launches_*`` the other flows'."""
    dtype = "bfloat16" if route == "tc" else "float32"
    tag = "bf16" if route == "tc" else "fp32"
    run_name, run = _fc1_launch_run(report, route)
    rows = [r for r in report["fc1"]["shapes"] if r["route"] == route]
    by_shape = {(dtype, r["N"], r["F"], r["C"], r["s0"], r["stride"], r["n_win"], r["Nout"]): r for r in rows}
    shapes = {tuple(k): n for k, n in run["fc1_launches_by_shape"] if tuple(k) in by_shape}
    total = sum(shapes.values())

    def mean(key: str) -> float:
        return sum(n * by_shape[s][key] for s, n in shapes.items()) / total

    def flow(launches: dict) -> int:
        return launches["fc1_strided_by_route"].get(route, 0)

    pipe = {f: flow(p["launches"]) for f, p in report["pipeline"].items() if p["dtype"] == dtype and flow(p["launches"])}
    mixes = report["consensus"]["mixes"].values()
    entry = {
        "name": f"fc1_strided_{route}", "route": "cuda",
        "source": f"expecto_tpu_torch/csrc/fc1_strided_{route}.cu",
        "replaces": "expecto_tpu/ops/spans.py:421", "launches": flow(run["launches"]), "launches_run": run_name,
        "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": "operations" if mean("ops_ms") >= mean("bytes_ms") else "bytes",
        "library_ms": mean("library_ms"), "dtype": tag, "unfold_matmul_ms": mean("unfold_matmul_ms"),
        "min_planted_fault_err_over_tol": min(r["planted_fault_err"] / r["tol"] for r in rows),
        "max_err_over_tol": max(r["max_abs_err"] / r["tol"] for r in rows), "shapes_checked": len(rows),
        "max_vs_library": max(r["vs_library"] for r in rows),
        "min_share_of_bound": min(r["share_of_bound"] for r in rows),
        "shapes_slower_than_library": sum(r["slower_than_library"] for r in rows),
        "sass_hgmma": report["sass_fc1_hgmma"][route],
        f"launches_h5_{tag}": flow(report["h5_contract"][tag]["launches"]),
        f"launches_gene_{tag}": flow(report["genes"][tag]["launches"]),
        f"launches_consensus_{tag}": sum(flow(m[tag]["launches"]) for m in mixes),
        "launches_pipeline": pipe,
    }
    if route == "tc":
        entry["launches_2rank_bf16"] = [r["fc1_strided_by_route"].get(route, 0)
                                        for r in report["multiprocess"]["score_bf16"]["launches_per_rank"]]
    else:
        entry.update(
            launches_fp32_serve=flow(report["fp32_serve"]["launches"]),
            launches_fp32_parity=flow(report["parity"]["launches"]),
            max_err_f64=max(r["err_f64"] for r in rows), max_plain_err_f64=max(r["plain_err_f64"] for r in rows),
            max_err_f64_over_tol=max(r["err_f64"] / r["f64_tol"] for r in rows),
            ffma_bound_ms=mean("ffma_bound_ms"), min_share_of_ffma_peak=min(r["share_of_ffma_peak"] for r in rows),
            streamed_bytes=mean("streamed_bytes"), split_ms=mean("split_ms"),
            boundary_shapes=[{"M": r["M"], "ms": r["ms"], "other_route": r["other"]["route"],
                              "other_ms": r["other"]["ms"], "library_ms": r["library_ms"]}
                             for r in report["fc1"]["shapes"] if r["boundary"] and r["route"] == route],
            launches_2rank_fp32=[r["fc1_strided_by_route"].get(route, 0)
                                 for r in report["multiprocess"]["score_fp32"]["launches_per_rank"]])
    return entry


def fc1_split_entry(report: dict) -> dict:
    """The kernel line's entry of the swapped kernel's split pass:
    launch-weighted over the shapes that kernel took in its run
    (_fc1_launch_run, one split a launch), against its plain version
    (split_tf32, bit for bit) and its byte bound (one fp32 read and two
    writes of the frames the windows cover); no library call computes it."""
    import torch

    from expecto_tpu_torch.ops import fc1

    run_name, run = _fc1_launch_run(report, "tf32x3_swap")
    fp32 = [r for r in report["fc1"]["shapes"] if r["dtype"] == "float32"]
    rows = {(r["N"], r["F"], r["C"], r["s0"], r["stride"], r["n_win"], r["Nout"]): r for r in fp32}
    shapes = {tuple(k[1:]): n for k, n in run["fc1_launches_by_shape"]
              if k[0] == "float32" and fc1._route("cuda", torch.float32, k[1] * k[6]) == "tf32x3_swap"}
    total = sum(shapes.values())

    def mean(key: str) -> float:
        return sum(n * rows[s][key] for s, n in shapes.items()) / total

    return {"name": "fc1_split_tf32", "route": "cuda", "source": "expecto_tpu_torch/csrc/fc1_split_tf32.cu",
            "replaces": "expecto_tpu/ops/spans.py:421", "launches": run["launches"]["fc1_split_tf32"],
            "launches_run": run_name, "max_abs_err": max(r["split_max_abs_err"] for r in fp32),
            "ms": mean("split_ms"), "plain_ms": mean("split_plain_ms"), "bound_ms": mean("split_bound_ms"),
            "bound_by": "bytes", "library_ms": None, "dtype": "fp32", "shapes_checked": len(fp32),
            "launches_fp32_serve": report["fp32_serve"]["launches"]["fc1_split_tf32"],
            "launches_parity": report["parity"]["launches"]["fc1_split_tf32"]}


def _flow_conv_launches(report: dict) -> dict:
    """{flow: (tc launches of its bf16 run, tf32x3 launches of its fp32 run)},
    the runs PARENT_CONV_LAUNCHES counts."""
    by = lambda c, r: c["conv8_relu_by_route"][r]  # noqa: E731
    mixes = report["consensus"]["mixes"].values()
    fp = CONV_ROUTE["float32"]
    return {"serve": (by(report["main_path"]["launches"], "tc"), by(report["parity"]["launches"], fp)),
            "h5": (by(report["h5_contract"]["bf16"]["launches"], "tc"), by(report["h5_contract"]["fp32"]["launches"], fp)),
            "gene": (by(report["genes"]["bf16"]["launches"], "tc"), by(report["genes"]["fp32"]["launches"], fp)),
            "consensus": (sum(by(m["bf16"]["launches"], "tc") for m in mixes),
                          sum(by(m["fp32"]["launches"], fp) for m in mixes))}


def _pooled_flows(report: dict) -> dict:
    """{chunk: its per-shape rows} of every chunk the conv phases ran, as
    the flows launch it (conv1 and conv3 pooled): the serving chunk's
    conv1-conv5, each h5 pair chunk, the gene chunk and each consensus
    case (the backbone, the patch batches, the dedup windows, the fallback
    spans)."""
    cases = dict.fromkeys(r["case"] for r in report["consensus_layers"])
    return {"serve": report["conv8_layers"],
            **{f"h5 N={n}": [r for r in report["h5_layers"] if r["N"] == n] for n in H5_CHUNK_N},
            "gene": report["gene_layers"],
            **{f"consensus {c}": [r for r in report["consensus_layers"] if r["case"] == c] for c in cases}}


POOL_KEYS = ("ms", "replaced_ms", "pools_ms", "plain_ms", "library_ms", "bound_ms")


def pool_phase(report: dict, card: str, seed: int) -> None:
    """The pools fused into conv1's and conv3's kernel launches
    (``conv8_relu_pool4``) across the flows. The conv phases checked and
    timed every pooled shape (_conv8_cell); here each chunk's pooled
    launches are summed, launch-weighted: fused, the replaced path (kernel +
    pool), the pools alone, the plain version, the library yardstick and
    the bound. Then every flow's standalone pools (0, read by _read_counts)
    and, at the default seed, its conv launches by route against the
    parent's."""
    chunks = {}
    for chunk, rows in _pooled_flows(report).items():
        pooled = [r for r in rows if r["pool"]]
        for tag in ("bf16", "fp32"):
            c = chunks[f"{chunk} {tag}"] = {k: _weighted(pooled, tag, k) for k in POOL_KEYS}
            log(f"pool4 {chunk} {tag} ({sum(r['launches_per_chunk'] for r in pooled)} pooled launches a chunk): "
                f"fused {c['ms']:.3f} ms, replaced path {c['replaced_ms']:.3f} ms (pools {c['pools_ms']:.3f}), "
                f"plain {c['plain_ms']:.3f} ms, conv1d+max_pool1d {c['library_ms']:.3f} ms, bound "
                f"{c['bound_ms']:.3f} ms [{card}]")
    flows = _flow_conv_launches(report)
    log(f"conv launches by flow (tc bf16, tf32x3 fp32): {flows}; parent's at seed 0: {PARENT_CONV_LAUNCHES}; no "
        f"standalone pool in any flow (each flow's read)")
    if seed == 0 and flows != PARENT_CONV_LAUNCHES:
        raise AssertionError(f"conv launches by flow {flows} differ from the parent's {PARENT_CONV_LAUNCHES}")
    report["pool4"] = {"chunks": chunks, "conv_launches": flows}


def pool4_entry(report: dict, tag: str) -> dict:
    """The pooled epilogue's fields of a conv kernel's entry in the kernel
    line: per chunk of each flow (launch-weighted over its pooled launches)
    and per pooled shape its ms, the replaced path's (kernel + pool), the
    pools' alone, the plain version's, the yardstick's and the bound; the
    pooled launches of the kernel's main-path run; the standalone pools of
    its serve, h5, gene and consensus runs (0: each run's read checks it)."""
    run = report["main_path" if tag == "bf16" else "parity"]["launches"]
    flows = [run, report["h5_contract"][tag]["launches"], report["genes"][tag]["launches"],
             *(m[tag]["launches"] for m in report["consensus"]["mixes"].values())]
    shapes = {f"{chunk} {r['layer']} N={r['N']} L={r['L']}": {k: r[tag][k] for k in POOL_KEYS} | {"pool": r["pool"]}
              for chunk, rows in _pooled_flows(report).items() for r in rows if r["pool"]}
    return {"launches": run["conv8_relu_pool4_by_route"][CONV_ROUTE["bfloat16" if tag == "bf16" else "float32"]],
            "standalone_pool_launches": sum(c["pool4_standalone"] for c in flows),
            "max_abs_err": max(r[tag]["max_abs_err"] for rows in _pooled_flows(report).values() for r in rows
                               if r["pool"]),
            "chunks": {what.removesuffix(f" {tag}"): c for what, c in report["pool4"]["chunks"].items()
                       if what.endswith(f" {tag}")},
            "shapes": shapes}


def kernel_table(report: dict) -> dict:
    """The kernel line: one entry per hand-written kernel, over the launches
    of one substitution chunk that its main path gives it (each shape
    weighted by its launches there): the tc kernel at bf16 conv1-conv5 and
    the code-gather kernel at bf16 conv0, whose ``launches`` are the bf16
    serving run's; the tf32x3 kernel at fp32 conv1-conv5, whose ``launches``
    are the fp32 parity run's on the card; the SIMT kernel on the same fp32
    work, timed beside it (``launches``: the same run's, 0 since every fp32
    flow's conv1-conv5 take the tf32x3 route). ``launches_h5_*`` are the timed
    h5-contract chromatin runs', ``h5_chunk_ms`` the kernel's time in one
    full pair chunk of them; ``launches_gene_*`` are the timed gene-feature
    calls', ``gene_chunk_ms`` the kernel's time in one gene chunk of them
    (16 spans of 41,800 bp); ``launches_pipeline`` are a call's launches in
    each pipeline-phase flow that runs the kernel (the same at both depths);
    ``launches_bench`` are every kernel's launches in the bench phase's run,
    ``shapes_bench`` the distinct shapes of those, each held against the
    plain version; ``max_abs_err`` covers every path's shapes. conv1 and
    conv3 are pooled launches everywhere, as the flows make them (their
    replaced path and the other pool numbers in ``pool4``). Per-shape numbers
    in ``layers``, ``h5_layers``, ``gene_layers`` and ``consensus_layers``."""
    from expecto_tpu_torch.ops import fc1

    conv8, conv0 = report["conv8_layers"], report["conv0_layers"]
    h5_full = [r for r in report["h5_layers"] if r["N"] == H5_CHUNK_N[0]]
    serve, parity = report["main_path"]["launches"], report["parity"]["launches"]
    h5 = {t: report["h5_contract"][t]["launches"] for t in ("fp32", "bf16")}
    gene = {t: report["genes"][t]["launches"] for t in ("fp32", "bf16")}
    mixes = report["consensus"]["mixes"].values()
    pipe = report["pipeline"]
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

    def pipe_launches(route: str) -> dict:
        """{pipeline flow: launches a call} of the flows that launch the kernel."""
        got = {f: p["launches"]["conv0_codes"] if route == "codes" else p["launches"]["conv8_relu_by_route"][route]
               for f, p in pipe.items()}
        return {f: n for f, n in got.items() if n}

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

    def simt_entry() -> dict:
        """The SIMT kernel's entry: its times on the fp32 shapes of the
        tf32x3 route (``route="simt"``), which no flow sends it now."""
        fp = "fp32"
        timed = lambda rows: [r for r in rows if "simt_ms" in r[fp]]  # noqa: E731
        gene_rows = timed([r for r in report["gene_layers"] if r["layer"] != "conv0"])
        cons = lambda key: {c: _weighted(timed([r for r in report["consensus_layers"] if r["case"] == c  # noqa: E731
                                                and r["layer"] != "conv0"]), fp, key) for c in cons_cases}
        return {
            "name": "conv8_relu", "route": "cuda", "source": "expecto_tpu_torch/csrc/conv8_relu.cu",
            "replaces": "expecto_tpu/ops/pallas_conv.py:49", "launches": parity["conv8_relu_by_route"]["simt"],
            "launches_run": "fp32 parity",
            "max_abs_err": max(r[fp]["simt_max_abs_err"] for r in timed(conv8) + gene_rows),
            "ms": _weighted(conv8, fp, "simt_ms"), "plain_ms": _weighted(conv8, fp, "plain_ms"),
            "bound_ms": _weighted(conv8, fp, "bound_ms"), "bound_by": "operations",
            "library_ms": _weighted(conv8, fp, "library_ms"), "dtype": fp,
            "ffma_bound_ms": _weighted(conv8, fp, "ffma_bound_ms"),
            "min_shape_ffma_share": report["fp32_conv_chunk"]["simt_min_shape_ffma_share"],
            "gene_chunk_ms": _weighted(gene_rows, fp, "simt_ms"), "consensus_ms": cons("simt_ms"),
            "launches_fp32_flows": {"serve": report["fp32_serve"]["launches"]["conv8_relu_by_route"]["simt"],
                                    "h5": h5[fp]["conv8_relu_by_route"]["simt"],
                                    "gene": gene[fp]["conv8_relu_by_route"]["simt"],
                                    "consensus": cons_launches(fp, "simt"), "pipeline": pipe_launches("simt")},
            "bf16_ms": sum(r["bf16"]["simt"]["ms"] * r["launches_per_chunk"] for r in conv8),
            "sass_ffma": report["sass_simt"]["FFMA"], "sass_lds": report["sass_simt"]["LDS"],
            "sass_hmma": report["sass_simt"]["HMMA"], "sass_hgmma": report["sass_simt"]["HGMMA"],
        }

    fp32_rows = [r for r in conv8 + report["h5_layers"] + report["gene_layers"] + report["consensus_layers"]
                 if r["layer"] != "conv0"]
    bench = report["bench"]["launches"]
    launches_bench = {"conv8_relu_tc": bench["conv8_relu_by_route"]["tc"],
                      "conv8_relu_tf32x3": bench["conv8_relu_by_route"]["tf32x3"],
                      "conv8_relu": bench["conv8_relu_by_route"]["simt"], "conv0_codes": bench["conv0_codes"],
                      "gblinear_cd": bench["gblinear_cd"], "gblinear_round": bench["gblinear_round"],
                      "gblinear_block_grad": bench["gblinear_block_grad"],
                      "gblinear_block_resid": bench["gblinear_block_resid"],
                      **{fc1.KERNELS[r]: bench["fc1_strided_by_route"].get(r, 0) for r in fc1.ROUTES},
                      "fc1_split_tf32": bench["fc1_split_tf32"]}
    table = {"kernels": [
        entry("conv8_relu_tc", "expecto_tpu_torch/csrc/conv8_relu_tc.cu", conv8, "bf16",
              serve["conv8_relu_by_route"]["tc"], sass_hgmma=report["sass_hgmma"],
              launches_h5_bf16=h5["bf16"]["conv8_relu_by_route"]["tc"],
              launches_gene_bf16=gene["bf16"]["conv8_relu_by_route"]["tc"],
              launches_consensus_bf16=cons_launches("bf16", "tc"), consensus_ms=cons_ms("bf16", False),
              consensus_bound_ms=cons_ms("bf16", False, "bound_ms"),
              consensus_library_ms=cons_ms("bf16", False, "library_ms"), launches_pipeline=pipe_launches("tc"),
              pool4=pool4_entry(report, "bf16")),
        entry("conv8_relu_tf32x3", "expecto_tpu_torch/csrc/conv8_relu_tf32x3.cu", conv8, "fp32",
              parity["conv8_relu_by_route"]["tf32x3"], launches_run="fp32 parity",
              launches_fp32_serve=report["fp32_serve"]["launches"]["conv8_relu_by_route"]["tf32x3"],
              launches_h5_fp32=h5["fp32"]["conv8_relu_by_route"]["tf32x3"],
              launches_gene_fp32=gene["fp32"]["conv8_relu_by_route"]["tf32x3"],
              launches_consensus_fp32=cons_launches("fp32", "tf32x3"), consensus_ms=cons_ms("fp32", False),
              consensus_bound_ms=cons_ms("fp32", False, "bound_ms"),
              consensus_library_ms=cons_ms("fp32", False, "library_ms"), launches_pipeline=pipe_launches("tf32x3"),
              launches_2rank_fp32={k: [r["conv8_relu"]["tf32x3"] for r in report["multiprocess"][k]["launches_per_rank"]]
                                   for k in ("score_fp32", "features", "consensus_ref")},
              ffma_bound_ms=_weighted(conv8, "fp32", "ffma_bound_ms"), simt_ms=_weighted(conv8, "fp32", "simt_ms"),
              min_shape_bound_share=report["fp32_conv_chunk"]["min_shape_share"],
              max_f64_rel=max(r["fp32"]["f64_rel"] for r in fp32_rows),
              min_one_pass_f64_rel=min(r["fp32"]["one_pass_f64_rel"] for r in fp32_rows),
              sass_hgmma=report["sass_tf32x3"]["HGMMA"], spill_bytes=report["sass_tf32x3"]["spill_bytes"],
              pool4=pool4_entry(report, "fp32")),
        simt_entry(),
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
              simt_onehot_ms=_weighted(conv0, "bf16", "simt_onehot_ms"), launches_pipeline=pipe_launches("codes")),
        gblinear_cd_entry(report["train"], report["multiprocess"]["train"]),
        gblinear_round_entry(report["train"]),
        *gblinear_block_entries(report["train"], report["multiprocess"]["train"]),
        *(fc1_entry(report, route) for route in fc1.ROUTES),
        fc1_split_entry(report),
    ], "layers": [
        {"layer": r["layer"], "N": r["N"], "L": r["L"], "Cin": r["Cin"], "Cout": r["Cout"], "pool": r["pool"],
         "launches_per_chunk": r["launches_per_chunk"],
         **{f"{t}_{k}": r[t][k] for t in ("fp32", "bf16") for k in ("route", "ms", "plain_ms", "library_ms", "bound_ms",
                                                                     "bound_by", "max_abs_err")},
         **({"fp32_simt_ms": r["fp32"]["simt_ms"], "fp32_ffma_bound_ms": r["fp32"]["ffma_bound_ms"],
             "fp32_f64_rel": r["fp32"]["f64_rel"]} if "simt_ms" in r["fp32"] else {}),
         **({"bf16_simt_ms": r["bf16"]["simt"]["ms"]} if "simt" in r["bf16"] else {}),
         **({"bf16_simt_onehot_ms": r["bf16"]["simt_onehot_ms"], "fp32_simt_onehot_ms": r["fp32"]["simt_onehot_ms"]}
            if "simt_onehot_ms" in r["bf16"] else {})}
        for r in conv0 + conv8],
        "h5_layers": [{k: r[k] for k in ("layer", "N", "L", "Cin", "Cout", "pool", "launches_per_chunk")}
                      | {f"{t}_{k}": r[t][k] for t in ("fp32", "bf16") for k in ("route", "ms", "max_abs_err")}
                      for r in report["h5_layers"]],
        "gene_layers": [{k: r[k] for k in ("layer", "N", "L", "Cin", "Cout", "pool", "launches_per_chunk")}
                        | {f"{t}_{k}": r[t][k] for t in ("fp32", "bf16")
                           for k in ("route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                        for r in report["gene_layers"]],
        "consensus_layers": [{k: r[k] for k in ("case", "layer", "N", "L", "Cin", "Cout", "pool", "launches_per_chunk")}
                             | {f"{t}_{k}": r[t].get(k) for t in ("fp32", "bf16")
                                for k in ("route", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                             for r in report["consensus_layers"]]}
    checked = report["bench"]["shape_checks"]
    for k in table["kernels"]:
        k["launches_bench"] = launches_bench[k["name"]]
        if k["name"] in checked:
            k["max_abs_err"] = max(k["max_abs_err"], checked[k["name"]]["max_abs_err"])
            k["shapes_bench"] = checked[k["name"]]["shapes"]
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report to DIR/chip_smoke.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-worker", default=None, metavar="STATS",
                    help="run as one rank of a multi-process group (under torchrun): '-- -m <module> <arguments>' "
                         "as python -m runs it, the launch counts written to STATS.rank<r>.json")
    ap.add_argument("--identity-all-reduce", action="store_true",
                    help="with --rank-worker: each rank keeps its local sums (a planted fault)")
    ap.add_argument("cli_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cli_args[:1] == ["--"]:
        args.cli_args = args.cli_args[1:]
    if args.rank_worker:
        return rank_worker(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from expecto_tpu_torch.ops import cuda_build, fc1

    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "seed": args.seed}
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    _count_standalone_pools()
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
    ptxas = built["conv8_relu_tf32x3"][1] if "conv8_relu_tf32x3" in built else cuda_build.ptxas_report("conv8_relu_tf32x3")
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas)]
    report["sass_tf32x3"] = {"HGMMA": cuda_build.sass_count("conv8_relu_tf32x3", "HGMMA"), "spill_bytes": sum(spills)}
    log(f"csrc/conv8_relu_tf32x3.cu SASS: {report['sass_tf32x3']['HGMMA']} HGMMA instructions; ptxas: "
        f"{report['sass_tf32x3']['spill_bytes']} bytes of spills in {len(spills) // 2} functions")
    if report["sass_tf32x3"]["HGMMA"] == 0 or sum(spills) or not spills:
        raise AssertionError(f"the tf32x3 kernel's SASS must hold HGMMA and its ptxas report no spill: "
                             f"{report['sass_tf32x3']}, spills {spills}")
    sass = {op: cuda_build.sass_count("conv8_relu", op) for op in ("FFMA", "LDS", "HMMA", "HGMMA")}
    report["sass_simt"] = sass
    log(f"csrc/conv8_relu.cu SASS: {sass['FFMA']} FFMA, {sass['LDS']} LDS ({sass['FFMA'] / max(1, sass['LDS']):.1f} "
        f"FFMA per LDS), {sass['HMMA']} HMMA, {sass['HGMMA']} HGMMA")
    if sass["FFMA"] == 0 or sass["HMMA"] or sass["HGMMA"]:
        raise AssertionError(f"the SIMT kernel's SASS must hold FFMA and no tensor-core instruction: {sass}")
    report["sass_fc1_hgmma"] = {route: cuda_build.sass_count(fc1.KERNELS[route], "HGMMA") for route in fc1.ROUTES}
    log(f"csrc/fc1_strided_*.cu SASS: HGMMA instructions {report['sass_fc1_hgmma']}")
    if not all(report["sass_fc1_hgmma"].values()):
        raise AssertionError(f"an fc1 kernel's SASS holds no HGMMA (tensor-core) instruction: "
                             f"{report['sass_fc1_hgmma']}")
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
    eff32, sed_table = h5_contract_phase(report, inputs, card)
    log(f"h5 contract phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    make_gene_inputs(args.seed)  # before the entry phase, which reads their geneanno.csv
    log(f"gene inputs {time.perf_counter() - t0:.1f} s (not in the gene phase's wall)")
    t0 = time.perf_counter()
    entry_exit_phase(report, inputs, eff32, sed_table, card, args.seed)
    del eff32, sed_table
    log(f"entry and exit phase {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    gene_phase(report, card)
    log(f"gene phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    consensus_phase(report, card, args.seed)
    log(f"consensus phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pipeline_phase(report, card, args.seed)
    log(f"pipeline phase {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    k1_model = train_phase(report, card, args.seed)
    log(f"train phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    analysis_phase(report, card, args.seed, k1_model)
    log(f"analysis phase {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    multiprocess_phase(report, inputs, card)
    log(f"multi-process phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench_phase(report, card)
    log(f"bench phase {time.perf_counter() - t0:.1f} s [{card}]")
    fc1_phase(report, card)
    t0 = time.perf_counter()
    pool_phase(report, card, args.seed)
    log(f"pool phase {time.perf_counter() - t0:.1f} s [{card}]")

    table = kernel_table(report)
    report["total_s"] = time.perf_counter() - t_start
    log(f"chip_smoke.py: every phase passed in {report['total_s']:.1f} s [{card}]")
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
