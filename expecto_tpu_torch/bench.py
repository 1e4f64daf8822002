"""Benchmark of the PyTorch/CUDA port: Beluga variant-scoring throughput on
one card against the CPU-PyTorch baseline (port of the repository's
``bench.py``, which drives the JAX package).

    python -m expecto_tpu_torch.bench [--device cuda|cpu] [--with-h5-writes]

Prints ONE JSON line on standard output:

    {"metric": "variants_per_sec_per_chip", "value": N, "unit": "variants/s",
     "vs_baseline": R, "paths": {...}, "device": {...}}

Workload (as ``bench.py``): one variant at maxshift 800 costs 36 Beluga
forwards of a 2,000-bp window (9 shifts x 2 alleles x 2 orientations).
``value`` is bf16 serving of 3,072 seeded variants against 218 seeded tissue
models through ``BelugaRunner.score_variant_spans_packed``, best of 5;
``vs_baseline`` divides it by the CPU-PyTorch baseline's windows/s over 36.
The baseline is the reference's path, an fp32 forward of the torch oracle
(``tests/torch_oracle.py``) at batch 32 on this machine's CPU, measured on
every run.

``paths`` holds the other production workloads, each a call of the port's
counterpart of the JAX call ``bench.py`` times, at ``bench.py``'s on-card
sizes and repeats:

- ``compute_ceiling_variants_per_sec``: one serving chunk (227 variants)
  whose inputs are already on the card: unpack, the span stack with the alt
  patch, REF/SED over 218 models, synchronised by a scalar fetch;
- ``genes_per_sec``: ``predict_spans_project`` on 256 seeded 41.8-kb gene
  spans (200 shifts, RC, decay projection), runner batch 3,200;
- ``indel_variants_per_sec``: ``score_variant_spans`` on 1,536 (ref, alt)
  span pairs;
- ``indel_h5_variants_per_sec``, ``sub_h5_variants_per_sec``:
  ``pipeline/chromatin.compute_variant_chromatin_effects`` on 512 variants
  of a seeded 2-Mb genome, no files written;
- ``consensus_sample_genes_per_sec``: ``_predict_consensus_preds`` on 445
  records sharing 42 sites; ``consensus_private_sample_genes_per_sec`` on
  64 records with 42 private sites each;
- ``consensus_private_featonly_sample_genes_per_sec`` and
  ``consensus_sparse_private_featonly_sample_genes_per_sec``:
  ``_predict_consensus_features_cohort`` on 64 records with 42 and with 4
  private sites;
- ``train_ms_per_round_256models``: ms a warm round of the K-model gblinear
  sweep (``models/gblinear.multi_round``) at 18,000 x 20,020 x 256 models,
  fp32, 10 rounds after 3.

``--with-h5-writes`` adds ``sub_h5_write_variants_per_sec`` and
``legacy_h5_write_variants_per_sec``, the streaming h5 path writing real
files (needs h5py, which it imports first and which must be there).

Every path runs on ``bench.py``'s runner configuration: bf16 compute, fp16
wire, ``pipeline_depth=6``; the workload generators are copies of
``bench.py``'s, with the same seeds and calls, so the arrays are the same.
The weights are ``torch.manual_seed(0)``'s ``TorchBeluga()`` carried through
``models/convert.state_dict_to_params``, the weights ``bench.py`` serves.
``--device cpu`` takes ``bench.py``'s off-card sizes (4 variants, 2 genes,
...): a rehearsal whose numbers mean nothing. The default device is
``cuda``, which raises without a GPU.

Left out of ``bench.py`` on purpose: the relay probe and the XLA compile
cache (TPU-only), and the watchdog, the time boxes and the blanket
``except``: a path that fails raises, the process exits non-zero and no
result line is printed. Numbers are printed unrounded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from .genome.fasta import FastaIndex, write_fasta
from .genome.windows import gene_shifts, variant_shifts
from .models.convert import state_dict_to_params
from .models.gblinear import GBLinearParams, multi_round, multi_state
from .ops.decay import gene_pos_weights, variant_basis
from .parallel.runner import BelugaRunner, resolve_device, unpack_codes2
from .pipeline.chromatin import compute_variant_chromatin_effects
from .pipeline.consensus import ENFORMER_SEQ_LENGTH, _predict_consensus_features_cohort, _predict_consensus_preds

WINDOWS_PER_VARIANT = 36
REPO = Path(__file__).resolve().parents[1]
#: windows of the CPU baseline's timed pass (bench.py's default)
BASELINE_WINDOWS = 96
MAXSHIFT = 800
N_MODELS = 218

PATH_KEYS = (
    "compute_ceiling_variants_per_sec",
    "genes_per_sec",
    "indel_variants_per_sec",
    "indel_h5_variants_per_sec",
    "sub_h5_variants_per_sec",
    "consensus_sample_genes_per_sec",
    "consensus_private_sample_genes_per_sec",
    "consensus_private_featonly_sample_genes_per_sec",
    "consensus_sparse_private_featonly_sample_genes_per_sec",
    "train_ms_per_round_256models",
)
H5_WRITE_KEYS = ("sub_h5_write_variants_per_sec", "legacy_h5_write_variants_per_sec")


@dataclass(frozen=True)
class Sizes:
    """Workload sizes: ``bench.py``'s on-card sizes, or its off-card ones."""

    variants: int
    genes: int
    indels: int
    h5_variants: int
    h5_repeats: int
    h5_write_repeats: int
    shared_samples: int
    private_samples: int
    train: tuple  # (n, f, k, rounds)


ON_CARD = Sizes(3072, 256, 1536, 512, 3, 2, 445, 64, (18000, 20020, 256, 10))
OFF_CARD = Sizes(4, 2, 2, 2, 1, 1, 6, 4, (64, 128, 4, 2))


# ---- workload generators (copies of bench.py's) ------------------------------


def _variant_workload(n_variants: int, maxshift: int, n_models: int):
    shifts = variant_shifts(maxshift)
    offsets = tuple(s + maxshift for s in shifts)
    span_len = 2 * maxshift + 2000
    rng = np.random.default_rng(0)
    mutpos = maxshift + 999
    # uniform ACGT with rare Ns (they ride the 2-bit packing's sideband)
    ref_spans = rng.integers(0, 4, size=(n_variants, span_len), dtype=np.int8)
    n_mask = rng.random(ref_spans.shape) < 1e-3
    ref_spans[n_mask] = 4
    alt_alleles = ((ref_spans[:, mutpos] + 1) % 4).astype(np.int8)[:, None]
    dists = rng.integers(-20000, 20000, size=n_variants)
    strands = rng.choice(["+", "-"], size=n_variants)
    basis = variant_basis(dists, strands, shifts).astype(np.float32)
    W = (rng.standard_normal((20020, n_models)) * 0.01).astype(np.float32)
    bias = np.zeros(n_models, np.float32)
    return ref_spans, mutpos, alt_alleles, offsets, span_len, basis, W, bias


def _gene_workload(n_genes: int):
    """(spans, offsets, pos_weights) of ``n_genes`` seeded 41.8-kb gene spans."""
    shifts = gene_shifts()
    offsets = tuple(range(0, 200 * len(shifts), 200))
    span_len = offsets[-1] + 2000
    pos_weights = gene_pos_weights(shifts)
    rng = np.random.default_rng(1)
    spans = rng.integers(0, 4, size=(n_genes, span_len), dtype=np.int8)
    return spans, offsets, pos_weights


def _h5_genome():
    """The h5 path's seeded 2-Mb contig and its generator, ready to draw the
    variant positions."""
    rng = np.random.default_rng(2)
    contig_len = 2_000_000
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, contig_len)].tobytes().decode("latin-1")
    return seq, rng


def _h5_vcf(seq: str, rng, n_variants: int, variant_class: str, maxshift: int = MAXSHIFT):
    """The h5 path's VCF table: substitutions to the complement, or
    alternating +2 insertions and -3 deletions."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    lo, hi = maxshift + 1100, len(seq) - maxshift - 1200
    positions = rng.integers(lo, hi, size=n_variants)
    rows = []
    for i, pos in enumerate(positions):
        pos = int(pos)
        if variant_class == "sub":
            rows.append(["chr1", pos, ".", seq[pos - 1], comp[seq[pos - 1]]])
        elif i % 2:  # insertion (+2)
            rows.append(["chr1", pos, ".", seq[pos - 1], seq[pos - 1] + "AG"])
        else:  # deletion (-3)
            rows.append(["chr1", pos, ".", seq[pos - 1 : pos + 3], seq[pos - 1]])
    return pd.DataFrame(rows)


def _consensus_cohort_seqs(n_samples: int, *, private: bool, n_sites: int = 42):
    """Synthetic GEUVADIS cohort for one gene. ``private=False``: biallelic
    SNPs at shared segregating sites; ``private=True``: every sample mutates
    its own ``n_sites`` random positions."""
    rng = np.random.default_rng(3)
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


def _train_workload(n: int, f: int, k: int):
    """The training path's seeded (n, f) features and (n, k) labels."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, f)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32) + 2.0
    return X, Y


# ---- paths ---------------------------------------------------------------------


@dataclass
class TimedPath:
    """One timed path: ``warm()`` once, then ``call()`` ``repeats`` times;
    the rate is ``items`` over the best call's wall. Both return what the
    port computed, so a test can hold it against the JAX package."""

    warm: object
    call: object
    items: int
    repeats: int = 3


def best_rate(path: TimedPath) -> float:
    """``path.items`` per second of the fastest of ``path.repeats`` calls,
    after one warm call. Every call returns host arrays or a fetched
    scalar, so it has finished on the device when it returns."""
    path.warm()
    best = 0.0
    for _ in range(path.repeats):
        t0 = time.perf_counter()
        path.call()
        best = max(best, path.items / (time.perf_counter() - t0))
    return best


def serving_path(runner: BelugaRunner, work) -> TimedPath:
    """bf16 SED serving of every variant of ``work``, best of 5 (bench.py's
    headline)."""
    ref_spans, mutpos, alt_alleles, offsets, _span_len, basis, W, bias = work
    k = min(64, ref_spans.shape[0])
    return TimedPath(
        warm=lambda: runner.score_variant_spans_packed(ref_spans[:k], mutpos, alt_alleles[:k], offsets,
                                                       basis[:, :k], W, bias),
        call=lambda: runner.score_variant_spans_packed(ref_spans, mutpos, alt_alleles, offsets, basis, W, bias),
        items=ref_spans.shape[0], repeats=5)


def ceiling_path(runner: BelugaRunner, work) -> TimedPath:
    """One serving chunk with every input already on the device: the 2-bit
    unpack and the runner's serving chunk (``_score_spans_chunk``: the span
    stack with the alt patch, REF/SED over every model), the chain the JAX
    runner jits as ``_score_spans_packed2``; a scalar fetch ends each call.
    The chunk is the runner's serving chunk (``_span_rows``), or every
    variant when there are fewer."""
    ref_spans, mutpos, alt_alleles, offsets, span_len, basis, W, bias = work
    rows = min(runner._span_rows(len(offsets)), ref_spans.shape[0])
    bits, wire = runner._chunk_wire(ref_spans[:rows])
    if bits != 2:
        raise ValueError("the ceiling chunk is too N-dense for the 2-bit wire")
    p, rl, cl = (runner._up(a) for a in wire)
    alt_a = runner._up(alt_alleles[:rows])
    basis_t = runner._up(np.ascontiguousarray(basis[:, :rows]).astype(runner._basis_wire_dtype))
    W_dev, bias_dev = runner._model_tensors(W, bias)

    @torch.inference_mode()
    def call():
        out = runner._score_spans_chunk(unpack_codes2(p, span_len, rl, cl), alt_a, basis_t, W_dev, bias_dev,
                                        offsets, span_len, int(mutpos))
        out[0][0, 0].item()  # a scalar fetch: the chunk has finished
        return out

    return TimedPath(warm=call, call=call, items=rows)


def gene_path(runner: BelugaRunner, n_genes: int) -> TimedPath:
    """Gene features of ``n_genes`` seeded 41.8-kb spans (200 shifts, RC,
    decay projection on the device)."""
    spans, offsets, pos_weights = _gene_workload(n_genes)
    return TimedPath(
        warm=lambda: runner.predict_spans_project(spans[: max(n_genes // 4, 1)], offsets, pos_weights),
        call=lambda: runner.predict_spans_project(spans, offsets, pos_weights), items=n_genes)


def indel_path(runner: BelugaRunner, work, n_variants: int) -> TimedPath:
    """Pair serving of ``n_variants`` (ref, alt) spans; the alt span is the
    ref span rolled by 2 (same cost as a real crop-shifted indel span)."""
    ref_spans, _mutpos, _alt, offsets, _span_len, basis, W, bias = work
    ref = ref_spans[:n_variants]
    basis_n = np.ascontiguousarray(basis[:, :n_variants])
    alt = np.roll(ref, 2, axis=1)
    k = min(64, n_variants)
    return TimedPath(
        warm=lambda: runner.score_variant_spans(ref[:k], alt[:k], offsets, basis_n[:, :k], W, bias),
        call=lambda: runner.score_variant_spans(ref, alt, offsets, basis_n, W, bias), items=n_variants)


def h5_rate(runner: BelugaRunner, *, n_variants: int, variant_class: str, repeats: int, write_h5: bool = False,
            legacy_only: bool = False) -> float:
    """Variants/s of ``compute_variant_chromatin_effects`` on the seeded
    genome (written to a temporary directory): in memory, or with
    ``write_h5`` the streaming path landing the per-shift h5 files there
    (``legacy_only``: the diff-only legacy schema)."""
    seq, rng = _h5_genome()
    with tempfile.TemporaryDirectory() as td:
        write_fasta(os.path.join(td, "g.fa"), {"chr1": seq})
        genome = FastaIndex(os.path.join(td, "g.fa"))
        try:
            vcf = _h5_vcf(seq, rng, n_variants, variant_class)
            out_dir = os.path.join(td, "h5out") if write_h5 else None
            kw = dict(maxshift=MAXSHIFT, verbose=False, legacy_only=legacy_only)
            return best_rate(TimedPath(
                warm=lambda: compute_variant_chromatin_effects(vcf.iloc[: min(8, n_variants)], genome, runner,
                                                               out_dir, **kw),
                call=lambda: compute_variant_chromatin_effects(vcf, genome, runner, out_dir, **kw),
                items=n_variants, repeats=repeats))
        finally:
            genome.close()


def consensus_path(runner: BelugaRunner, n_samples: int, *, private: bool) -> TimedPath:
    """Track predictions of a cohort (``_predict_consensus_preds``, fp16
    fetch)."""
    seqs = _consensus_cohort_seqs(n_samples, private=private)
    return TimedPath(
        warm=lambda: _predict_consensus_preds(runner, seqs[:8], None, dtype=np.float16),
        call=lambda: _predict_consensus_preds(runner, seqs, None, dtype=np.float16), items=n_samples)


def featonly_path(runner: BelugaRunner, n_samples: int, n_sites: int) -> TimedPath:
    """Features of a private cohort (``_predict_consensus_features_cohort``)."""
    seqs = _consensus_cohort_seqs(n_samples, private=True, n_sites=n_sites)
    return TimedPath(
        warm=lambda: _predict_consensus_features_cohort(runner, seqs[:8], None),
        call=lambda: _predict_consensus_features_cohort(runner, seqs, None), items=n_samples)


#: the training path's hyperparameters (bench.py's: the defaults, fp32 with
#: TF32 off); the round count is the caller's
TRAIN_HP = GBLinearParams(num_round=1)


def train_ms_per_round(device, *, n: int, f: int, k: int, rounds: int) -> float:
    """Warm ms a round of the K-model sweep (``multi_round`` on
    ``multi_state``): 3 rounds, then ``rounds`` timed, each ending with the
    bias fetched."""
    state = multi_state(*_train_workload(n, f, k), None, TRAIN_HP, torch.device(device))
    for _ in range(3):
        multi_round(TRAIN_HP, state)
    state.bias.cpu()
    t0 = time.perf_counter()
    for _ in range(rounds):
        multi_round(TRAIN_HP, state)
    state.bias.cpu()
    return (time.perf_counter() - t0) / rounds * 1000.0


# ---- weights and the CPU baseline ----------------------------------------------


def _oracle():
    """``tests/torch_oracle.py``'s ``TorchBeluga``, the reference's
    architecture in plain torch (imported by path, as ``bench.py`` does)."""
    if str(REPO / "tests") not in sys.path:
        sys.path.insert(0, str(REPO / "tests"))
    from torch_oracle import TorchBeluga

    return TorchBeluga


def build_weights() -> tuple[dict, dict]:
    """(reference-keyed state dict, npz-layout params) of
    ``torch.manual_seed(0)``'s ``TorchBeluga()``: the weights ``bench.py``
    serves, carried through the port's converter."""
    torch.manual_seed(0)
    state_dict = _oracle()().eval().state_dict_reference_keys()
    return state_dict, state_dict_to_params(state_dict)


def measure_cpu_torch_windows_per_sec(state_dict, *, n_windows: int, batch: int = 32, repeats: int = 3) -> float:
    """The reference's CPU path: the torch oracle's fp32 forward at batch 32
    on ``state_dict``, best of ``repeats`` passes over ``n_windows``
    windows."""
    net = _oracle()().eval()
    mapping = {
        "model.0.0": "conv.0", "model.0.2": "conv.2", "model.0.6": "conv.5",
        "model.0.8": "conv.7", "model.0.12": "conv.10", "model.0.14": "conv.12",
        "model.1.2.1": "fc1", "model.1.4.1": "fc2",
    }
    renamed = {}
    for key, v in state_dict.items():
        stem, leaf = key.rsplit(".", 1)
        renamed[mapping[stem] + "." + leaf] = v
    net.load_state_dict(renamed)
    x = torch.randn(n_windows, 4, 1, 2000)
    with torch.no_grad():
        net(x[:4])  # warm-up
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for i in range(0, n_windows, batch):
                net(x[i : i + batch])
            best = min(best, time.perf_counter() - t0)
    return n_windows / best


# ---- the run -------------------------------------------------------------------


def make_runner(params, device, *, batch_size: int) -> BelugaRunner:
    """``bench.py``'s runner configuration: bf16 compute, fp16 wire, depth 6."""
    return BelugaRunner(params, batch_size=batch_size, device=device, compute_dtype=torch.bfloat16,
                        out_dtype=np.float16, pipeline_depth=6)


def _device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device), "count": torch.cuda.device_count()}
    return {"type": device.type, "name": "cpu", "count": 1}


def run(device, *, with_h5_writes: bool = False) -> dict:
    """Every path on ``device``; returns the result record. Raises on the
    first path that fails."""
    device = resolve_device(device)
    sizes = ON_CARD if device.type == "cuda" else OFF_CARD
    state_dict, params = build_weights()
    paths: dict = {}

    runner = make_runner(params, device, batch_size=2048)
    work = _variant_workload(sizes.variants, MAXSHIFT, N_MODELS)
    value = best_rate(serving_path(runner, work))
    baseline = measure_cpu_torch_windows_per_sec(state_dict, n_windows=BASELINE_WINDOWS) / WINDOWS_PER_VARIANT

    paths["compute_ceiling_variants_per_sec"] = best_rate(ceiling_path(runner, work))
    # the span runner (batch 3,200 = 16 gene spans a chunk) of the 41.8-kb
    # span paths, where the serving runner's chunks would underfill the card
    runner_spans = make_runner(params, device, batch_size=3200)
    paths["genes_per_sec"] = best_rate(gene_path(runner_spans, sizes.genes))
    paths["indel_variants_per_sec"] = best_rate(indel_path(runner, work, sizes.indels))
    for cls in ("indel", "sub"):
        paths[f"{cls}_h5_variants_per_sec"] = h5_rate(runner, n_variants=sizes.h5_variants, variant_class=cls,
                                                       repeats=sizes.h5_repeats)
    if with_h5_writes:
        for key, legacy in zip(H5_WRITE_KEYS, (False, True)):
            paths[key] = h5_rate(runner, n_variants=sizes.h5_variants, variant_class="sub",
                                 repeats=sizes.h5_write_repeats, write_h5=True, legacy_only=legacy)
    paths["consensus_sample_genes_per_sec"] = best_rate(consensus_path(runner, sizes.shared_samples, private=False))
    paths["consensus_private_sample_genes_per_sec"] = best_rate(
        consensus_path(runner, sizes.private_samples, private=True))
    paths["consensus_private_featonly_sample_genes_per_sec"] = best_rate(
        featonly_path(runner_spans, sizes.private_samples, 42))
    paths["consensus_sparse_private_featonly_sample_genes_per_sec"] = best_rate(
        featonly_path(runner_spans, sizes.private_samples, 4))
    n, f, k, rounds = sizes.train
    paths["train_ms_per_round_256models"] = train_ms_per_round(device, n=n, f=f, k=k, rounds=rounds)

    return {"metric": "variants_per_sec_per_chip", "value": value, "unit": "variants/s",
            "vs_baseline": value / baseline, "paths": paths, "device": _device_info(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu (bench.py's off-card sizes)")
    ap.add_argument("--with-h5-writes", action="store_true",
                    help="also time the two write-inclusive h5 paths (needs h5py)")
    args = ap.parse_args(argv)
    if args.with_h5_writes:
        import h5py  # noqa: F401 (the write paths need it: fail before any measurement)
    record = run(args.device, with_h5_writes=args.with_h5_writes)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
