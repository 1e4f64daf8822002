"""Gene-level features on one device (port of expecto_tpu/pipeline/features.py;
reference compute_expecto_features.py, hot path #2, and
replicate_expecto_features.py).

Per gene: 200 strand-oriented 2,000-bp windows at shifts
range(-20000, 20000, 200) around the representative TSS, Beluga forward with
forward/RC averaging on the device, then the (no-floor) decay projection
into 20,020 features.

A gene's 200 windows overlap by 90 % (200-bp stride on 2,000-bp windows), so
the host fetches one contiguous 41,800-bp span per gene and the runner's
span forward (ops/spans.py) shares the conv stack across its windows. Genes
are grouped by the window-offset signature of their strand and their spans
fetched lazily, one block at a time.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import pandas as pd

from ..analysis.atac import apply_peak_mask, get_atac_peak_bins
from ..genome.fasta import FastaIndex
from ..genome.windows import gene_shift_window_bounds, gene_shifts
from ..ops.decay import gene_pos_weights, project_features
from ..parallel.runner import BelugaRunner


def gene_window_codes(
    genome: FastaIndex,
    chrom: str,
    tss: int,
    strand: int,
    *,
    windowsize: int = 2000,
) -> np.ndarray:
    """(200, windowsize) int8 codes for one gene's shift windows, equal to
    per-shift ``genome.sequence`` fetches with the reference window math
    (compute_expecto_features.py:108-110). Out-of-contig positions encode as
    N (zero one-hot)."""
    starts = [gene_shift_window_bounds(tss, strand, s, windowsize)[0] for s in gene_shifts()]
    return genome.window_codes(chrom, starts, windowsize)


@dataclass
class GeneRecord:
    gene_id: str
    chrom: str
    tss: int
    strand: int  # +1 / -1


def records_from_geneanno(geneanno: pd.DataFrame, tss_col: str = "CAGE_representative_TSS") -> list[GeneRecord]:
    return [
        GeneRecord(
            gene_id=row["id"],
            chrom=row["seqnames"],
            tss=int(row[tss_col]),
            strand=1 if row["strand"] == "+" else -1,
        )
        for _, row in geneanno.iterrows()
    ]


def gene_span_and_offsets(
    genome: FastaIndex,
    chrom: str,
    tss: int,
    strand: int,
    *,
    windowsize: int = 2000,
):
    """(span_codes, window offsets) for one gene, the input of the span
    forward (ops/spans.py): the window at ``offsets[i]`` is
    ``gene_shift_window_bounds(tss, strand, gene_shifts()[i])``. Minus-strand
    offsets run downward."""
    starts = [gene_shift_window_bounds(tss, strand, s, windowsize)[0] for s in gene_shifts()]
    lo = min(starts)
    span_len = max(starts) - lo + windowsize
    span = genome.window_codes(chrom, [lo], span_len)[0]
    return span, tuple(st - lo for st in starts)


def _offset_groups(genes: list[GeneRecord], shifts: list[int], windowsize: int) -> dict[tuple, list[int]]:
    """{window-offset signature: gene indices}. An offset is window_start -
    min(starts), so the TSS cancels and the signature depends on the strand
    alone; grouping needs no genome fetch."""
    groups: dict[tuple, list[int]] = {}
    for j, g in enumerate(genes):
        starts = [gene_shift_window_bounds(g.tss, g.strand, s, windowsize)[0] for s in shifts]
        lo = min(starts)
        groups.setdefault(tuple(st - lo for st in starts), []).append(j)
    return groups


def compute_gene_features(
    genes: list[GeneRecord],
    genome: FastaIndex,
    runner: BelugaRunner,
    *,
    windowsize: int = 2000,
    out_path: str | os.PathLike | None = None,
    genes_per_chunk: int | None = None,
    progress: bool = False,
) -> np.ndarray:
    """(n_genes, 20020) decay-projected features
    (compute_expecto_features.py:103-128).

    Genes are grouped by strand (the window-offset signature) and each group
    runs through ``runner.predict_spans_project`` a block at a time: spans
    are fetched per block (about 42 KB a gene), not for the whole gene list.
    ``genes_per_chunk`` sets the block (default: 16 of the runner's device
    chunks, at least 64 genes); it changes host memory, not the result."""
    shifts = gene_shifts()
    pos_weights = gene_pos_weights(shifts)  # (10, 200)
    features = np.empty((len(genes), pos_weights.shape[0] * 2002), dtype=np.float32)
    block = genes_per_chunk or max(16 * runner._span_rows(len(shifts)), 64)
    done = 0
    for offsets, idxs in _offset_groups(genes, shifts, windowsize).items():
        for bstart in range(0, len(idxs), block):
            bidx = idxs[bstart : bstart + block]
            spans = np.stack([
                gene_span_and_offsets(genome, genes[j].chrom, genes[j].tss, genes[j].strand, windowsize=windowsize)[0]
                for j in bidx
            ])
            features[bidx] = runner.predict_spans_project(spans, offsets, pos_weights)
            done += len(bidx)
            if progress:
                print(f"gene features: {done}/{len(genes)} genes", file=sys.stderr, flush=True)
    if out_path is not None:
        np.save(out_path, features)
    return features


def compute_gene_features_atac(
    genes: list[GeneRecord],
    genome: FastaIndex,
    runner: BelugaRunner,
    peaks_by_chrom: dict,
    chip_track_indices: np.ndarray,
    *,
    windowsize: int = 2000,
    out_path: str | os.PathLike | None = None,
    progress: bool = False,
) -> np.ndarray:
    """ATAC x predicted-ChIP intersect features (reference
    expecto_intersect_chip_atac.py:73-107): per gene, the fwd/RC-averaged
    per-shift predictions have their TF/Histone tracks multiplied by the
    binary DeepSEA-style peak-bin mask before the decay projection.

    The mask is the same for both orientations, so masking the device's
    average equals the reference's mask-then-average."""
    shifts = gene_shifts()
    pos_weights = gene_pos_weights(shifts)
    features = np.empty((len(genes), pos_weights.shape[0] * 2002), dtype=np.float32)
    for i, g in enumerate(genes):
        span, offsets = gene_span_and_offsets(genome, g.chrom, g.tss, g.strand, windowsize=windowsize)
        preds = runner.predict_span_codes(span[None], offsets, rc_mode="average")[0].astype(np.float32)
        binned = get_atac_peak_bins(g.chrom, g.tss, g.strand, peaks_by_chrom, n_bins=len(shifts))
        preds = apply_peak_mask(preds, binned, chip_track_indices)
        features[i] = project_features(pos_weights, preds[:, None, :])[0]
        if progress:
            print(f"ATAC gene features: {i + 1}/{len(genes)} genes", file=sys.stderr, flush=True)
    if out_path is not None:
        np.save(out_path, features)
    return features


def replicate_gene_features(
    genes: list[GeneRecord],
    genome: FastaIndex,
    runner: BelugaRunner,
    *,
    windowsize: int = 2000,
    out_dir: str | os.PathLike | None = None,
) -> dict[str, np.ndarray]:
    """Raw per-gene (200, 2002) fwd/RC-averaged prediction matrices without
    projection (reference replicate_expecto_features.py:16-92), the input to
    SVD/clustering; with ``out_dir``, one fp32 ``{gene_id}.npy`` per gene."""
    out: dict[str, np.ndarray] = {}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    for g in genes:
        codes = gene_window_codes(genome, g.chrom, g.tss, g.strand, windowsize=windowsize)
        # fp32 on disk whatever the runner's wire dtype (the reference
        # replicator saves fp32 npy; SVD/clustering consumers expect it)
        preds = runner.predict_codes(codes, average_rc=True).astype(np.float32, copy=False)
        out[g.gene_id] = preds
        if out_dir is not None:
            np.save(os.path.join(out_dir, f"{g.gene_id}.npy"), preds)
    return out
