"""Variant span assembly on the host (port of the span helpers of
expecto_tpu/pipeline/chromatin.py).

The 9 shift windows of one allele overlap by up to 90%; one spliced
2*maxshift+2000 bp span is built per allele and the conv stack runs once
over it (ops/spans.py). Indels ride the same spans: the reference's
splice-then-center-crop shifts every shift window's crop start by the same
(100+dL)//2, so the alt windows are slices of ONE crop-adjusted alt span at
the ref offsets. Variants whose windows cross a contig edge, or whose length
change exceeds the crop slack, are not span-eligible and take the
per-window path (pipeline/sed.py).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..genome.encode import alleles_to_flat_codes


def _scatter_alleles(spans: np.ndarray, row_idx, codes_flat: np.ndarray, lens: np.ndarray, start_cols) -> None:
    """Splice variable-length allele codes into
    ``spans[row_idx[i], start_cols[i] : start_cols[i] + lens[i]]`` with one
    scatter; columns outside the span are dropped (the window path's
    center-crop discards them too)."""
    if codes_flat.size == 0:
        return
    rows = np.repeat(np.asarray(row_idx, np.int64), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(codes_flat.size) - np.repeat(offs, lens) + np.repeat(np.asarray(start_cols, np.int64), lens)
    keep = (cols >= 0) & (cols < spans.shape[1])
    spans[rows[keep], cols[keep]] = codes_flat[keep].astype(np.int8)


def _gather_spans(genome, chroms: np.ndarray, starts_1based: np.ndarray, span_len: int) -> np.ndarray:
    """One vectorized window_codes gather per chromosome -> (n, span_len)."""
    out = np.empty((len(starts_1based), span_len), dtype=np.int8)
    for chrom in dict.fromkeys(chroms.tolist()):
        m = chroms == chrom
        out[m] = genome.window_codes(chrom, starts_1based[m], span_len)
    return out


def _require_known_chromosomes(genome, chroms) -> None:
    """Raise one clear ValueError listing every VCF chromosome absent from
    the FASTA (instead of a raw KeyError deep in the window fetch — which,
    in a distributed run, would kill only the host owning the row and hang
    the rest at the next barrier)."""
    missing = sorted({c for c in dict.fromkeys(np.asarray(chroms).tolist()) if c not in genome})
    if missing:
        raise ValueError(
            f"chromosome(s) {missing} not present in the genome FASTA; "
            "check the VCF's contig naming (chr-prefix?) against the FASTA"
        )


def _span_eligible(genome, chroms, positions, refs, alts, maxshift, inputsize) -> np.ndarray:
    """Per-variant mask: True where the span fast path reproduces the
    reference's fetch+splice+crop semantics exactly — every uncropped
    per-shift window lies fully inside the contig (a clamped fetch makes the
    reference splice at a shifted site and crop a shorter window,
    chromatin.py:205-209 + expecto_utils.py:31, which only the per-window
    path reproduces) and the allele length change fits the crop arithmetic:
    dL < -100 drops the crop start below zero; a huge insertion would push
    it past the span. The ref allele must also fit inside every uncropped
    fetch window: at shift s the allele starts at column half_w1 - s of the
    (inputsize+100)-long window, so the spliced window length is exactly
    inputsize+100+dL only when len(ref) <= inputsize+100-half_w1-maxshift
    (251 bp at the defaults); a longer allele overruns the most-upstream
    shift's window, the reference truncates the splice there, and the crop
    start diverges from the span path's uniform (100+dL)//2."""
    half_w1 = (inputsize + 100) // 2 - 1
    positions = np.asarray(positions, dtype=np.int64)
    _, ref_lens = alleles_to_flat_codes(refs)
    _, alt_lens = alleles_to_flat_codes(alts)
    dL = alt_lens - ref_lens
    chroms = np.asarray(chroms)
    contig_len = {c: (genome.contig_length(c) if c in genome else -1) for c in dict.fromkeys(chroms.tolist())}
    clens = pd.Series(chroms).map(contig_len).to_numpy(np.int64)
    return (
        (dL >= -100)
        & (dL <= 2 * maxshift + inputsize - 200)
        & (ref_lens <= inputsize + 100 - half_w1 - maxshift)
        & (positions - maxshift - half_w1 >= 1)
        & (positions + maxshift + half_w1 + 1 <= clens)
    )


def assemble_variant_spans(
    genome, chroms, positions, refs, alts, maxshift: int, inputsize: int = 2000
) -> tuple[np.ndarray, np.ndarray]:
    """Build one spliced (ref, alt) span pair per span-eligible variant; the
    2,000-bp window of shift ``s`` is span[s + maxshift : +inputsize] for
    BOTH alleles.

    Substitutions share one genome gather per variant, each allele spliced
    at ``mutpos``. Indels follow the reference's splice-then-center-crop
    arithmetic (chromatin.py:209 + expecto_utils.py:31): the uncropped alt
    window of every shift is 2100+dL long and cropped from column
    ``c = (100+dL)//2``, so the cropped alt windows of ALL shifts are slices
    of one "cropped alt span" — (left genome | alt | right genome) shifted
    by ``c`` — at the SAME offsets as the ref span. Both alleles therefore
    ride one batched span kernel; per-variant cost equals the substitution
    path's. Host assembly is fully vectorized: one ``window_codes`` gather
    per chromosome per piece plus one allele scatter (no per-variant Python
    loop).
    """
    n = len(chroms)
    half = inputsize // 2 - 1              # bases left of `pos` in a cropped window
    half_w1 = (inputsize + 100) // 2 - 1   # ... in the uncropped fetch window
    span_len = 2 * maxshift + inputsize
    mutpos = maxshift + half  # 0-based index of `pos` within the ref span

    positions = np.asarray(positions, dtype=np.int64)
    chroms = np.asarray(chroms)
    ref_codes, ref_lens = alleles_to_flat_codes(refs)
    alt_codes, alt_lens = alleles_to_flat_codes(alts)
    dL = alt_lens - ref_lens
    rows = np.arange(n)

    ref_spans = _gather_spans(genome, chroms, positions - maxshift - half, span_len)
    _scatter_alleles(ref_spans, rows, ref_codes, ref_lens, np.full(n, mutpos))

    alt_spans = np.empty((n, span_len), dtype=np.int8)
    alt_start = np.full(n, mutpos, np.int64)
    is_sub = dL == 0
    if is_sub.any():
        alt_spans[is_sub] = ref_spans[is_sub]
    ind = np.nonzero(~is_sub)[0]
    if ind.size:
        # crop start of the (2100+dL)-long uncropped alt window; the left
        # genome piece covers cropped columns [0, left_len), the alt allele
        # [left_len, left_len+len(alt)), the post-splice genome the rest
        c = (100 + dL[ind]) // 2
        left_len = (maxshift + half_w1) - c
        left = _gather_spans(genome, chroms[ind], positions[ind] - maxshift - half_w1 + c, span_len)
        right = _gather_spans(
            genome, chroms[ind], positions[ind] + ref_lens[ind] - left_len - alt_lens[ind], span_len
        )
        cols = np.arange(span_len)[None, :]
        alt_spans[ind] = np.where(cols < left_len[:, None], left, right)
        alt_start[ind] = left_len
    _scatter_alleles(alt_spans, rows, alt_codes, alt_lens, alt_start)
    return ref_spans, alt_spans
