"""Variant chromatin-effect pipeline (port of
expecto_tpu/pipeline/chromatin.py; reference chromatin.py:243-286): the
``expecto-chromatin`` half of the h5 contract, and the span helpers of the
serving path.

For each shift in [0, ±200..±maxshift] the ref/alt windows of every variant
go through Beluga on both strands, and per-shift ``.diff.h5`` files are
written (datasets diff/ref/alt; rows [0:N] forward, [N:2N] reverse
complement).

The 9 shift windows of one allele overlap by up to 90%; one spliced
2*maxshift+2000 bp span is built per allele and the conv stack runs once
over it (ops/spans.py). Indels ride the same spans: the reference's
splice-then-center-crop shifts every shift window's crop start by the same
(100+dL)//2, so the alt windows are slices of ONE crop-adjusted alt span at
the ref offsets. Variants whose windows cross a contig edge, or whose length
change exceeds the crop slack, are not span-eligible and take the
per-window path.

One process; ``h5py`` is imported only where a file is written or read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import pandas as pd

from ..genome.encode import alleles_to_flat_codes, reverse_complement_codes, seqs_to_codes
from ..genome.windows import fetch_variant_window, variant_shifts
from ..io.h5 import write_legacy_shift_h5, write_shift_h5
from ..models.beluga import BELUGA_N_TRACKS
from ..parallel.runner import fp32_wire_kw


@dataclass
class ChromatinResult:
    shifts: list[int]
    n_variants: int
    ref_matched: int
    alt_matched: int
    #: {shift: (diff, ref, alt)} arrays of shape (2N, n_tracks); only
    #: populated when keep_arrays=True.
    arrays: dict | None = None


def _pad_allele_bytes(alleles, lens, max_len: int) -> np.ndarray:
    """(n, max_len) uppercased allele bytes, zero-padded; columns past
    ``max_len`` (insertions longer than the site window) are dropped."""
    n = len(alleles)
    cat = np.frombuffer("".join(alleles).upper().encode("latin-1"), np.uint8)
    rows = np.repeat(np.arange(n), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(cat.size) - np.repeat(offs, lens)
    out = np.zeros((n, max_len), np.uint8)
    keep = cols < max_len
    out[rows[keep], cols[keep]] = cat[keep]
    return out


def _diagnostics(genome, chroms, positions, refs, alts, inputsize, verbose):
    """Shift-0 ref/alt genome-match counts (reference chromatin.py:256-260).

    One vectorized :meth:`FastaIndex.window_bytes` gather per chromosome;
    only the ``len(ref)`` genome bases at each site are compared. Near a
    contig start the reference's window slicing reads a clamp-shifted site;
    that quirk is reproduced so counts stay bit-identical."""
    n = len(chroms)
    if n == 0:
        if verbose:
            print("Number of input variants: 0")
        return 0, 0
    windowsize = inputsize + 100
    mutpos = int(windowsize / 2 - 1)
    positions = np.asarray(positions, dtype=np.int64)
    ref_lens = np.array([len(r) for r in refs], dtype=np.int64)
    alt_lens = np.array([len(a) for a in alts], dtype=np.int64)
    max_len = max(int(ref_lens.max()), 1)

    # the reference slices the site out of the (pos+shift-centered) window;
    # a window clamped at the contig start shifts the read site to mutpos+1
    eff_starts = np.where(positions - mutpos >= 1, positions, mutpos + 1)
    site = np.zeros((n, max_len), np.uint8)
    chroms = np.asarray(chroms)
    for chrom in dict.fromkeys(chroms.tolist()):
        m = chroms == chrom
        site[m] = genome.window_bytes(chrom, eff_starts[m], max_len)
    site = np.where((site >= 97) & (site <= 122), site - 32, site)  # upper()

    # rows compare over their own allele length only; the padded tail is
    # masked. A site truncated at the contig end reads 0 there and can never
    # match (the string path's length mismatch).
    tail = np.arange(max_len)[None, :]
    ref_pad = _pad_allele_bytes(refs, ref_lens, max_len)
    alt_pad = _pad_allele_bytes(alts, alt_lens, max_len)
    ref_matched = int(((site == ref_pad) | (tail >= ref_lens[:, None])).all(axis=1).sum())
    alt_rows = ((site == alt_pad) | (tail >= alt_lens[:, None])).all(axis=1)
    # the site string has len(ref) characters; a different-length alt can
    # never equal it (indels never count as alt-matched)
    alt_matched = int((alt_rows & (alt_lens == ref_lens)).sum())
    if verbose:
        print(f"Number of variants with reference allele matched with reference genome: {ref_matched}")
        print(f"Number of variants with alternate allele matched with reference genome: {alt_matched}")
        print(f"Number of input variants: {n}")
    return ref_matched, alt_matched


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


def _run_span_path(genome, runner, chroms, positions, refs, alts, shifts, maxshift, inputsize):
    """Fast path for span-eligible variants (substitutions and indels): one
    spliced span per allele (see :func:`assemble_variant_spans`), conv
    shared across shifts. Returns {shift: (ref_rows, alt_rows, diff_rows)}
    with the reference row layout [fwd; rc].

    ``diff = alt - ref`` comes from the device in fp32 (the pair-diff wire),
    so an fp16 wire keeps diff's relative precision instead of differencing
    fp16-rounded sides on the host."""
    offsets = tuple(s + maxshift for s in shifts)
    ref_spans, alt_spans = assemble_variant_spans(genome, chroms, positions, refs, alts, maxshift, inputsize)
    # (2n, S, M) each, already in the [fwd; rc] row layout: per-shift arrays
    # are views
    ref, alt, diff = runner.predict_span_pairs_diff(ref_spans, alt_spans, offsets)
    return {shift: (ref[:, si], alt[:, si], diff[:, si]) for si, shift in enumerate(shifts)}


def _run_window_path(genome, runner, chroms, positions, refs, alts, shifts, inputsize):
    """General path (contig-edge rows, beyond-slack indels): per-shift window
    fetch + splice (reference semantics), ref/alt/fwd/rc windows in one
    batch. The wire is forced to fp32 because diff is differenced on the
    host here: fp16-rounded sides would bury small effects."""
    n = len(chroms)
    out = {}
    for shift in shifts:
        ref_seqs, alt_seqs = [], []
        for i in range(n):
            w = fetch_variant_window(genome, chroms[i], positions[i], refs[i], alts[i], shift=shift, inputsize=inputsize)
            ref_seqs.append(w.ref_seq)
            alt_seqs.append(w.alt_seq)
        ref_codes = seqs_to_codes(ref_seqs, inputsize)
        alt_codes = seqs_to_codes(alt_seqs, inputsize)
        fused = np.concatenate(
            [ref_codes, alt_codes, reverse_complement_codes(ref_codes), reverse_complement_codes(alt_codes)],
            axis=0,
        )
        preds = runner.predict_codes(fused, **fp32_wire_kw(runner)).astype(np.float32)
        ref_rows = np.concatenate([preds[:n], preds[2 * n : 3 * n]], axis=0)
        alt_rows = np.concatenate([preds[n : 2 * n], preds[3 * n :]], axis=0)
        out[shift] = (ref_rows, alt_rows, alt_rows - ref_rows)
    return out


def _h5_rows_selector(global_rows: np.ndarray):
    """A sorted global-row index array as an h5py selection: a plain slice
    when contiguous (the common all-eligible case, and the fastest), else
    the increasing fancy index h5py supports."""
    if global_rows.size and global_rows[-1] - global_rows[0] + 1 == global_rows.size:
        return slice(int(global_rows[0]), int(global_rows[-1]) + 1)
    return global_rows


def stream_span_rows(genome, runner, chroms, positions, refs, alts, shifts, maxshift, inputsize, span_ok, dsets,
                     legacy_only=False) -> None:
    """Stream pair-diff chunks into preallocated per-shift datasets:
    ``dsets[si]`` maps "diff", "ref", "alt" and/or "pred" to a (2N, M)
    float32 target that takes row writes (h5py datasets, numpy arrays).
    Peak host memory is one chunk instead of the 3 x (2N, S, M) float32
    arrays (~43 GB at the reference's default 1e5-variant chunk size). The
    runner calls the sink in chunk order from this thread, so the writes
    take turns with the device work.

    Rows failing ``span_ok`` (contig edges, beyond-slack alleles) are
    computed through the per-window path afterwards, so a handful of edge
    rows never demotes the whole chunk to the in-memory path, and are
    written into the same datasets at their global row positions. With
    ``legacy_only`` only the diff leaves the device, and ``dsets`` hold
    "pred" alone."""
    n = len(chroms)
    offsets = tuple(s + maxshift for s in shifts)
    sub = np.nonzero(span_ok)[0]
    ind = np.nonzero(~span_ok)[0]

    def write_rows(global_rows, si, ref2, alt2, diff2):
        # ref2/alt2/diff2: (r, 2[fwd|rc], M) for this shift's rows;
        # ref2/alt2 are None on the diff-only (legacy_only) wire
        d = dsets[si]
        for orient in (0, 1):
            sel = _h5_rows_selector(global_rows + orient * n)
            if "ref" in d:
                d["ref"][sel] = ref2[:, orient]
                d["alt"][sel] = alt2[:, orient]
                d["diff"][sel] = diff2[:, orient]
            if "pred" in d:
                d["pred"][sel] = diff2[:, orient]

    def sink(s, r, ref, alt, diff):
        # ref/alt/diff: (r, 2[fwd|rc], S, M) fp32 for eligible-subset rows
        # [s, s+r) -> global variant rows sub[s : s+r]
        rows = sub[s : s + r]
        for si in range(len(shifts)):
            write_rows(
                rows, si,
                None if ref is None else ref[..., si, :],
                None if alt is None else alt[..., si, :],
                diff[..., si, :],
            )

    if sub.size:
        ref_spans, alt_spans = assemble_variant_spans(
            genome, chroms[sub], positions[sub], refs[sub], alts[sub], maxshift, inputsize
        )
        if legacy_only:
            # legacy pred == diff: ref/alt tracks never leave the device
            runner.predict_span_pair_diffs_only(
                ref_spans, alt_spans, offsets,
                sink=lambda s, r, diff: sink(s, r, None, None, diff),
            )
        else:
            runner.predict_span_pairs_diff(ref_spans, alt_spans, offsets, sink=sink)

    if ind.size:
        # edge/out-of-slack rows: the per-window path, in memory (always a
        # handful), written at their global positions
        ps_ind = _run_window_path(genome, runner, chroms[ind], positions[ind], refs[ind], alts[ind], shifts, inputsize)
        ni = len(ind)
        for si, shift in enumerate(shifts):
            ref_rows, alt_rows, diff_rows = ps_ind[shift]  # (2*ni, M)
            stack = lambda a: np.stack([a[:ni], a[ni:]], axis=1)  # (ni, 2, M)
            write_rows(ind, si, stack(ref_rows), stack(alt_rows), stack(diff_rows))


def _run_span_path_streaming(
    genome, runner, chroms, positions, refs, alts, shifts, maxshift, inputsize, span_ok,
    output_dir, output_prefix, legacy_h5, legacy_only=False,
) -> list[str]:
    """:func:`stream_span_rows` into preallocated per-shift h5 datasets.
    Returns the h5 paths written."""
    import h5py

    n = len(chroms)
    paths: list[str] = []
    files = []
    dsets = []  # per shift: {"diff": ds, "ref": ds, "alt": ds, ["pred": ds]}
    try:
        for shift in shifts:
            d = {}
            if not legacy_only:
                path = os.path.join(output_dir, f"{output_prefix}.shift_{shift}.diff.h5")
                paths.append(path)
                f = h5py.File(path, "w")
                files.append(f)
                d = {
                    name: f.create_dataset(name, shape=(2 * n, BELUGA_N_TRACKS), dtype=np.float32)
                    for name in ("diff", "ref", "alt")
                }
            if legacy_h5:
                lpath = os.path.join(output_dir, f"{output_prefix}.shift_{shift}.legacy.diff.h5")
                paths.append(lpath)
                lf = h5py.File(lpath, "w")
                files.append(lf)
                d["pred"] = lf.create_dataset("pred", shape=(2 * n, BELUGA_N_TRACKS), dtype=np.float32)
            dsets.append(d)
        stream_span_rows(genome, runner, chroms, positions, refs, alts, shifts, maxshift, inputsize, span_ok, dsets,
                         legacy_only=legacy_only)
    finally:
        for f in files:
            f.close()
    return paths


def compute_variant_chromatin_effects(
    vcf: pd.DataFrame,
    genome,
    runner,
    output_dir: str | os.PathLike | None,
    *,
    maxshift: int = 800,
    inputsize: int = 2000,
    output_prefix: str = "snps",
    keep_arrays: bool = False,
    use_spans: str = "auto",
    verbose: bool = True,
    legacy_h5: bool = False,
    legacy_only: bool = False,
) -> ChromatinResult:
    """Run the full per-shift chromatin-effect computation.

    Args:
        vcf: standardized variant table (cols 0=chrom, 1=pos, 3=ref, 4=alt).
        genome: indexed FASTA (genome/fasta.FastaIndex).
        runner: Beluga engine (parallel/runner.BelugaRunner).
        output_dir: where ``{prefix}.shift_{s}.diff.h5`` files go (None to
            skip writing).
        keep_arrays: also return in-memory arrays (for SED scoring without
            the HDF5 round-trip).
        use_spans: 'auto' (span path for every span-eligible variant —
            substitutions and indels within the crop slack, windows fully
            inside the contig — per-window path for the rest), 'always'
            (raise if any row is ineligible), or 'never'.
        legacy_h5: also write the original-ExPecto single-``pred`` schema as
            ``{prefix}.shift_{s}.legacy.diff.h5``.
        legacy_only: write only the legacy ``pred`` h5s (implies
            ``legacy_h5``). The legacy ``pred`` dataset is the diff alone,
            so the streaming path then ships only ``diff = alt - ref`` off
            the device: half the wire of the diff/ref/alt contract.
    """
    if legacy_only:
        legacy_h5 = True
    shifts = variant_shifts(maxshift)
    n = vcf.shape[0]
    chroms = vcf.iloc[:, 0].astype(str).values
    positions = vcf.iloc[:, 1].astype(int).values
    refs = vcf.iloc[:, 3].astype(str).values
    alts = vcf.iloc[:, 4].astype(str).values

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    # validate before any per-row fetch
    _require_known_chromosomes(genome, chroms)
    ref_matched, alt_matched = _diagnostics(genome, chroms, positions, refs, alts, inputsize, verbose)
    result = ChromatinResult(shifts=shifts, n_variants=n, ref_matched=ref_matched, alt_matched=alt_matched)

    # skip the eligibility pass when the window path is forced and nothing
    # consults the mask
    if use_spans == "never":
        span_ok = np.zeros(n, dtype=bool)
    else:
        span_ok = _span_eligible(genome, chroms, positions, refs, alts, maxshift, inputsize)
    if use_spans == "always":
        n_bad = int((~span_ok).sum())
        if n_bad:
            raise ValueError(
                f"use_spans='always' requires span-eligible variants; {n_bad} rows are not "
                "(allele length change beyond the 100 bp crop slack, or shift windows crossing "
                "a contig edge where the reference clamp-shifts the fetch) — use 'auto' or 'never'"
            )

    # streaming path: nothing needs the in-memory arrays (h5 output only), so
    # span-eligible rows' chunks go
    # straight into the h5 datasets (window-fallback rows are computed after
    # and written at their positions, so a handful of edge rows never
    # demotes the chunk). Peak memory drops from 3 x (2N, S, M) fp32 to one
    # chunk.
    if output_dir is not None and not keep_arrays and bool(span_ok.any()):
        _run_span_path_streaming(
            genome, runner, np.asarray(chroms), np.asarray(positions), np.asarray(refs),
            np.asarray(alts), shifts, maxshift, inputsize, span_ok,
            output_dir, output_prefix, legacy_h5, legacy_only=legacy_only,
        )
        return result

    if n == 0:
        empty = np.zeros((0, BELUGA_N_TRACKS), np.float32)
        per_shift = {shift: (empty, empty, empty) for shift in shifts}
    elif span_ok.all():
        per_shift = _run_span_path(genome, runner, chroms, positions, refs, alts, shifts, maxshift, inputsize)
    elif span_ok.any():
        # mixed eligibility: eligible rows (substitutions and in-bounds
        # indels) keep the span path; edge/out-of-slack rows take the
        # per-window path; rows re-merged into input order
        sub = np.nonzero(span_ok)[0]
        ind = np.nonzero(~span_ok)[0]
        ps_sub = _run_span_path(
            genome, runner, chroms[sub], positions[sub], refs[sub], alts[sub], shifts, maxshift, inputsize
        )
        ps_ind = _run_window_path(
            genome, runner, chroms[ind], positions[ind], refs[ind], alts[ind], shifts, inputsize
        )
        per_shift = {}
        for shift in shifts:
            merged_all = []
            for k in range(3):  # ref, alt, diff: diff merges exactly like the sides
                src_s, src_i = ps_sub[shift][k], ps_ind[shift][k]
                merged = np.empty((2 * n, src_s.shape[1]), dtype=np.float32)
                merged[sub], merged[n + sub] = src_s[: len(sub)], src_s[len(sub) :]
                merged[ind], merged[n + ind] = src_i[: len(ind)], src_i[len(ind) :]
                merged_all.append(merged)
            per_shift[shift] = tuple(merged_all)
    else:
        per_shift = _run_window_path(genome, runner, chroms, positions, refs, alts, shifts, inputsize)

    arrays: dict = {}
    for shift in shifts:
        ref_rows, alt_rows, diff = per_shift[shift]
        if output_dir is not None:
            if not legacy_only:
                write_shift_h5(os.path.join(output_dir, f"{output_prefix}.shift_{shift}.diff.h5"), diff, ref_rows, alt_rows)
            if legacy_h5:
                write_legacy_shift_h5(os.path.join(output_dir, f"{output_prefix}.shift_{shift}.legacy.diff.h5"), diff)
        if keep_arrays:
            arrays[shift] = (diff, ref_rows, alt_rows)
    if keep_arrays:
        result.arrays = arrays
    return result
