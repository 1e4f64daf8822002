"""GEUVADIS personal-genome (consensus-sequence) prediction pipelines on
the card (port of expecto_tpu/pipeline/consensus.py; reference
geuvadis_predict_consensus.py, geuvadis_predict_ref_all_genes.py,
geuvadis_sed_for_top_eqtls.py).

Per gene and individual: a 393,216-bp Enformer-window consensus FASTA is
N-padded if chromosome-edge truncated, sliced into 200 TSS-centered
2,000-bp shift windows (0-based, TSS at len//2), run through Beluga with
forward/RC averaging, decay-projected, padded to the legacy 20,030-feature
layout, and scored with the expression model.

Each consensus sequence is encoded to int8 codes **once** and the 200
windows are strided views of that array (the reference re-encodes 400,000
bp of window text per sample, geuvadis_predict_consensus.py:93); all samples
of a gene go through the runner's span paths together. The runner has every
method these pipelines call, so they call them directly; single process
(the multi-process gene sharding is not ported yet). h5py is imported only
where a file is read or written, so the ``ref`` pipeline runs without it.
"""

from __future__ import annotations

import glob
import os
import sys
from pathlib import Path

import numpy as np
import pandas as pd

from ..genome.encode import _BYTE_LUT
from ..genome.windows import gene_shifts
from ..io.xgb import load_expression_model
from ..models.gblinear import GBLinearModel
from ..ops.decay import gene_pos_weights, project_features, pad_legacy_20030
from ..ops.spans import CONV6_STRIDE, conv6_patch_sites_plan
from ..parallel.runner import BelugaRunner
from .merge import natsorted

ENFORMER_SEQ_LENGTH = 393216


def _progress(on: bool, what: str, done: int, total: int) -> None:
    if on:
        print(f"{what}: {done}/{total}", file=sys.stderr, flush=True)


def parse_fasta(path: str | os.PathLike):
    """Minimal FASTA record iterator -> (record_id, sequence); transparently
    reads ``.gz`` files (the top-eqtl consensus layout stores one gzipped
    FASTA per gene, geuvadis_predict_consensus_for_top_eqtls.py:78,137).
    Replaces the Bio.SeqIO dependency."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    name = None
    chunks: list[str] = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def pad_enformer_seq(record_id: str, seq: str, expected_len: int = ENFORMER_SEQ_LENGTH) -> str:
    """N-pad a chromosome-edge-truncated consensus sequence to the Enformer
    window length, using the coordinate interval in the record id
    (reference geuvadis_predict_consensus.py:147-169)."""
    seq = seq.upper()
    interval = record_id.split(":")[1]
    if interval.startswith("-"):
        bp_start = -int(interval.split("-")[-2])
        bp_end = int(interval.split("-")[-1])
        if bp_end - bp_start + 1 != expected_len:
            raise AssertionError(f"interval {interval} is not {expected_len} bp")
        seq = "N" * (expected_len - len(seq)) + seq
    else:
        bp_start, bp_end = map(int, interval.split("-"))
        if bp_end - bp_start + 1 != expected_len:
            raise AssertionError(f"interval {interval} is not {expected_len} bp")
        if len(seq) < expected_len:
            seq = seq + "N" * (expected_len - len(seq))
    if len(seq) != expected_len:
        raise AssertionError(f"Sequence length is {len(seq)} for {record_id}")
    return seq


def consensus_window_codes(seq: str, strand: str, *, shifts=None, windowsize: int = 2000) -> np.ndarray:
    """(n_shifts, windowsize) int8 codes of the TSS-centered shift windows.

    0-based slicing with the TSS at ``len(seq) // 2``
    (geuvadis_predict_consensus.py:210-243): window =
    seq[tss + shift*strand - (w/2-1) : tss + shift*strand + w/2 + 1].
    """
    starts, _, _ = consensus_span_bounds(len(seq), strand, shifts=shifts, windowsize=windowsize)
    for start in starts:
        if start < 0 or start + windowsize > len(seq):
            raise AssertionError(
                f"Expected seq of length {windowsize} but window [{start}:{start + windowsize}] is out of range"
            )
    # encode only the covered span (+-21 kb of a 393 kb Enformer sequence)
    lo, hi = min(starts), max(starts) + windowsize
    codes = _BYTE_LUT[np.frombuffer(seq[lo:hi].encode("ascii"), dtype=np.uint8)]
    out = np.empty((len(shifts), windowsize), dtype=np.int8)
    for i, start in enumerate(starts):
        out[i] = codes[start - lo : start - lo + windowsize]
    return out


def consensus_span_bounds(seq_len: int, strand: str, *, shifts=None, windowsize: int = 2000):
    """(window_starts, lo, hi): the 0-based shift-window starts within a
    TSS-centered consensus sequence of ``seq_len`` bases, and the [lo, hi)
    span covering them — the single source of the window math shared by
    consensus_window_codes / consensus_span_and_offsets / the top-eqtl
    stored-``seqs`` slice (geuvadis_predict_consensus.py:210-243)."""
    shifts = gene_shifts() if shifts is None else shifts
    sgn = {"+": 1, "-": -1}[strand]
    tss_i = seq_len // 2
    starts = [tss_i + s * sgn - int(windowsize / 2 - 1) for s in shifts]
    return starts, min(starts), max(starts) + windowsize


def consensus_span_and_offsets(seq: str, strand: str, *, shifts=None, windowsize: int = 2000, align: int = 1):
    """(span_codes, offsets) covering all shift windows of a consensus
    sequence — the span-amortized equivalent of consensus_window_codes
    (windows at offsets[i] == consensus_window_codes(...)[i]).

    ``align``: extend the span end so its length is a multiple (the patch
    kernel needs 16-multiples — an unaligned tail leaves the last conv6
    receptive fields uncoverable by any 16-aligned sub-span; the Enformer
    window has ~180 kb of slack past the covered span, so the extension is
    real sequence and the window predictions are unchanged). Falls back to
    the unextended span if the sequence is too short; extension is uniform
    across a cohort (it depends only on seq length/strand/shifts)."""
    starts, lo, hi = consensus_span_bounds(len(seq), strand, shifts=shifts, windowsize=windowsize)
    if lo < 0 or hi > len(seq):
        raise AssertionError("consensus span out of range")
    ext = (-(hi - lo)) % align
    if hi + ext <= len(seq):
        hi += ext
    # encode only the covered span (+-21 kb of a 393 kb Enformer sequence)
    codes = _BYTE_LUT[np.frombuffer(seq[lo:hi].encode("ascii"), dtype=np.uint8)]
    return codes.astype(np.int8), tuple(st - lo for st in starts)


#: a lone 2-kb window forward costs ~10x a span-amortized one, so against a
#: span-capable runner the per-window dedup path must remove >~10x of the
#: (already span-deduplicated) windows to win
WINDOW_DEDUP_MIN_REDUNDANCY = 10.0


def _unique_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact row dedup -> (unique_rows, inverse), first-occurrence order.

    ``np.unique(axis=0)`` lexsorts full-width keys (~130 ms per (445, 2000)
    int8 block — it dominated cohort dedup end-to-end); hashing each row's
    bytes through a dict is ~50x faster and keeps exactness."""
    seen: dict[bytes, int] = {}
    inverse = np.empty(rows.shape[0], dtype=np.int64)
    keep: list[int] = []
    for i, r in enumerate(rows):
        j = seen.setdefault(r.tobytes(), len(keep))
        if j == len(keep):
            keep.append(i)
        inverse[i] = j
    return rows[keep], inverse


def _encode_record_spans(seqs_and_strands, shifts, align: int = 1):
    """Encode each record's shift-window span ONCE, grouped by span-offset
    layout (strand flips the offset order): {offsets: (orig_indices,
    (G, span_len) int8 spans)}. Shared by the window-dedup probe (whose
    per-shift windows are zero-copy row slices of these spans) and the
    span fallback path, so a failed probe encodes nothing twice."""
    by_offsets: dict[tuple, list[tuple[int, np.ndarray]]] = {}
    for i, (seq, strand) in enumerate(seqs_and_strands):
        span, offsets = consensus_span_and_offsets(seq, strand, shifts=shifts, align=align)
        by_offsets.setdefault(offsets, []).append((i, span))
    return {
        offs: (np.array([i for i, _ in items], dtype=np.int64), np.stack([sp for _, sp in items]))
        for offs, items in by_offsets.items()
    }


def _predict_window_dedup_spans(runner, groups, n_records, n_shifts, budget, dtype, windowsize=2000):
    """Per-shift-window dedup over pre-encoded record spans: personal
    genomes differ at ~0.1% of sites, so each 2,000-bp shift window has only
    a few unique sequences across a cohort (a window covers ~2 SNPs -> <=4
    haplotypes); each unique window is predicted once and gathered per
    record. Windows are contiguous row slices of the span arrays, so the
    probe costs hashing only — no (R, S, 2000) window materialization.
    All shifts' unique windows go to the device in one batched call; the
    gather builds (S, R, M), so each shift's write is contiguous, and hands
    back the (R, S, M) transposed view. Returns None when the redundancy does not clear ``budget`` (the number
    of lone-window forwards that still beats the span path). Aborts early by
    extrapolation: if the first few shifts' unique counts project past
    ``budget``, later shifts cannot save the crossover (cohorts of
    mostly-distinct sequences stop paying the full probe)."""
    uniq_blocks: list[np.ndarray] = []
    inverse_per_shift: list[np.ndarray] = []
    offsets_per_shift: list[int] = []
    total = 0
    probe_at = min(n_shifts, 4)
    for s in range(n_shifts):
        seen: dict[bytes, int] = {}
        inv = np.empty(n_records, dtype=np.int64)
        uniq_rows: list[np.ndarray] = []
        for offs, (idx, rows) in groups.items():
            st = offs[s]
            win = rows[:, st : st + windowsize]
            for k in range(win.shape[0]):
                j = seen.setdefault(win[k].tobytes(), len(uniq_rows))
                if j == len(uniq_rows):
                    uniq_rows.append(win[k])
                inv[idx[k]] = j
        offsets_per_shift.append(total)
        total += len(uniq_rows)
        if total > budget:
            return None
        if s + 1 == probe_at and total / (s + 1) * n_shifts > budget:
            return None
        uniq_blocks.append(np.stack(uniq_rows))
        inverse_per_shift.append(inv)

    preds_uniq = runner.predict_codes(np.concatenate(uniq_blocks, axis=0), average_rc=True)
    out = np.empty((n_shifts, n_records, preds_uniq.shape[-1]), dtype=dtype)
    same_dtype = preds_uniq.dtype == out.dtype  # np.take(out=) needs equal dtypes
    for s in range(n_shifts):
        idx = offsets_per_shift[s] + inverse_per_shift[s]
        if same_dtype:
            np.take(preds_uniq, idx, axis=0, out=out[s])
        else:
            out[s] = preds_uniq[idx]
    return out.transpose(1, 0, 2)


def _predict_span_groups(seqs_and_strands, shifts, predict_group, out=None, *, dtype=None, groups=None):
    """Shared span-path scaffolding: group records by their span-offset
    layout (strand flips the offset order), predict each group's **unique**
    spans via ``predict_group(uniq_rows, offsets)``, and scatter results
    back to per-record rows of ``out``.

    ``groups`` passes pre-encoded spans (:func:`_encode_record_spans`) so a
    failed window-dedup probe doesn't re-encode the cohort. With
    ``out=None`` the result array is allocated from the first group's
    prediction shape (so the per-record width follows the runner's actual
    track/feature count instead of a hard-coded 2002)."""
    if out is None and not seqs_and_strands:
        raise ValueError("no consensus records to predict (empty record list)")
    if groups is None:
        groups = _encode_record_spans(seqs_and_strands, shifts)
    for offsets, (idx, rows) in groups.items():
        uniq, inverse = _unique_rows(rows)
        res = np.asarray(predict_group(uniq, offsets))
        if out is None:
            out = np.empty(
                (len(seqs_and_strands),) + res.shape[1:],
                dtype=res.dtype if dtype is None else dtype,
            )
        if res.shape[0] == len(idx) and np.array_equal(inverse, np.arange(len(idx))):
            out[idx] = res  # all-distinct group: no gather temp at all
        else:
            # chunked scatter: `res[inverse]` in one shot would materialize
            # a second full per-record copy (~700 MB on a 445-sample
            # cohort-gene fallback); 64-row chunks bound the transient
            for s in range(0, len(idx), 64):
                out[idx[s : s + 64]] = res[inverse[s : s + 64]]
    return out


def _predict_consensus_preds(runner, seqs_and_strands, shifts, dtype=np.float32):
    """(n_records, n_shifts, 2002) fwd/RC-averaged predictions for a list of
    (seq, strand), through the runner's span-amortized path.

    Identical records (shared haplotypes / homozygous cohorts) are predicted
    **once** and gathered per record; within the surviving unique records,
    per-shift window dedup kicks in when cohort windows are redundant enough
    to beat the span path (few-SNP cohorts).

    Note the engine picks between the span kernel and the lone-window kernel
    by measured redundancy, so chromatin values for the same sample can
    differ by the usual span-vs-window reduction-order band (~1e-5 fp32)
    depending on cohort composition — do not exact-compare h5s across runs
    with different cohorts.

    ``dtype=np.float16`` halves the device->host fetch (the path's
    bottleneck on bandwidth-limited links); sigmoid track probabilities fit
    fp16, and the reference itself rewrites these h5s to fp16 in
    compress_consensus.py:12-69."""
    dtype = np.dtype(dtype)
    n_total = len(seqs_and_strands)
    # record-level dedup: byte-identical (seq, strand) records collapse to one
    uniq_index: dict[tuple, int] = {}
    rec_to_uniq = np.empty(n_total, dtype=np.int64)
    uniq_records: list[tuple[str, str]] = []
    for i, rec in enumerate(seqs_and_strands):
        j = uniq_index.setdefault(rec, len(uniq_records))
        if j == len(uniq_records):
            uniq_records.append(rec)
        rec_to_uniq[i] = j
    n_u = len(uniq_records)

    use_shifts = list(gene_shifts() if shifts is None else shifts)
    n_shifts = len(use_shifts)

    preds_u = None
    groups = None
    if n_u >= 8:
        # the fallback costs n_u spans (1 span ~= n_shifts amortized
        # windows, a lone window ~= 10x one)
        budget = n_u * n_shifts / WINDOW_DEDUP_MIN_REDUNDANCY
        # encode spans once; the probe hashes zero-copy window slices and a
        # failed probe hands the same arrays to the span path
        groups = _encode_record_spans(uniq_records, use_shifts)
        preds_u = _predict_window_dedup_spans(runner, groups, n_u, n_shifts, budget, dtype)

    if preds_u is None:
        preds_u = _predict_span_groups(
            uniq_records,
            use_shifts,
            lambda uniq, offsets: runner.predict_span_codes(uniq, offsets, rc_mode="average"),
            dtype=dtype,
            groups=groups,
        )

    return preds_u if n_u == n_total else preds_u[rec_to_uniq]


def consensus_features(preds: np.ndarray, shifts=None) -> np.ndarray:
    """(n_samples, 200, 2002) averaged predictions -> legacy (n, 20030)
    features (geuvadis_predict_consensus.py:109-125)."""
    pos_weights = gene_pos_weights(gene_shifts() if shifts is None else shifts)
    feats = project_features(pos_weights, preds.transpose(1, 0, 2))  # (n, 20020)
    return pad_legacy_20030(feats)


def _predict_consensus_features(runner, seqs_and_strands, shifts) -> np.ndarray:
    """(n_records, 20030) legacy-padded decay features, projected **on
    device** (runner.predict_spans_project).

    The ref/eQTL consensus paths never store chromatin predictions, so
    fetching raw (200, 2002) tracks per record (~1.6 MB) just to project
    them host-side wastes 20x device->host bandwidth vs the 10x2002
    projected features (~80 KB)."""
    use_shifts = list(gene_shifts() if shifts is None else shifts)
    pw = gene_pos_weights(use_shifts)
    out = _predict_span_groups(
        seqs_and_strands,
        use_shifts,
        lambda uniq, offsets: runner.predict_spans_project(uniq, offsets, pw),
        dtype=np.float32,
    )
    return pad_legacy_20030(out)


#: max patch ranges per record (in buckets of 8), the JAX package's value:
#: 48 overlapping 704-base sub-spans re-convolve ~80% of a 41.8-kb span
#: while the dense layers are unchanged, so past some K the plain span
#: forward is cheaper. Where the crossover lies depends on the device.
PATCH_MAX_RANGES = 24


def _predict_consensus_features_cohort(runner, seqs_and_strands, shifts) -> np.ndarray:
    """(n_records, 20030) legacy-padded features for a COHORT of consensus
    records sharing a per-gene backbone — the features-only C18 fast path.
    Never fetches or stores chromatin tracks; three engines
    compete per cohort, cheapest applicable first:

    1. per-shift window dedup (shared segregating sites): predict unique
       windows only, project on host — the probe aborts by extrapolation
       when cohort windows are mostly distinct;
    2. backbone conv6 patching (private/rare variants): the conv stack runs
       once on the group's backbone span; each sample recomputes only the
       ~20 conv6 frames around each of its diff ranges
       (ops/spans.conv6_patch_sites_plan + runner.project_spans_backbone_patch),
       then dense layers + on-device decay projection;
    3. plain span projection (records too divergent to patch — e.g.
       indel-shifted consensus sequences where everything downstream of the
       indel differs from the backbone).

    Reference workload: geuvadis_predict_consensus.py:26-135 — its
    {gene}.h5 'expecto_preds' is the contract this path serves;
    '{gene}_chromatin.h5' becomes opt-in (see predict_consensus_genes)."""
    use_shifts = list(gene_shifts() if shifts is None else shifts)
    pw = gene_pos_weights(use_shifts)
    n_feats = pw.shape[0] * 2002
    n_total = len(seqs_and_strands)
    if n_total == 0:
        raise ValueError("no consensus records to predict (empty record list)")
    # record-level dedup (shared haplotypes / homozygous cohorts)
    uniq_index: dict[tuple, int] = {}
    rec_to_uniq = np.empty(n_total, dtype=np.int64)
    uniq_records: list[tuple[str, str]] = []
    for i, rec in enumerate(seqs_and_strands):
        j = uniq_index.setdefault(rec, len(uniq_records))
        if j == len(uniq_records):
            uniq_records.append(rec)
        rec_to_uniq[i] = j
    n_u = len(uniq_records)
    n_shifts = len(use_shifts)

    # spans extended to a 16-multiple so the patch kernel can cover the tail
    # receptive fields; window offsets (and thus predictions) are unchanged
    groups = _encode_record_spans(uniq_records, use_shifts, align=CONV6_STRIDE)

    feats_u = None
    if n_u >= 8:
        # shared-sites regime: unique-window forward beats everything when
        # redundancy clears the span-path crossover
        budget = n_u * n_shifts / WINDOW_DEDUP_MIN_REDUNDANCY
        preds_u = _predict_window_dedup_spans(runner, groups, n_u, n_shifts, budget, np.float32)
        if preds_u is not None:
            feats_u = project_features(pw, preds_u.transpose(1, 0, 2))

    if feats_u is None:
        feats_u = np.empty((n_u, n_feats), dtype=np.float32)
        for offsets, (idx, rows) in groups.items():
            span_len = rows.shape[1]
            backbone = rows[0]
            phases_f = {(o // 4) % 4 for o in offsets}
            phases_r = {((span_len - 2000 - o) // 4) % 4 for o in offsets}
            neq = rows != backbone[None, :]
            counts = neq.sum(axis=1)
            plans: list[tuple[list[int], list[int]] | None] = []
            for r in range(rows.shape[0]):
                # an indel-shifted record differs everywhere downstream; the
                # plan would fail after a full greedy pass — skip it early
                if counts[r] > 64 * PATCH_MAX_RANGES:
                    plans.append(None)
                    continue
                dp = np.nonzero(neq[r])[0]
                pf = conv6_patch_sites_plan(dp, span_len, phases_f, max_ranges=PATCH_MAX_RANGES)
                if pf is None:
                    plans.append(None)
                    continue
                pr = conv6_patch_sites_plan(
                    (span_len - 1 - dp)[::-1], span_len, phases_r, max_ranges=PATCH_MAX_RANGES
                )
                plans.append(None if pr is None else (pf, pr))

            # bucket patchable rows by range count (steps of 8) so sparse
            # samples never pay a dense sample's K slots
            buckets: dict[int, list[int]] = {}
            fallback: list[int] = []
            trivial: list[int] = []
            for r, plan in enumerate(plans):
                if plan is None:
                    fallback.append(r)
                elif not plan[0] and not plan[1]:
                    trivial.append(r)  # identical to the backbone
                else:
                    k8 = max(8, -(-max(len(plan[0]), len(plan[1])) // 8) * 8)
                    buckets.setdefault(k8, []).append(r)
            # trivial rows are exact on EITHER path; ride one that already
            # runs instead of paying a padded one-row chunk of their own
            # (measured: a lone backbone row in its own patch call cost a
            # 42-site cohort ~40% end to end)
            if trivial:
                if fallback or not buckets:
                    fallback.extend(trivial)
                else:
                    buckets[min(buckets)].extend(trivial)
            # a near-empty patch bucket next to an existing fallback batch
            # costs a full padded device chunk for a handful of rows — the
            # fallback's padding slack is cheaper
            if fallback:
                for k8 in [k for k, v in buckets.items() if len(v) < 8]:
                    fallback.extend(buckets.pop(k8))
            for k8, rows_k in sorted(buckets.items()):
                # (R, K, 2) int32: [:, :, 0] = w0 sub-span starts, [:, :, 1]
                # = d0 conv1-recompute starts (conv6_patch_sites_plan pairs)
                sf = np.zeros((len(rows_k), k8, 2), np.int32)
                sr = np.zeros((len(rows_k), k8, 2), np.int32)
                for m, r in enumerate(rows_k):
                    pf, pr = plans[r]
                    if pf:
                        sf[m, : len(pf)] = pf
                    if pr:
                        sr[m, : len(pr)] = pr
                feats_u[idx[rows_k]] = runner.project_spans_backbone_patch(
                    backbone, rows[rows_k], sf, sr, offsets, pw
                )
            if fallback:
                feats_u[idx[fallback]] = runner.predict_spans_project(rows[fallback], offsets, pw)

    out = feats_u if n_u == n_total else feats_u[rec_to_uniq]
    return pad_legacy_20030(out)


def _match_features(feats: np.ndarray, model: GBLinearModel) -> np.ndarray:
    if model.n_features == feats.shape[1]:
        return feats
    if model.n_features == feats.shape[1] - 10:  # modern 20,020 model
        return feats.reshape(feats.shape[0], 10, -1)[:, :, 1:].reshape(feats.shape[0], -1)
    raise ValueError(f"model expects {model.n_features} features, have {feats.shape[1]}")


def predict_consensus_genes(
    expecto_model_path: str,
    consensus_dir: str,
    genes_file: str,
    runner: BelugaRunner,
    out_dir: str,
    *,
    overwrite: bool = False,
    exp_only: bool = False,
    num_chunks: int | None = None,
    chunk_i: int | None = None,
    genes: list[str] | None = None,
    shifts=None,
    progress: bool = False,
    chromatin_dtype=np.float32,
    features_only: bool = False,
) -> list[str]:
    """C18: per-gene, per-individual consensus expression prediction with
    resume-skip / --exp_only / gene-chunk semantics
    (geuvadis_predict_consensus.py:26-135).

    ``chromatin_dtype=np.float16`` fetches and stores chromatin_preds in
    half precision — the format compress_consensus.py produces anyway —
    halving the dominant device->host and disk traffic.

    ``features_only=True`` skips the chromatin h5 entirely: decay features
    are projected ON DEVICE (20x less device->host traffic than the raw
    (n, 200, 2002) tracks) and the cohort rides the backbone-patched fast
    path (:func:`_predict_consensus_features_cohort`), so the
    private-variant regime becomes compute-bound instead of fetch-walled.
    Output is the ``{gene}.h5`` 'expecto_preds' contract
    alone; no ``{gene}_chromatin.h5`` is written, and a later ``exp_only``
    resume therefore cannot use these genes.

    ``num_chunks``/``chunk_i`` keep the reference's file-level chunk
    semantics."""
    if features_only and exp_only:
        raise ValueError(
            "features_only and exp_only are mutually exclusive: exp_only re-scores "
            "cached chromatin h5s, which features_only never writes"
        )
    os.makedirs(out_dir, exist_ok=True)
    bst = load_expression_model(expecto_model_path.strip())

    if genes is None:
        genes = natsorted([os.path.basename(p) for p in glob.glob(f"{consensus_dir}/*")])
    genes_df = pd.read_csv(genes_file, names=["ens_id", "chrom", "bp", "gene_symbol", "strand"], index_col=False)
    genes_df["gene_symbol"] = genes_df["gene_symbol"].fillna(genes_df["ens_id"]).str.lower()
    genes_df = genes_df.set_index("gene_symbol")

    if (num_chunks is None) != (chunk_i is None):
        raise ValueError("num_chunks and chunk_i must be passed together")
    if num_chunks is not None:
        genes = list(np.array_split(np.array(genes, dtype=object), num_chunks)[chunk_i])
        if not genes:
            raise AssertionError("Gene split resulted in empty list")

    import h5py

    done = []
    for gi, gene in enumerate(genes):
        _progress(progress, "consensus genes", gi, len(genes))
        strand = genes_df.loc[gene, "strand"]
        if isinstance(strand, pd.Series):  # duplicate gene symbols in the annotation
            strand = strand.iloc[0]
        preds_dir = f"{out_dir}/{gene}"
        os.makedirs(preds_dir, exist_ok=True)
        if not overwrite and os.path.exists(f"{preds_dir}/{gene}.h5"):
            continue

        preds = None
        if exp_only:
            with h5py.File(f"{preds_dir}/{gene}_chromatin.h5", "r") as f:
                preds = np.array(f["chromatin_preds"])
                record_ids = [x.decode("utf-8") for x in f["record_ids"]]
        else:
            record_ids = []
            seqs = []
            # deterministic sample order: raw glob order is
            # filesystem-dependent and would break cross-gene record-id
            # consistency checks in the merger
            for fasta_file in natsorted(glob.glob(f"{consensus_dir}/{gene}/samples/*.fa")):
                for rec_id, seq in parse_fasta(fasta_file):
                    seqs.append((pad_enformer_seq(rec_id, seq), strand))
                    record_ids.append(f"{rec_id}|{Path(fasta_file).stem}")
            if not features_only:
                preds = _predict_consensus_preds(runner, seqs, shifts, dtype=chromatin_dtype)

        if preds is not None:
            feats20030 = consensus_features(preds.astype(np.float32), shifts)
        else:
            feats20030 = _predict_consensus_features_cohort(runner, seqs, shifts)
        feats = _match_features(feats20030, bst)
        expecto_preds = bst.predict(feats)

        if not exp_only and not features_only:
            # in exp_only mode the chromatin h5 was the (expensive) input;
            # never truncate-rewrite it
            with h5py.File(f"{preds_dir}/{gene}_chromatin.h5", "w") as f:
                f.create_dataset("chromatin_preds", data=preds)
                f.create_dataset("record_ids", data=np.array(record_ids, "S"))
        with h5py.File(f"{preds_dir}/{gene}.h5", "w") as f:
            f.create_dataset("expecto_preds", data=expecto_preds)
            f.create_dataset("record_ids", data=np.array(record_ids, "S"))
        done.append(gene)
    return done


# The reference hard-codes these six "highly and lowly variable" genes
# (geuvadis_predict_consensus_for_top_eqtls.py:73).
REFERENCE_TOP_EQTL_GENES = ("HLA-B", "HLA-C", "RPL28", "CPAMD8", "TMEM121B", "SCN11A")


def merge_eqtls_with_vcf(eqtls_df_file: str, snps_vcf: str) -> pd.DataFrame:
    """Join the top-eQTL table onto the SNP VCF by chrom_pos key
    (geuvadis_predict_consensus_for_top_eqtls.py:52-66)."""
    eqtls = pd.read_csv(eqtls_df_file)
    eqtls["gene_symbol"] = eqtls["name"].fillna(eqtls["geneID"])
    eqtls["SNPpos"] = eqtls["SNPpos"].astype(int).astype(str)
    eqtls = eqtls.set_index("chr" + eqtls["CHR_SNP"].astype(str) + "_" + eqtls["SNPpos"])
    vcf_df = pd.read_csv(snps_vcf, sep="\t", comment="#", header=None).iloc[:, 0:5]
    vcf_df.columns = ["SNP_CHROM", "SNP_POS", "ID", "REF", "ALT"]
    vcf_df.index = vcf_df.iloc[:, 0].astype(str) + "_" + vcf_df.iloc[:, 1].astype(str)
    vcf_df = vcf_df.drop_duplicates()
    return eqtls.merge(vcf_df, left_index=True, right_index=True, validate="m:1", how="inner")


def predict_consensus_for_top_eqtls(
    expecto_model_path: str,
    consensus_dir: str,
    eqtls_df_file: str,
    snps_vcf: str,
    runner: BelugaRunner,
    out_dir: str,
    *,
    genes=None,
    shifts=None,
    progress: bool = False,
) -> pd.DataFrame:
    """C18 variant for the top-eQTL gene set
    (geuvadis_predict_consensus_for_top_eqtls.py:23-128): consensus samples
    live in one gzipped FASTA per gene ({gene}/{gene}.fa.gz), the strand is
    embedded in each record id (field -2 of the '|' split), and the per-gene
    h5 additionally stores the 41,800-bp ExPecto receptive-field slice of
    every sample ('seqs') alongside 'preds' and 'record_ids'.

    TSS indexing uses len(seq)//2 for both strands, matching the Enformer
    convention the main consensus script settled on
    (geuvadis_predict_consensus.py:217-227); the reference file's stale
    (len-1)//2 '+'-strand variant predates the Enformer windows per the
    reference's own comments.
    """
    os.makedirs(out_dir, exist_ok=True)
    bst = load_expression_model(expecto_model_path.strip())
    eqtls_df = merge_eqtls_with_vcf(eqtls_df_file, snps_vcf)
    genes = list(REFERENCE_TOP_EQTL_GENES) if genes is None else list(genes)

    import h5py

    for gi, gene in enumerate(genes):
        _progress(progress, "top-eqtl genes", gi, len(genes))
        g = gene.lower()
        preds_dir = f"{out_dir}/{g}"
        os.makedirs(preds_dir, exist_ok=True)
        record_ids, seqs_and_strands, span_seqs = [], [], []
        for rec_id, seq in parse_fasta(f"{consensus_dir}/{g}/{g}.fa.gz"):
            seq = seq.upper()
            strand = rec_id.split("|")[-2]
            seqs_and_strands.append((seq, strand))
            record_ids.append(rec_id)
            # the stored receptive-field slice == the shift-window span
            _, lo, hi = consensus_span_bounds(len(seq), strand, shifts=shifts)
            if lo < 0 or hi > len(seq):
                raise AssertionError(
                    f"consensus record {rec_id} is too short ({len(seq)} bp) for the "
                    f"receptive-field span [{lo}, {hi})"
                )
            span_seqs.append(seq[lo:hi])
        # this path stores no chromatin tracks, so it rides the
        # features-only cohort engine (on-device projection + backbone
        # patching) — ~20x less device->host traffic than fetching
        # (R, S, 2002) tracks to project host-side
        feats = _match_features(_predict_consensus_features_cohort(runner, seqs_and_strands, shifts), bst)
        expecto_preds = bst.predict(feats)
        with h5py.File(f"{preds_dir}/{g}.h5", "w") as f:
            f.create_dataset("preds", data=expecto_preds)
            f.create_dataset("record_ids", data=np.array(record_ids, "S"))
            f.create_dataset("seqs", data=np.array(span_seqs, "S"))
    return eqtls_df


def predict_ref_all_genes(
    expecto_model_path: str,
    consensus_dir: str,
    genes_file: str,
    runner: BelugaRunner,
    out_dir: str,
    *,
    shifts=None,
    progress: bool = False,
    genes_per_call: int = 32,
) -> pd.DataFrame:
    """C19: reference-haplotype predictions for all genes -> ref_preds.csv
    (geuvadis_predict_ref_all_genes.py:23-106).

    Genes are batched ``genes_per_call`` at a time through one runner call:
    the per-gene compute is a few ms, so per-gene calls would pay the fixed
    per-call cost 24,338 times on the full gene set. Writes only the CSV, so
    it needs no h5py."""
    os.makedirs(out_dir, exist_ok=True)
    bst = load_expression_model(expecto_model_path.strip())

    genes_df = pd.read_csv(genes_file, names=["ens_id", "chrom", "bp", "gene_symbol", "strand"], index_col=False)
    genes_df["gene_symbol"] = genes_df["gene_symbol"].fillna(genes_df["ens_id"])
    genes_df = genes_df.set_index("gene_symbol")

    gene_rows = list(zip(genes_df.index, genes_df["strand"]))

    groups = [gene_rows[i : i + genes_per_call] for i in range(0, len(gene_rows), genes_per_call)]
    ref_preds_out = []
    for group in groups:
        _progress(progress, "ref genes", len(ref_preds_out), len(gene_rows))
        seqs = []
        for gene, strand in group:
            records = list(parse_fasta(f"{consensus_dir}/{gene.lower()}/ref.fa"))
            if len(records) != 1:
                raise AssertionError(f"Expected 1 record in ref.fa for {gene}, got {len(records)}")
            rec_id, seq = records[0]
            seqs.append((pad_enformer_seq(rec_id, seq), strand))
        feats = _match_features(_predict_consensus_features(runner, seqs, shifts), bst)
        ref_preds_out.extend(float(x) for x in bst.predict(feats))

    df = pd.DataFrame(
        {"genes": np.array([g for g, _ in gene_rows]), "ref_preds": np.array(ref_preds_out)}
    )
    df.to_csv(f"{out_dir}/ref_preds.csv", header=True, index=False)
    return df


def sed_for_top_eqtls(
    expecto_model_path: str,
    consensus_dir: str,
    eur_top_eqtl_genes_csv: str,
    eqtls_csv: str,
    runner: BelugaRunner,
    out_dir: str,
    *,
    shifts=None,
    pairs_per_call: int = 16,
) -> pd.DataFrame:
    """C20: eQTL SED on consensus backbones with ref-allele validation
    asserts (geuvadis_sed_for_top_eqtls.py:21-135,201-235).

    Single process by design: the reference workload is a handful of eQTLs
    on six hard-coded genes, seconds of device compute through the batched
    pair calls below, and the output is ONE DataFrame."""
    os.makedirs(out_dir, exist_ok=True)
    bst = load_expression_model(expecto_model_path.strip())

    eqtls_df = pd.read_csv(eqtls_csv)
    all_eqtls_df = pd.read_csv(eur_top_eqtl_genes_csv, names=["ens_id", "chr", "pos", "gene", "strand"])
    all_eqtls_df["gene"] = all_eqtls_df["gene"].str.lower()
    all_eqtls_df["gene"] = all_eqtls_df["gene"].fillna(all_eqtls_df["ens_id"].str.lower())
    # lowercase lookup by map: case-insensitive, and immune to duplicate gene
    # symbols (a merge would silently expand/misalign rows)
    strand_by_gene = all_eqtls_df.drop_duplicates("gene").set_index("gene")["strand"]
    eqtls_df["strand"] = eqtls_df["name"].str.lower().map(strand_by_gene)

    # validate every eQTL row and build the (ref, alt) sequence pairs first,
    # then predict all pairs through batched runner calls — per-pair dispatch
    # would pay the fixed host<->device round-trip once per eQTL for a few ms
    # of compute
    genes, pairs = [], []
    for _, eqtl in eqtls_df.iterrows():
        gene = str(eqtl["name"]).lower()
        strand = eqtl["strand"]
        records = list(parse_fasta(f"{consensus_dir}/{gene}/ref.fa"))
        if len(records) != 1:
            raise AssertionError(f"Expected 1 record in ref.fa for {gene}")
        rec_id, raw_seq = records[0]
        ref_seq = pad_enformer_seq(rec_id, raw_seq)

        # validate the eQTL table against the consensus record
        ref_chr = int(rec_id.split("|")[0].split(":")[0].replace("chr", ""))
        interval = rec_id.split(":")[1]
        # negative-start intervals keep their sign (chromosome-edge records;
        # same parse as pad_enformer_seq)
        ref_start = -int(interval.split("-")[-2]) if interval.startswith("-") else int(interval.split("-")[0])
        if int(eqtl["CHR_SNP"]) != ref_chr:
            raise AssertionError("Chromosomes do not match between eQTL df and ref fasta id")
        if int(eqtl["TSSpos_x"]) != ref_start + len(ref_seq) // 2:
            raise AssertionError("TSSpos in eQTL file not consistent with fasta record")

        tss_i = len(ref_seq) // 2
        snp_i = int(tss_i - (eqtl["TSSpos_x"] - eqtl["SNPpos"]))
        if ref_seq[snp_i] != eqtl["REF"]:
            raise AssertionError("Ref sequence does not match ref allele")
        alt_seq = ref_seq[:snp_i] + str(eqtl["ALT"]) + ref_seq[snp_i + 1 :]

        genes.append(eqtl["name"])
        pairs.append(((ref_seq, strand), (alt_seq, strand)))

    ref_feat_list, alt_feat_list = [], []
    for i in range(0, len(pairs), pairs_per_call):
        chunk = pairs[i : i + pairs_per_call]
        feats = _predict_consensus_features(runner, [sq for pair in chunk for sq in pair], shifts)
        ref_feat_list.extend(feats[0::2])
        alt_feat_list.extend(feats[1::2])

    ref_feats = _match_features(np.stack(ref_feat_list), bst)
    alt_feats = _match_features(np.stack(alt_feat_list), bst)
    ref_out = bst.predict(ref_feats)
    alt_out = bst.predict(alt_feats)

    # the per-gene h5 layout is keyed by gene name alone (reference
    # geuvadis_sed_for_top_eqtls.py:129-135) — with several eQTLs on one
    # gene, later rows overwrite earlier h5s (the returned DataFrame keeps
    # every row); warn instead of silently matching that reference quirk
    dupes = pd.Series(genes).value_counts()
    dupes = dupes[dupes > 1]
    if len(dupes):
        import warnings

        warnings.warn(
            f"multiple eQTLs share a gene name ({', '.join(dupes.index[:5])}); "
            "per-gene h5 outputs keep only the last eQTL per gene (reference "
            "layout) — use the returned DataFrame for all rows",
            stacklevel=2,
        )
    import h5py

    for i, gene in enumerate(genes):
        preds_dir = f"{out_dir}/{gene}"
        os.makedirs(preds_dir, exist_ok=True)
        with h5py.File(f"{preds_dir}/{gene}.h5", "w") as f:
            f.create_dataset("ref_preds", data=ref_out[i])
            f.create_dataset("alt_preds", data=alt_out[i])

    return pd.DataFrame({"gene": genes, "ref_pred": ref_out, "alt_pred": alt_out, "sed": alt_out - ref_out})
