"""SED scoring: per-(variant, gene, tissue model) expression effects (port
of expecto_tpu/pipeline/sed.py).

Two contracts:

- **fused serving** (``score_sed_serving``, the ``expecto-score`` CLI):
  ``SED = pred(ALT) - pred(REF)`` of every tissue model, where ``pred`` is a
  gblinear model over decay-basis projected chromatin predictions (reference
  predict.py:70-280). One device pass replaces the two-script flow: no
  per-shift h5 intermediates, only per-model scalars leave the device.
- **h5 scorers** (``score_sed``, ``score_sed_multimodel``, the
  ``expecto-predict`` CLI), host numpy over the per-shift effects that
  ``expecto-chromatin`` writes: read the h5s averaging forward/RC halves,
  align variants with the closest-gene table, project per-shift effects
  into 20,020 decay features, apply the track keep-mask and predict.
  ``sed.tsv`` holds ``SED = pred(alt) - pred(ref)``; the ``--modelList``
  output holds the original ExPecto effect ``pred(0) - pred(diff)``, the
  opposite sign of the fused scorer's SED.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import pandas as pd

from ..genome.encode import alleles_to_flat_codes, reverse_complement_codes, seqs_to_codes
from ..genome.windows import fetch_variant_window, variant_shifts
from ..io.h5 import read_shift_h5_averaged
from ..io.xgb import load_expression_model
from ..models.gblinear import GBLinearModel
from ..ops.decay import N_BASIS, pad_legacy_20030, project_features, variant_basis
from ..parallel.runner import fp32_wire_kw
from ..utils.keep_mask import subset_features_by_mask
from .chromatin import (
    _gather_spans,
    _require_known_chromosomes,
    _scatter_alleles,
    _span_eligible,
    assemble_variant_spans,
)


def load_shift_effects(pattern: str, maxshift: int = 800) -> dict[str, np.ndarray]:
    """Load per-shift h5s by substituting SHIFT in ``pattern``
    (predict.py:173-194). Returns {'diff': (S,N,M), 'ref': ..., 'alt': ...};
    legacy files yield only 'diff'."""
    per_key: dict[str, list] = {}
    for shift in variant_shifts(maxshift):
        for k, v in read_shift_h5_averaged(pattern.replace("SHIFT", str(shift))).items():
            per_key.setdefault(k, []).append(v)
    return {k: np.stack(v, axis=0) for k, v in per_key.items()}


def get_num_repeats(genes_df: pd.DataFrame) -> list[int]:
    """Count consecutive rows per variant key in the closest-gene file
    (predict.py:202-213): maps N variants -> M (variant, gene) rows, as a
    vectorized run-length encoding over the 5-column key."""
    if genes_df.shape[0] == 0:
        return [0]
    key = genes_df.iloc[:, 0].astype(str)
    for c in range(1, 5):
        key = key + ":" + genes_df.iloc[:, c].astype(str)
    key = key.to_numpy()
    boundary = np.concatenate([[True], key[1:] != key[:-1]])
    starts = np.flatnonzero(boundary)
    lengths = np.diff(np.concatenate([starts, [len(key)]]))
    return lengths.tolist()


@dataclass
class SedInputs:
    """Aligned (variant, gene) rows ready for scoring."""

    coor: pd.DataFrame
    dist: np.ndarray
    strand: np.ndarray
    genename: np.ndarray
    effects: dict[str, np.ndarray]  # (S, M_rows, n_tracks) per key


def align_variants_with_genes(
    coor: pd.DataFrame,
    gene: pd.DataFrame,
    effects: dict[str, np.ndarray],
    fixeddist: int = 0,
) -> SedInputs:
    """Dedup + repeat-expansion alignment (predict.py:219-246)."""
    gene = gene.drop_duplicates(keep="first")
    coor_mask = ~coor.duplicated(keep="first")
    coor = coor[coor_mask]
    effects = {k: v[:, np.asarray(coor_mask), :] for k, v in effects.items()}

    repeats = get_num_repeats(gene)
    if sum(repeats) != gene.shape[0] or len(repeats) != coor.shape[0]:
        raise ValueError("Gene association file does not match the vcf file.")
    coor_new = pd.DataFrame(np.repeat(coor.values, repeats, axis=0))
    coor_new.columns = coor.columns
    effects = {k: np.repeat(v, repeats=repeats, axis=1) for k, v in effects.items()}

    if fixeddist == 0:
        dist = -np.asarray(gene.iloc[:, -1])
    else:
        dist = np.full(gene.shape[0], fixeddist)
    return SedInputs(
        coor=coor_new,
        dist=np.asarray(dist),
        strand=np.asarray(gene.iloc[:, -3]),
        genename=np.asarray(gene.iloc[:, -2]),
        effects=effects,
    )


def _project(inputs: SedInputs, maxshift: int, keep_mask: np.ndarray | None, n_tracks: int, keys=None):
    basis = variant_basis(inputs.dist, inputs.strand, variant_shifts(maxshift))  # (S, M, 10)
    use = inputs.effects if keys is None else {k: inputs.effects[k] for k in keys}
    feats = {k: project_features(basis, v) for k, v in use.items()}
    if keep_mask is not None:
        feats = {k: subset_features_by_mask(v, keep_mask, N_BASIS, n_tracks) for k, v in feats.items()}
    return feats


def _match_model_features(X: np.ndarray, model: GBLinearModel, n_tracks: int) -> np.ndarray:
    """Pad 20,020-dim features to the legacy 20,030 layout when the model was
    trained on 2,003-track predictions (original FunctionLab models;
    geuvadis_predict_consensus.py:122-124)."""
    if model.n_features == X.shape[1]:
        return X
    legacy = pad_legacy_20030(X, n_tracks)
    if model.n_features == legacy.shape[1]:
        return legacy
    raise ValueError(f"model expects {model.n_features} features, computed {X.shape[1]}")


@dataclass
class SedResult:
    table: pd.DataFrame
    sorted_by_magnitude: pd.DataFrame = field(default=None)
    sorted_by_proportion: pd.DataFrame = field(default=None)


def score_sed(
    effects: dict[str, np.ndarray],
    coor: pd.DataFrame,
    gene: pd.DataFrame,
    model: GBLinearModel,
    *,
    maxshift: int = 800,
    n_tracks: int = 2002,
    keep_mask: np.ndarray | None = None,
    fixeddist: int = 0,
    out_dir: str | os.PathLike | None = None,
) -> SedResult:
    """Single-model SED scoring -> sed.tsv and the two sorted tables (fork
    contract, predict.py:249-280)."""
    inputs = align_variants_with_genes(coor, gene, effects, fixeddist)
    have_refalt = "ref" in inputs.effects and "alt" in inputs.effects
    # fork-schema inputs (diff/ref/alt) report SED = ALT - REF only
    # (predict.py:264; the diff-based effect is dead code there), so the
    # diff tensor is not projected
    keys = ("ref", "alt") if have_refalt else ("diff",)
    feats = _project(inputs, maxshift, keep_mask, n_tracks, keys=keys)

    def predict(X):
        return model.predict(_match_model_features(X, model, n_tracks))

    if have_refalt:
        ref = predict(feats["ref"])
        alt = predict(feats["alt"])
        sed = alt - ref
    else:
        # legacy single-'pred' inputs carry no ref/alt tracks; SED falls back
        # to the diff-based effect (original ExPecto semantics). predict of
        # zero features is exactly base_score + bias
        base = np.full(feats["diff"].shape[0], model.base_score + model.bias, dtype=np.float32)
        effect = base - predict(feats["diff"])
        ref = np.zeros_like(effect)
        alt = np.zeros_like(effect)
        sed = -effect

    df = inputs.coor.copy()
    df["dist"] = inputs.dist
    df["gene"] = inputs.genename
    df["strand"] = inputs.strand
    df = pd.concat(
        [df.reset_index(), pd.DataFrame(ref, columns=["REF"]), pd.DataFrame(alt, columns=["ALT"]),
         pd.DataFrame(sed, columns=["SED"])],
        axis=1,
        ignore_index=False,
    )

    by_mag = df.copy()
    by_mag["SED_MAGNITUDES"] = np.abs(by_mag["SED"])
    by_mag = by_mag.sort_values(by="SED_MAGNITUDES", ascending=False)
    by_prop = df.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        prop = np.abs(by_prop["SED"] / ((by_prop["REF"] + by_prop["ALT"]) / 2))
    if not have_refalt:
        # legacy inputs carry REF=ALT=0: the proportion is undefined for every
        # row, so write NaN (sorted last) instead of an all-inf column
        prop = np.full_like(np.asarray(prop, dtype=np.float64), np.nan)
    by_prop["SED_PROPORTION"] = prop
    by_prop = by_prop.sort_values(by="SED_PROPORTION", ascending=False)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        df.to_csv(os.path.join(out_dir, "sed.tsv"), header=True, sep="\t", index=False)
        by_mag.to_csv(os.path.join(out_dir, "sed_sorted_by_magnitude.tsv"), header=True, sep="\t", index=False)
        by_prop.to_csv(os.path.join(out_dir, "sed_sorted_by_proportion.tsv"), header=True, sep="\t", index=False)
    return SedResult(table=df, sorted_by_magnitude=by_mag, sorted_by_proportion=by_prop)


def score_sed_multimodel(
    effects: dict[str, np.ndarray],
    coor: pd.DataFrame,
    gene: pd.DataFrame,
    model_paths: list[str],
    *,
    maxshift: int = 800,
    n_tracks: int = 2002,
    keep_mask: np.ndarray | None = None,
    fixeddist: int = 0,
    output_csv: str | os.PathLike | None = None,
    model_names: list[str] | None = None,
) -> pd.DataFrame:
    """Original-ExPecto multi-model contract: one log-fold-change column per
    tissue model, appended to the vcf columns (README.md:25-30). All model
    weight vectors are stacked into one (F, n_models) matrix, so the model
    list scores as one matmul.

    Each column is the reference's effect ``pred(0) - pred(diff) =
    -(X_diff @ w)`` (predict.py:156-157): minus the fused scorer's SED."""
    inputs = align_variants_with_genes(coor, gene, effects, fixeddist)
    feats = _project(inputs, maxshift, keep_mask, n_tracks, keys=("diff",))

    models = [load_expression_model(p) for p in model_paths]
    n_feats = {m.n_features for m in models}
    if len(n_feats) != 1:
        raise ValueError(f"models disagree on feature count: {sorted(n_feats)}")
    X_diff = _match_model_features(feats["diff"], models[0], n_tracks)
    W = np.stack([m.weight for m in models], axis=1)  # (F, n_models)
    sed_all = -(X_diff @ W)  # (M_rows, n_models); the bias cancels in pred(0) - pred(diff)

    df = inputs.coor.copy()
    df["dist"] = inputs.dist
    df["gene"] = inputs.genename
    df["strand"] = inputs.strand
    names = model_names or [os.path.basename(p) for p in model_paths]
    for j, name in enumerate(names):
        df[name] = sed_all[:, j]
    if output_csv is not None:
        df.to_csv(output_csv, header=True, index=False)
    return df


def _factorize_variant_rows(chroms, positions, refs, alts):
    """Factorize (chrom, pos, ref, alt) rows in first-occurrence order.
    Returns (row_uidx, uniq_first): per-row unique index and, per unique
    variant, the index of its first row."""
    row_uidx, _levels = pd.MultiIndex.from_arrays([chroms, positions, refs, alts]).factorize()
    row_uidx = row_uidx.astype(np.int64)
    ns = len(row_uidx)
    n_u = int(row_uidx.max()) + 1 if ns else 0
    uniq_first = np.empty(n_u, dtype=np.int64)
    uniq_first[row_uidx[::-1]] = np.arange(ns - 1, -1, -1)  # duplicate writes keep the FIRST occurrence
    return row_uidx, uniq_first


def _score_rows_via_windows(genome, runner, chroms, positions, refs, alts, shifts, basis_rows, W, bias, inputsize):
    """Serving fallback for span-INeligible rows: the reference's per-window
    fetch+splice+center-crop semantics (chromatin.py:175-209, including the
    clamped fetch at contig edges that the span path cannot reproduce),
    fwd/RC averaged, decay-projected and scored against the stacked model
    matrix on the host. Windows are fetched once per unique variant and all
    (shift, allele, orientation) windows go through one predict call."""
    row_uidx, uniq_first = _factorize_variant_rows(chroms, positions, refs, alts)
    u = len(uniq_first)
    n_shifts = len(shifts)
    ref_seqs, alt_seqs = [], []
    for s in shifts:
        for i in uniq_first:
            w = fetch_variant_window(genome, chroms[i], positions[i], refs[i], alts[i], shift=s, inputsize=inputsize)
            ref_seqs.append(w.ref_seq)
            alt_seqs.append(w.alt_seq)
    ref_codes = seqs_to_codes(ref_seqs, inputsize)  # (S*u, L), shift-major
    alt_codes = seqs_to_codes(alt_seqs, inputsize)
    fused = np.concatenate(
        [ref_codes, alt_codes, reverse_complement_codes(ref_codes), reverse_complement_codes(alt_codes)], axis=0
    )
    # fp32 wire whatever the runner's fetch dtype: SED is differenced on the
    # host below, and independently fp16-rounded sides would bury small
    # effects under rounding noise
    preds = runner.predict_codes(fused, **fp32_wire_kw(runner)).astype(np.float32)
    blocks = preds.reshape(4, n_shifts, u, preds.shape[-1])
    p_ref = (blocks[0] + blocks[2]) * 0.5  # (S, u, M)
    p_alt = (blocks[1] + blocks[3]) * 0.5
    feats_ref = project_features(basis_rows, p_ref[:, row_uidx])
    feats_alt = project_features(basis_rows, p_alt[:, row_uidx])
    REF = (feats_ref @ W + bias).astype(np.float32)
    ALT = (feats_alt @ W + bias).astype(np.float32)
    return REF, ALT, ALT - REF


def _stacked_models(model_paths: list[str]):
    """All tissue models as one (N_BASIS*2002, K) weight matrix and (K,)
    bias (base_score included); legacy 20,030-feature models drop their
    per-basis zero column."""
    models = [load_expression_model(p) for p in model_paths]
    n_feats = {m.n_features for m in models}
    if len(n_feats) != 1:
        raise ValueError(f"models disagree on feature count: {sorted(n_feats)}")
    nf = n_feats.pop()
    if nf == N_BASIS * 2002:
        W = np.stack([m.weight for m in models], axis=1)
    elif nf == N_BASIS * 2003:
        W = np.stack([m.weight.reshape(N_BASIS, 2003)[:, 1:].reshape(-1) for m in models], axis=1)
    else:
        raise ValueError(f"unsupported model feature count {nf}")
    bias = np.array([m.bias + m.base_score for m in models], dtype=np.float32)
    return W, bias


def score_sed_serving(
    vcf: pd.DataFrame,
    gene: pd.DataFrame,
    genome,
    runner,
    model_paths: list[str],
    *,
    maxshift: int = 800,
    inputsize: int = 2000,
    fixeddist: int = 0,
    model_names: list[str] | None = None,
    output_csv: str | os.PathLike | None = None,
) -> pd.DataFrame:
    """End-to-end fused SED serving: VCF -> spans -> Beluga (span-amortized,
    conv shared across shifts) -> on-device decay projection -> all models in
    one matmul -> REF/ALT/SED per (variant, gene, model).

    Every row is served: span-eligible substitutions ride the packed +
    incremental-patch path; span-eligible indels ship both crop-adjusted
    spliced spans through the pair path (rows deduplicated per unique
    variant like substitutions); span-INeligible rows (shift windows
    crossing a contig edge, allele lengths beyond the span crop arithmetic)
    take the reference's per-window path in-process.
    """
    _require_known_chromosomes(genome, vcf.iloc[:, 0].astype(str).values)

    # align (variant, gene) rows exactly like the h5 path
    dummy = {"diff": np.zeros((1, vcf.shape[0], 1), np.float32)}
    inputs = align_variants_with_genes(vcf, gene, dummy, fixeddist)

    shifts = variant_shifts(maxshift)
    offsets = tuple(sh + maxshift for sh in shifts)
    span_len = 2 * maxshift + inputsize
    half = int(inputsize / 2 - 1)
    mutpos = maxshift + half

    chroms = inputs.coor.iloc[:, 0].astype(str).values
    positions = inputs.coor.iloc[:, 1].astype(int).values
    row_refs = inputs.coor.iloc[:, 3].astype(str).values
    row_alts = inputs.coor.iloc[:, 4].astype(str).values
    n = len(positions)

    basis = variant_basis(inputs.dist, inputs.strand, shifts)  # (S, n, 10)
    W, bias = _stacked_models(model_paths)
    k = W.shape[1]
    REF = np.empty((n, k), dtype=np.float32)
    ALT = np.empty((n, k), dtype=np.float32)
    SED = np.empty((n, k), dtype=np.float32)

    row_is_sub = (
        np.fromiter((len(r) == len(a) for r, a in zip(row_refs, row_alts)), bool, n) if n else np.zeros(0, bool)
    )
    row_elig = (
        _span_eligible(genome, chroms, positions, row_refs, row_alts, maxshift, inputsize)
        if n else np.zeros(0, bool)
    )
    sub_rows = np.nonzero(row_is_sub & row_elig)[0]
    ind_rows = np.nonzero(~row_is_sub & row_elig)[0]
    win_rows = np.nonzero(~row_elig)[0]

    if sub_rows.size:
        # the conv stack runs once per UNIQUE variant, rows gather on the
        # device; substitutions ship one packed span + the alt allele codes
        s_chroms, s_pos = chroms[sub_rows], positions[sub_rows]
        s_refs, s_alts = row_refs[sub_rows], row_alts[sub_rows]
        row_uidx, uniq_first = _factorize_variant_rows(s_chroms, s_pos, s_refs, s_alts)
        n_u = len(uniq_first)
        u_rows = np.arange(n_u)
        ref_spans = _gather_spans(genome, s_chroms[uniq_first], s_pos[uniq_first] - maxshift - half, span_len)
        ref_codes, ref_lens = alleles_to_flat_codes(s_refs[uniq_first])
        _scatter_alleles(ref_spans, u_rows, ref_codes, ref_lens, np.full(n_u, mutpos))
        alt_codes, alt_lens = alleles_to_flat_codes(s_alts[uniq_first])
        alt_alleles = np.full((n_u, int(alt_lens.max())), -1, dtype=np.int8)  # -1 keeps the ref base
        _scatter_alleles(alt_alleles, u_rows, alt_codes, alt_lens, np.zeros(n_u, np.int64))

        s_basis = np.ascontiguousarray(basis[:, sub_rows])
        if bool(np.all(np.diff(row_uidx) >= 0)):
            R, A, S = runner.score_variant_spans_packed_rows(
                ref_spans, mutpos, alt_alleles, offsets, s_basis, row_uidx, W, bias
            )
        else:
            # non-contiguous rows of one variant: expand and run per row
            R, A, S = runner.score_variant_spans_packed(
                ref_spans[row_uidx], mutpos, alt_alleles[row_uidx], offsets, s_basis, W, bias
            )
        REF[sub_rows], ALT[sub_rows], SED[sub_rows] = R, A, S

    if ind_rows.size:
        # indels: the alt span is crop-shifted relative to ref, so both
        # spliced spans ship and ride the pair path, once per unique variant
        i_chroms, i_pos = chroms[ind_rows], positions[ind_rows]
        i_refs, i_alts = row_refs[ind_rows], row_alts[ind_rows]
        row_uidx, uniq_first = _factorize_variant_rows(i_chroms, i_pos, i_refs, i_alts)
        r_spans, a_spans = assemble_variant_spans(
            genome, i_chroms[uniq_first], i_pos[uniq_first], i_refs[uniq_first], i_alts[uniq_first],
            maxshift, inputsize,
        )
        i_basis = np.ascontiguousarray(basis[:, ind_rows])
        if bool(np.all(np.diff(row_uidx) >= 0)):
            R, A, S = runner.score_variant_span_pairs_rows(r_spans, a_spans, offsets, i_basis, row_uidx, W, bias)
        else:
            R, A, S = runner.score_variant_spans(r_spans[row_uidx], a_spans[row_uidx], offsets, i_basis, W, bias)
        REF[ind_rows], ALT[ind_rows], SED[ind_rows] = R, A, S

    if win_rows.size:
        R, A, S = _score_rows_via_windows(
            genome, runner, chroms[win_rows], positions[win_rows], row_refs[win_rows], row_alts[win_rows],
            shifts, np.ascontiguousarray(basis[:, win_rows]), W, bias, inputsize,
        )
        REF[win_rows], ALT[win_rows], SED[win_rows] = R, A, S

    df = inputs.coor.copy()
    df["dist"] = inputs.dist
    df["gene"] = inputs.genename
    df["strand"] = inputs.strand
    names = model_names or [os.path.basename(p) for p in model_paths]
    cols = {}
    for j, name in enumerate(names):
        cols[f"REF_{name}"] = REF[:, j]
        cols[f"ALT_{name}"] = ALT[:, j]
        # the device-computed difference, not ALT - REF re-derived on host
        cols[name] = SED[:, j]
    df = pd.concat([df, pd.DataFrame(cols, index=df.index)], axis=1)
    if output_csv is not None:
        df.to_csv(output_csv, header=True, index=False)
    return df
