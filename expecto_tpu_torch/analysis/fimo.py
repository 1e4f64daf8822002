"""Motif analysis: FIMO queries around variants and hypergeometric cluster
enrichment (port of expecto_tpu/analysis/fimo.py; reference
query_fimo_for_predictions.py, cluster_analysis_with_fimo.py:126-176,
get_enriched_motif_set.py:8-45).

FIMO itself is an external MEME-suite binary (as in the reference); the
query FASTA writer, output filter, enrichment statistics, and MEME-subset writer
are native here and testable without the binary. The null-model shuffle
draws from a ``np.random.RandomState`` its caller passes, in place of the
JAX package's draws from numpy's global state (the same stream).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from collections import defaultdict

import numpy as np
import pandas as pd
from scipy.stats import hypergeom

from ..genome.fasta import FastaIndex

FIMO_COLUMNS = [
    "motif_id", "motif_alt_id", "sequence_name", "start", "stop",
    "strand", "score", "p-value", "q-value", "matched_sequence",
]


def variant_query_seq(genome: FastaIndex, chrom: str, pos: int, ref: str, alt: str, bp_pad: int = 30) -> str:
    """+-bp_pad window around a variant with a genome-match assert
    (query_fimo_for_predictions.py:63-72)."""
    seq = genome.sequence(chrom, pos - bp_pad, pos + bp_pad).upper()
    window_ref = seq[bp_pad : bp_pad + len(ref)]
    window_alt = seq[bp_pad : bp_pad + len(alt)]
    if not (window_ref == ref.upper() or window_alt == alt.upper()):
        raise AssertionError("fasta does not match VCF")
    return seq


def write_fimo_input(vcf_df: pd.DataFrame, genome: FastaIndex, fasta_path: str, bp_pad: int = 30) -> None:
    """FASTA of variant windows, record ids = VCF ID column
    (query_fimo_for_predictions.py:33-41)."""
    with open(fasta_path, "w") as f:
        for _, row in vcf_df.iterrows():
            seq = variant_query_seq(genome, row.iloc[0], int(row.iloc[1]), str(row.iloc[3]), str(row.iloc[4]), bp_pad)
            print(f">{row.iloc[2]}", file=f)
            print(seq, file=f)


def run_fimo(motif_file: str, fasta_path: str, out_path: str, *, engine: str = "auto") -> str:
    """FIMO motif scan (--thresh 1 --text semantics,
    query_fimo_for_predictions.py:44-47). Returns the engine used.

    ``engine``: 'meme' invokes the MEME-suite binary (bit parity with the
    reference; raises if absent), 'builtin' uses the native scanner
    (:mod:`expecto_tpu_torch.analysis.motif_scan` — same published scoring
    model, p-values may differ in the last quantization digit), 'auto'
    prefers the binary and falls back to builtin with a warning."""
    have_binary = shutil.which("fimo") is not None
    if engine == "meme" or (engine == "auto" and have_binary):
        if not have_binary:
            raise RuntimeError("MEME suite 'fimo' binary not found on PATH (engine='meme')")
        with open(out_path, "w") as f:
            # argv list (no shell): paths with spaces/metacharacters stay one
            # token; check=True surfaces a failing fimo instead of leaving a
            # truncated table for downstream enrichment to mis-count
            subprocess.run(["fimo", "--thresh", "1", "--text", motif_file, fasta_path], stdout=f, check=True)
        return "meme"
    if engine not in ("auto", "builtin"):
        raise ValueError(f"unknown fimo engine {engine!r}")
    if engine == "auto":
        import warnings

        warnings.warn(
            "MEME 'fimo' binary not on PATH; using the built-in scanner "
            "(same published scoring model; p-values can differ from the "
            "binary's in the last quantization digit)",
            stacklevel=2,
        )
    from .motif_scan import scan_to_text

    scan_to_text(motif_file, fasta_path, out_path)
    return "builtin"


def filter_fimo_results(fimo_out_path: str, bp_pad: int = 30) -> pd.DataFrame:
    """Keep matches covering the variant position; best p-value per
    motif-variant pair (query_fimo_for_predictions.py:50-58).

    Handles both MEME 4.x ('#'-commented header) and MEME >=5 --text output,
    whose header row is uncommented ('motif_id\\tmotif_alt_id\\t...')."""
    df = pd.read_table(fimo_out_path, sep="\t", names=FIMO_COLUMNS, comment="#")
    if len(df) and str(df.iloc[0, 0]) == "motif_id":  # uncommented MEME>=5 header
        df = df.iloc[1:].copy()
        # the header row forced every column to object: restore ALL numeric
        # columns (score/q-value too), not just the ones this filter touches —
        # downstream numeric consumers must never compare strings
        for col in ("start", "stop", "score", "p-value", "q-value"):
            if col in df.columns:
                df[col] = pd.to_numeric(df[col], errors="coerce")
        df = df.astype({"start": np.int64, "stop": np.int64})
    df = df[(df["start"] <= (bp_pad + 1)) & (df["stop"] >= (bp_pad + 1))]
    return df.sort_values(by="p-value").drop_duplicates(subset=["motif_id", "motif_alt_id", "sequence_name"], keep="first")


def cluster_contribs_hypergeom(
    cluster_contribs_df: pd.DataFrame,
    fimo_df: pd.DataFrame,
    rsat_clusters_df: pd.DataFrame,
    n_neg_clusters: int = 20,
    *,
    id_col: int = 2,
    contrib_start_col: int = 15,
    return_unique_clusters: bool = False,
):
    """Hypergeometric test of motif matches in top-contributing vs bottom-N
    RSAT clusters (cluster_analysis_with_fimo.py:126-176).

    For each rank cutoff k: counts FIMO matches among the k-th-ranked
    cluster's motifs vs the bottom ``n_neg_clusters`` clusters' motifs,
    pooled over variants, and computes the survival-function p-value.
    """
    hypergeom_data = {"top_cluster_idx": [], "hypergeom_pval": []}
    unique_clusters = defaultdict(set)

    # hoist everything independent of the rank cutoff: per-row contribution
    # rankings, per-cluster motif sets, per-variant FIMO match counters, and
    # the per-row bottom-N negative counts. The reference recomputes all of
    # these inside the cutoff loop (cluster_analysis_with_fimo.py:126-176),
    # i.e. O(cutoffs x rows) of heavy pandas work.
    ranked: list[tuple[object, list]] = []
    for _, row in cluster_contribs_df.iterrows():
        contribs = row.iloc[contrib_start_col:].sort_values(ascending=False, key=np.abs)
        ranked.append((row.iloc[id_col], list(contribs.index)))

    cluster_motifs = {
        name: set(sum([str(x).split(",") for x in np.atleast_1d(rsat_clusters_df.loc[name]).tolist()], []))
        for name in rsat_clusters_df.index
    }
    fimo_counts = {
        rsid: sub["motif_alt_id"].value_counts().to_dict()
        for rsid, sub in fimo_df.groupby("sequence_name")
    }

    def n_matches(rsid, motifs):
        counts = fimo_counts.get(rsid)
        if not counts:
            return 0
        return sum(c for m, c in counts.items() if m in motifs)

    neg_info = []
    for rsid, order in ranked:
        bottom = order[-n_neg_clusters:]
        neg_motifs = set().union(*(cluster_motifs[b] for b in bottom)) if bottom else set()
        neg_info.append((n_matches(rsid, neg_motifs), len(neg_motifs)))

    for top_cluster_idx in range(rsat_clusters_df.shape[0] - n_neg_clusters):
        n_pos_matches = n_pos_motifs = n_neg_matches = n_neg_motifs = 0
        for (rsid, order), (negm, negn) in zip(ranked, neg_info):
            cluster_i = order[top_cluster_idx]
            if return_unique_clusters:
                unique_clusters[top_cluster_idx] |= set(order[: top_cluster_idx + 1])
            pos_motifs = cluster_motifs[cluster_i]
            n_pos_matches += n_matches(rsid, pos_motifs)
            n_pos_motifs += len(pos_motifs)
            n_neg_matches += negm
            n_neg_motifs += negn

        k, M, n, N = n_pos_matches, n_pos_motifs + n_neg_motifs, n_pos_motifs, n_pos_matches + n_neg_matches
        hypergeom_data["top_cluster_idx"].append(top_cluster_idx)
        hypergeom_data["hypergeom_pval"].append(hypergeom.sf(k - 1, M, n, N))

    df = pd.DataFrame(hypergeom_data)
    if return_unique_clusters:
        return df, unique_clusters
    return df


def shuffle_along_axis(a: np.ndarray, axis: int, rng: np.random.RandomState) -> np.ndarray:
    """Null-model shuffle (cluster_analysis_with_fimo.py:178-180), drawn
    from ``rng``."""
    idx = rng.rand(*a.shape).argsort(axis=axis)
    return np.take_along_axis(a, idx, axis=axis)


def extract_enriched_motif_set(hypergeom_tsv: str, motif_db_file: str, out_path: str, qval_thresh: float = 0.01) -> set:
    """Write the MEME subset of motifs passing the q-value threshold
    (get_enriched_motif_set.py:8-45)."""
    enrichment_df = pd.read_csv(hypergeom_tsv, sep="\t", index_col=0)
    motif_set = set(enrichment_df[enrichment_df["hypergeom_qval"] < qval_thresh].index)

    with open(motif_db_file) as f:
        lines = f.readlines()

    motifs_found = set()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as out_file:
        write_mode = True
        for line in lines:
            line = line.strip()
            if line[:5] != "MOTIF" and write_mode:
                print(line, file=out_file)
            elif line[:5] == "MOTIF":
                write_mode = False
                parts = line.split()
                motif_id = parts[1]
                if motif_id in motif_set:
                    motifs_found.add(motif_id)
                    write_mode = True
                    print(line, file=out_file)
    if motif_set != motifs_found:
        raise AssertionError("Did not find all motifs in enriched motif set in the motif db file")
    return motifs_found
