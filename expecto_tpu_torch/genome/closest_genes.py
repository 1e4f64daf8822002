"""Variant-gene association builders (port of
expecto_tpu/genome/closest_genes.py; reference make_closest_genes_file.py
:46-108): the closest representative TSS per variant, or every gene whose
receptive field covers the variant, in the 11-column closest-gene layout
that the SED scorers read (``--geneFile``). Host code only."""

from __future__ import annotations

import numpy as np
import pandas as pd

from .windows import gene_shifts


def find_closest_gene(snp_chrom: str, snp_pos: int, geneanno: pd.DataFrame) -> pd.DataFrame:
    """Row of the closest CAGE representative TSS on the variant's chromosome
    (make_closest_genes_file.py:69-78)."""
    sub = geneanno.loc[geneanno["seqnames"] == snp_chrom].copy()
    sub["dists"] = sub["CAGE_representative_TSS"] - snp_pos
    closest_i = int(np.argmin(np.abs(sub["dists"]).values))
    return sub.iloc[closest_i : closest_i + 1]


def is_in_receptive_field(dist: float, strand: str, shifts: np.ndarray, windowsize: int = 1000) -> bool:
    """Receptive-field membership test (make_closest_genes_file.py:103-108).

    ``windowsize=1000`` is the reference's hard-coded value
    (make_closest_genes_file.py:93), though the feature windows are 2,000
    bp: its receptive field is about 500 bp short on each edge, kept for
    association-table parity. Pass 2000 for the geometrically correct
    field."""
    start, stop = _receptive_field_bounds(strand, shifts, windowsize)
    return start <= -dist <= stop


def _receptive_field_bounds(strand: str, shifts: np.ndarray, windowsize: int = 1000) -> tuple[int, int]:
    """[start, stop] of -dist values inside the receptive field: they depend
    only on the strand (two bound pairs for the standard shift grid)."""
    s = 1 if strand == "+" else -1
    start = int(np.min((shifts * s) - int(windowsize / 2 - 1)))
    stop = int(np.max((shifts * s) + int(windowsize / 2)))
    return start, stop


def get_genes_in_receptive_field(snp_chrom: str, snp_pos: int, geneanno: pd.DataFrame) -> pd.DataFrame:
    """Every gene whose receptive field covers the variant; the closest gene
    when none does (make_closest_genes_file.py:81-100).

    The field's bounds depend only on the strand, so membership is one
    boolean mask over the chromosome's genes, not a per-gene
    :func:`is_in_receptive_field` call."""
    sub = geneanno.loc[geneanno["seqnames"] == snp_chrom].copy()
    sub["dists"] = sub["CAGE_representative_TSS"] - snp_pos
    shifts = np.asarray(gene_shifts())
    plus_lo, plus_hi = _receptive_field_bounds("+", shifts)
    minus_lo, minus_hi = _receptive_field_bounds("-", shifts)
    plus = sub["strand"].values == "+"
    lo = np.where(plus, plus_lo, minus_lo)
    hi = np.where(plus, plus_hi, minus_hi)
    neg_dists = -sub["dists"].values
    sub_rf = sub[(lo <= neg_dists) & (neg_dists <= hi)]
    if sub_rf.empty:
        closest_i = int(np.argmin(np.abs(sub["dists"]).values))
        sub_rf = sub.iloc[closest_i : closest_i + 1]
    return sub_rf


def make_closest_genes_table(
    vcf: pd.DataFrame,
    geneanno: pd.DataFrame,
    *,
    all_in_receptive_field: bool = False,
) -> tuple[pd.DataFrame, pd.DataFrame]:
    """(closest_gene_df, expanded_vcf_df): the 11-column association table
    and the VCF with one row per (variant, gene)
    (make_closest_genes_file.py:40-67). ``geneanno`` is indexed by gene id."""
    vcf_rows, gene_rows = [], []
    for _, row in vcf.iterrows():
        snp_chrom, snp_pos, ref, alt = row.iloc[0], int(row.iloc[1]), row.iloc[3], row.iloc[4]
        if all_in_receptive_field:
            genes_df = get_genes_in_receptive_field(snp_chrom, snp_pos, geneanno)
        else:
            genes_df = find_closest_gene(snp_chrom, snp_pos, geneanno)
        for ens_id, g in genes_df.iterrows():
            tss_pos = int(g["CAGE_representative_TSS"])
            vcf_rows.append(row)
            gene_rows.append(
                [
                    str(snp_chrom)[3:], snp_pos - 1, snp_pos, ref, alt,
                    str(g["seqnames"])[3:], tss_pos - 1, tss_pos, g["strand"], ens_id,
                    tss_pos - snp_pos,
                ]
            )
    cols = (
        "snp_chrom", "snp_pos_start", "snp_pos", "ref", "alt",
        "tss_chrom", "tss_pos_start", "tss_pos", "tss_strand", "ens_id", "dist_to_tss",
    )
    return pd.DataFrame(gene_rows, columns=cols), pd.DataFrame(vcf_rows).reset_index(drop=True)
