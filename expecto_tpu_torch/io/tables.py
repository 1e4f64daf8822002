"""Readers for the resource tables the CLIs read.

- ``geneanno.csv``: 24,338 genes, columns id, symbol, seqnames, strand, TSS,
  CAGE_representative_TSS, type (resources/geneanno.csv:1).
- ``deepsea_beluga_2002_features.tsv``: 2,002 chromatin marks with Cell
  type / Assay / Treatment / Assay type / Source columns.
- ``modellist``: header + 218 tissue model rows (ModelName\\tTissue).
- closest-gene files: the 11-column BEDOPS/``make_closest_genes_file.py``
  layout — snp bed(3) + ref + alt + tss bed(3) + strand + ens_id +
  dist_to_tss (example/example.vcf.bed.sorted.bed.closestgene).
"""

from __future__ import annotations

import os

import pandas as pd


def load_geneanno(path: str | os.PathLike) -> pd.DataFrame:
    return pd.read_csv(path)


def load_beluga_features(path: str | os.PathLike) -> pd.DataFrame:
    """Load the 2,002-mark metadata and add the combined label column the
    reference builds everywhere (predict.py:63-64)."""
    df = pd.read_csv(path, sep="\t", index_col=0)
    df["Assay type + assay + cell type"] = df["Assay type"] + "/" + df["Assay"] + "/" + df["Cell type"]
    return df


def load_modellist(path: str | os.PathLike) -> pd.DataFrame:
    """ModelName/Tissue table driving multi-model SED output (README.md:25)."""
    return pd.read_csv(path, sep="\t")


def load_closest_genes(path: str | os.PathLike) -> pd.DataFrame:
    """Read a closest-gene association file (tab-separated, headerless).

    The SED scorer uses positional columns from the end: strand at -3, gene id
    at -2, signed distance at -1 (predict.py:242-246).
    """
    return pd.read_csv(path, sep="\t", header=None, comment="#")
