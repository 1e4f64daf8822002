"""Readers for the resource tables the serving CLI reads.

- ``modellist``: header + 218 tissue model rows (ModelName\\tTissue).
- closest-gene files: the 11-column BEDOPS/``make_closest_genes_file.py``
  layout — snp bed(3) + ref + alt + tss bed(3) + strand + ens_id +
  dist_to_tss (example/example.vcf.bed.sorted.bed.closestgene).
"""

from __future__ import annotations

import os

import pandas as pd


def load_modellist(path: str | os.PathLike) -> pd.DataFrame:
    """ModelName/Tissue table driving multi-model SED output (README.md:25)."""
    return pd.read_csv(path, sep="\t")


def load_closest_genes(path: str | os.PathLike) -> pd.DataFrame:
    """Read a closest-gene association file (tab-separated, headerless).

    The SED scorer uses positional columns from the end: strand at -3, gene id
    at -2, signed distance at -1 (predict.py:242-246).
    """
    return pd.read_csv(path, sep="\t", header=None, comment="#")
