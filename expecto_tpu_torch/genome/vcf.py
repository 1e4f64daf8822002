"""VCF ingestion matching the reference's pandas-based reader.

Reference semantics (chromatin.py:211-241):
    - ``pd.read_csv(path, sep='\\t', header=None, comment='#')`` — no header,
      hash lines skipped, columns by position: 0=chrom, 1=pos, 2=id, 3=ref,
      4=alt.
    - chrom standardization ``'chr' + str(c).replace('chr','')`` then filter to
      the 24 canonical chromosomes.
"""

from __future__ import annotations

import os

import pandas as pd

CHRS = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]


def read_vcf(path: str | os.PathLike) -> pd.DataFrame:
    """Read a (headerless) VCF."""
    return pd.read_csv(path, sep="\t", header=None, comment="#")


def standardize_chroms(vcf: pd.DataFrame) -> pd.DataFrame:
    """'chr'-prefix chrom names and filter to canonical chromosomes."""
    vcf = vcf.copy()
    vcf.iloc[:, 0] = "chr" + vcf.iloc[:, 0].map(str).str.replace("chr", "")
    return vcf[vcf.iloc[:, 0].isin(CHRS)]
