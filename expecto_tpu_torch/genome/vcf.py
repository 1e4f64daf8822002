"""VCF ingestion matching the reference's pandas-based reader.

Reference semantics (chromatin.py:211-241):
    - ``pd.read_csv(path, sep='\\t', header=None, comment='#')`` — no header,
      hash lines skipped, columns by position: 0=chrom, 1=pos, 2=id, 3=ref,
      4=alt.
    - optional chunk slice ``iloc[chunk_i*chunk_size : (chunk_i+1)*chunk_size]``.
    - chrom standardization ``'chr' + str(c).replace('chr','')`` then filter to
      the 24 canonical chromosomes.
    - the (possibly lifted-over) VCF is re-emitted with a VCFv4.3 header as
      ``snps_hg19.vcf``.
"""

from __future__ import annotations

import os

import pandas as pd

CHRS = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]


def read_vcf(path: str | os.PathLike, chunk_size: int | None = None, chunk_i: int | None = None) -> pd.DataFrame:
    """Read a (headerless) VCF; optionally slice to a row chunk."""
    vcf = pd.read_csv(path, sep="\t", header=None, comment="#")
    if chunk_i is not None:
        if chunk_size is None:
            raise ValueError("chunk_i given without chunk_size")
        vcf = vcf.iloc[chunk_i * chunk_size : (chunk_i + 1) * chunk_size]
    return vcf


def standardize_chroms(vcf: pd.DataFrame) -> pd.DataFrame:
    """'chr'-prefix chrom names and filter to canonical chromosomes."""
    vcf = vcf.copy()
    vcf.iloc[:, 0] = "chr" + vcf.iloc[:, 0].map(str).str.replace("chr", "")
    return vcf[vcf.iloc[:, 0].isin(CHRS)]


def write_vcf_hg19(vcf: pd.DataFrame, path: str | os.PathLike) -> None:
    """Emit the lifted/raw VCF with the reference's VCFv4.3 header
    (chromatin.py:232-237)."""
    with open(path, "w") as f:
        print("##fileformat=VCFv4.3", file=f)
        print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO", file=f)
    vcf.to_csv(path, sep="\t", header=False, index=False, mode="a")
