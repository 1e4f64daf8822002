"""CLI: build the variant-gene association file
(``python -m expecto_tpu_torch.cli.closest_genes``; the arguments of
``expecto_tpu.cli.closest_genes``, reference make_closest_genes_file.py).

Host code only. Writes ``closest_genes.tsv`` (the ``--geneFile`` of
``cli.score`` and ``cli.predict``), ``snps_hg19.vcf`` (the VCF with one row
per association, the ``--coorFile`` of ``cli.predict``) and
``snps_expanded.vcf`` under ``-o``.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Build closest-gene association file for a VCF")
    p.add_argument("vcf_file")
    p.add_argument("--annoFile", default="./resources/geneanno.csv")
    p.add_argument("--all_in_receptive_field", action="store_true",
                   help="associate every gene whose receptive field covers the variant (not just the closest)")
    p.add_argument("--add_chr_prefix", action="store_true",
                   help="accepted for parity (make_closest_genes_file.py:29-30); chromosome names "
                        "are always standardized to the chr-prefixed form here")
    p.add_argument("-o", dest="out_dir", default="closest_genes_out")
    args = p.parse_args(argv)

    import pandas as pd

    from ..genome.closest_genes import make_closest_genes_table
    from ..genome.vcf import read_vcf, standardize_chroms, write_vcf_hg19

    os.makedirs(args.out_dir, exist_ok=True)
    vcf = standardize_chroms(read_vcf(args.vcf_file))
    geneanno = pd.read_csv(args.annoFile, index_col=0)
    genes, vcf_out = make_closest_genes_table(vcf, geneanno, all_in_receptive_field=args.all_in_receptive_field)
    genes.to_csv(f"{args.out_dir}/closest_genes.tsv", sep="\t", index=False, header=False)
    # snps_hg19.vcf with the gene table's multiplicity
    # (make_closest_genes_file.py:35-39,66)
    write_vcf_hg19(vcf_out, f"{args.out_dir}/snps_hg19.vcf")
    vcf_out.to_csv(f"{args.out_dir}/snps_expanded.vcf", sep="\t", index=False, header=False)
    print(f"wrote {args.out_dir}/closest_genes.tsv ({genes.shape[0]} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
