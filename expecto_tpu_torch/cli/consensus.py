"""CLI: GEUVADIS consensus prediction pipelines on a CUDA GPU
(``python -m expecto_tpu_torch.cli.consensus {samples,ref,eqtl-sed,top-eqtls}``;
the subcommands and flags of ``expecto_tpu.cli.consensus`` plus ``--device``;
reference geuvadis_predict_consensus.py / geuvadis_predict_ref_all_genes.py /
geuvadis_sed_for_top_eqtls.py flags).

Default compute is fp32 with TF32 off and an fp32 wire (parity mode);
``--bf16`` runs bf16 compute; ``--fp16_chromatin`` fetches and stores
``chromatin_preds`` (and the runner's wire) in fp16. ``samples``,
``eqtl-sed`` and ``top-eqtls`` write h5 files and need h5py; ``ref`` writes
only ``ref_preds.csv``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict expression for consensus sequences")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("expecto_model")
        sp.add_argument("consensus_dir")
        sp.add_argument("--beluga_weights", type=str, default="./resources/deepsea.beluga.npz")
        sp.add_argument("--batch_size", type=int, default=1024)
        sp.add_argument("--bf16", action="store_true", help="bfloat16 compute (default fp32, TF32 off)")
        sp.add_argument("-o", dest="out_dir", type=str, default="temp_predict_consensus")
        sp.add_argument("--device", default="cuda", help="torch device (default cuda; raises if no GPU is present)")

    sp = sub.add_parser("samples", help="per-individual consensus predictions (C18)")
    common(sp)
    sp.add_argument("genes_file")
    sp.add_argument("--overwrite", action="store_true")
    sp.add_argument("--exp_only", action="store_true")
    sp.add_argument("--num_chunks", type=int, default=None)
    sp.add_argument("--chunk_i", type=int, default=None)
    sp.add_argument("--genes", type=str, default=None,
                    help="comma-separated gene subset (replaces the reference's hard-coded top-eqtl gene list)")
    sp.add_argument("--fp16_chromatin", action="store_true",
                    help="fetch + store chromatin_preds as float16 (the format compress_consensus "
                         "produces anyway); halves the dominant transfer/disk traffic")
    sp.add_argument("--features_only", action="store_true",
                    help="skip the {gene}_chromatin.h5 entirely: decay features are projected on "
                         "device and the cohort rides the backbone-patched fast path. "
                         "Only the {gene}.h5 expecto_preds contract is written; incompatible "
                         "with --exp_only")

    rp = sub.add_parser("ref", help="reference-haplotype predictions for all genes (C19)")
    common(rp)
    rp.add_argument("genes_file")

    ep = sub.add_parser("eqtl-sed", help="eQTL SED on consensus backbones (C20)")
    common(ep)
    ep.add_argument("eur_top_eqtl_genes_csv")
    ep.add_argument("eqtls_csv")

    tp = sub.add_parser("top-eqtls", help="consensus predictions for the top-eqtl gene set, gzipped "
                                          "one-FASTA-per-gene layout (geuvadis_predict_consensus_for_top_eqtls.py)")
    common(tp)
    tp.add_argument("eqtls_df_file")
    tp.add_argument("snps_vcf")
    tp.add_argument("--genes", type=str, default=None,
                    help="comma-separated gene list (default: the reference's six hard-coded genes)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..models.convert import load_params_npz
    from ..parallel.runner import BelugaRunner
    from ..pipeline import consensus as c

    fp16 = getattr(args, "fp16_chromatin", False)
    runner = BelugaRunner(
        load_params_npz(args.beluga_weights),
        batch_size=args.batch_size,
        device=args.device,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        out_dtype=np.float16 if fp16 else np.float32,
    )
    if args.cmd == "samples":
        c.predict_consensus_genes(
            args.expecto_model, args.consensus_dir, args.genes_file, runner, args.out_dir,
            overwrite=args.overwrite, exp_only=args.exp_only,
            num_chunks=args.num_chunks, chunk_i=args.chunk_i,
            genes=args.genes.split(",") if args.genes else None, progress=True,
            chromatin_dtype=np.float16 if fp16 else np.float32,
            features_only=args.features_only,
        )
    elif args.cmd == "ref":
        c.predict_ref_all_genes(
            args.expecto_model, args.consensus_dir, args.genes_file, runner, args.out_dir, progress=True
        )
    elif args.cmd == "eqtl-sed":
        c.sed_for_top_eqtls(
            args.expecto_model, args.consensus_dir, args.eur_top_eqtl_genes_csv, args.eqtls_csv,
            runner, args.out_dir,
        )
    elif args.cmd == "top-eqtls":
        c.predict_consensus_for_top_eqtls(
            args.expecto_model, args.consensus_dir, args.eqtls_df_file, args.snps_vcf,
            runner, args.out_dir,
            genes=args.genes.split(",") if args.genes else None, progress=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
