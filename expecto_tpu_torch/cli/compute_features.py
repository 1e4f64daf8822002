"""CLI: per-gene chromatin features on a CUDA GPU
(``python -m expecto_tpu_torch.cli.compute_features``; the arguments of
``expecto_tpu.cli.compute_features`` plus ``--device``; reference
compute_expecto_features.py / replicate_expecto_features.py flags).

Writes ``Xreducedall.2002.representative_tss_top.npy`` (n_genes, 20,020) in
``-o``; ``Xreducedall.2002.atac_x_chip.npy`` with ``--atac_peaks``; one
``{gene_id}.npy`` (200, 2,002) per gene with ``--replicate_raw``.

Default compute is fp32 with TF32 off and an fp32 wire (parity mode);
``--bf16`` runs bf16 compute with an fp16 wire for the features.

Under ``torchrun`` each rank computes its slice of the genes and rank 0
merges the feature shards (``--replicate_raw``: each rank writes its own
genes' files)::

    torchrun --standalone --nproc_per_node 2 -m expecto_tpu_torch.cli.compute_features ...
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Compute ExPecto chromatin features for a TSS list")
    p.add_argument("annoFile", help="geneanno.csv")
    p.add_argument("--tss_file", default=None, help="optional hg38 TSS override table (liftover via --chain_file)")
    p.add_argument("--chain_file", default=None)
    p.add_argument("--windowsize", type=int, default=2000)
    p.add_argument("--genome", type=str, default="./resources/hg19.fa")
    p.add_argument("--beluga_weights", type=str, default="./resources/deepsea.beluga.npz")
    p.add_argument("--batchsize", type=int, default=3200,
                   help="windows-equivalent device batch (16 gene spans of 200 shifts)")
    p.add_argument("--replicate_raw", action="store_true",
                   help="save raw per-gene (200, 2002) predictions instead of projected features "
                        "(replicate_expecto_features.py behavior)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute and an fp16 wire (throughput mode)")
    p.add_argument("--atac_peaks", default=None,
                   help="ATAC peak BED: multiply predicted ChIP tracks by the binary "
                        "peak-bin mask before projection (expecto_intersect_chip_atac.py)")
    p.add_argument("--belugaFeatures", default=None, help="required with --atac_peaks")
    p.add_argument("--atac_tf_only", action="store_true",
                   help="mask only TF tracks (default: TF + Histone; expecto_intersect_chip_atac.py:46-48)")
    p.add_argument("-o", dest="out_dir", type=str, default="temp_compute_expecto_features")
    p.add_argument("--cuda", action="store_true", help="ignored (--device picks the device); kept for CLI parity")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; raises if no GPU is present)")
    return p


def lift_tss_overrides(geneanno, tss_file: str, chain_file: str):
    """geneanno with each gene's TSS replaced by its hg38 override lifted
    through ``chain_file``, where the override table marks it non-default and
    the position maps (compute_expecto_features.py:43-72); other genes keep
    the annotated TSS."""
    import pandas as pd

    from ..genome.liftover import ChainLiftover

    converter = ChainLiftover(chain_file)
    tss_df = pd.read_csv(tss_file, sep="\t", index_col=0).set_index("ens_id")
    overrides = {}
    for gene_id, row in tss_df.iterrows():
        coords = converter.convert_coordinate(str(row.iloc[0]), int(row.iloc[1]))
        if coords and not bool(row.iloc[-1]):
            overrides[gene_id] = (coords[0][0], coords[0][1])
    geneanno = geneanno.copy()
    for i, row in geneanno.iterrows():
        if row["id"] in overrides:
            geneanno.loc[i, "seqnames"], geneanno.loc[i, "CAGE_representative_TSS"] = overrides[row["id"]]
    return geneanno


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tss_file and not args.chain_file:
        print("--tss_file requires --chain_file", file=sys.stderr)
        return 2
    if args.atac_peaks and not args.belugaFeatures:
        print("--atac_peaks requires --belugaFeatures", file=sys.stderr)
        return 2

    import numpy as np
    import pandas as pd
    import torch

    from ..genome.fasta import FastaIndex
    from ..models.convert import load_params_npz
    from ..parallel.mesh import local_device, maybe_initialize_distributed
    from ..parallel.runner import BelugaRunner
    from ..pipeline.features import compute_gene_features, records_from_geneanno, replicate_gene_features

    # several ranks: join the process group before any CUDA work; each rank
    # then computes its slice of the genes (pipeline/features.py)
    maybe_initialize_distributed(args.device)
    runner = BelugaRunner(
        load_params_npz(args.beluga_weights),
        batch_size=args.batchsize,
        device=local_device(args.device),
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        # features are contracted in fp32 on the device; the fp16 wire
        # rounds them at about 5e-4 relative, host arrays stay fp32
        out_dtype=np.float16 if args.bf16 else np.float32,
        pipeline_depth=6,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    geneanno = pd.read_csv(args.annoFile)
    if args.tss_file:
        geneanno = lift_tss_overrides(geneanno, args.tss_file, args.chain_file)
    genes = records_from_geneanno(geneanno)

    genome = FastaIndex(args.genome)
    try:
        if args.atac_peaks:
            from ..analysis.atac import load_peaks_bed
            from ..io.tables import load_beluga_features
            from ..pipeline.features import compute_gene_features_atac

            features_df = load_beluga_features(args.belugaFeatures)
            assays = ["TF"] if args.atac_tf_only else ["TF", "Histone"]
            chip_idx = np.where(features_df["Assay type"].isin(assays))[0]
            compute_gene_features_atac(
                genes, genome, runner, load_peaks_bed(args.atac_peaks), chip_idx, windowsize=args.windowsize,
                out_path=os.path.join(args.out_dir, "Xreducedall.2002.atac_x_chip"), progress=True,
            )
        elif args.replicate_raw:
            replicate_gene_features(genes, genome, runner, windowsize=args.windowsize, out_dir=args.out_dir)
        else:
            compute_gene_features(
                genes, genome, runner, windowsize=args.windowsize,
                out_path=os.path.join(args.out_dir, "Xreducedall.2002.representative_tss_top"), progress=True,
            )
    finally:
        genome.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
