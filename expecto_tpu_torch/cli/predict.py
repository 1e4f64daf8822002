"""CLI: SED scoring over the per-shift h5s, the second half of the h5
contract (``python -m expecto_tpu_torch.cli.predict``; the arguments of
``expecto_tpu.cli.predict``: reference predict.py flags plus the
original-ExPecto ``--modelList``/``--output`` multi-model contract,
README.md:25-30).

Host numpy only: no device code runs here. ``--model_save_file`` writes
``sed.tsv`` (SED = pred(alt) - pred(ref)) and the two sorted tables under
``-o``; ``--modelList`` writes ``--output`` with one column per model
holding ``pred(0) - pred(diff)``, minus the SED of ``cli.score``.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict tissue-specific expression effects (SED)")
    p.add_argument("--model_save_file", type=str, default=None, help="single expression model (.save/.dump)")
    p.add_argument("--modelList", type=str, default=None, help="modellist tsv -> multi-model output csv")
    p.add_argument("--output", type=str, default="output.csv", help="output csv for --modelList mode")
    p.add_argument("--belugaFeatures", type=str, default=None)
    p.add_argument("--coorFile", "--coorFile_chromatin", dest="coorFile", type=str, required=True)
    p.add_argument("--rsat_clusters_tab", type=str, default=None,
                   help="accepted for parity; the reference's predict.py parses this flag but never uses it")
    p.add_argument("--geneFile", type=str, required=True)
    p.add_argument("--snpEffectFilePattern", type=str, required=True)
    p.add_argument("--nfeatures", type=int, default=2002)
    p.add_argument("--fixeddist", type=int, default=0)
    p.add_argument("--maxshift", type=int, default=800)
    p.add_argument("--batchSize", type=int, default=500, help="kept for CLI parity (scoring is one matmul)")
    p.add_argument("--threads", type=int, default=16, help="kept for CLI parity")
    p.add_argument("--splitIndex", type=int, default=0)
    p.add_argument("--splitFold", type=int, default=10)
    p.add_argument("--splitFlag", action="store_true")
    p.add_argument("--no_tf_features", action="store_true")
    p.add_argument("--no_dnase_features", action="store_true")
    p.add_argument("--no_histone_features", action="store_true")
    p.add_argument("--intersect_with_lambert", action="store_true")
    # the reference hard-codes these resource paths (cluster_utils.py:5-6)
    p.add_argument("--lambert_hgnc", default="./resources/Lambert-hgnc-symbol-check.csv")
    p.add_argument("--hgnc_mapping", default="./resources/beluga_hgnc_mapping.csv")
    p.add_argument("--no_pol2", action="store_true")
    p.add_argument("-o", dest="out_dir", default="predict_out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import pandas as pd

    from ..io.tables import load_beluga_features, load_closest_genes, load_modellist
    from ..io.xgb import load_expression_model
    from ..pipeline.sed import load_shift_effects, score_sed, score_sed_multimodel
    from ..utils.keep_mask import get_keep_mask

    keep_mask = None
    if args.intersect_with_lambert and not (os.path.exists(args.lambert_hgnc) and os.path.exists(args.hgnc_mapping)):
        print(
            "--intersect_with_lambert needs the Lambert/HGNC tables; pass --lambert_hgnc and "
            "--hgnc_mapping (defaults point at the reference's ./resources paths, cluster_utils.py:5-6)",
            file=sys.stderr,
        )
        return 2
    if args.belugaFeatures and any(
        [args.no_tf_features, args.no_dnase_features, args.no_histone_features, args.intersect_with_lambert, args.no_pol2]
    ):
        keep_mask = get_keep_mask(
            load_beluga_features(args.belugaFeatures), args.no_tf_features, args.no_dnase_features,
            args.no_histone_features, args.intersect_with_lambert, args.no_pol2,
            lambert_hgnc_path=args.lambert_hgnc, hgnc_mapping_path=args.hgnc_mapping,
        )

    effects = load_shift_effects(args.snpEffectFilePattern, maxshift=args.maxshift)
    coor = pd.read_csv(args.coorFile, sep="\t", header=None, comment="#")
    gene = load_closest_genes(args.geneFile)

    if args.splitFlag:
        # variant-fold slicing for very large inputs (README.md:50). Gene rows
        # are matched to the sliced variants by chrom:pos, since the
        # association file may carry several genes per variant.
        n = coor.shape[0]
        bounds = np.linspace(0, n, args.splitFold + 1).astype(int)
        lo, hi = bounds[args.splitIndex], bounds[args.splitIndex + 1]
        coor = coor.iloc[lo:hi]
        effects = {k: v[:, lo:hi] for k, v in effects.items()}
        # the gene file stores chrom without 'chr' and pos at col 2
        coor_keys = set(coor.iloc[:, 0].astype(str).str.replace("chr", "") + ":" + coor.iloc[:, 1].astype(str))
        gene_keys = gene.iloc[:, 0].astype(str).str.replace("chr", "") + ":" + gene.iloc[:, 2].astype(str)
        gene = gene[gene_keys.isin(coor_keys)]

    if args.modelList:
        modellist = load_modellist(args.modelList)
        paths = modellist.iloc[:, 0].tolist()
        names = modellist.iloc[:, 1].tolist() if modellist.shape[1] > 1 else None
        score_sed_multimodel(
            effects, coor, gene, paths,
            maxshift=args.maxshift, n_tracks=args.nfeatures, keep_mask=keep_mask,
            fixeddist=args.fixeddist, output_csv=args.output, model_names=names,
        )
        print(f"wrote {args.output}")
        return 0

    if not args.model_save_file:
        print("either --model_save_file or --modelList is required", file=sys.stderr)
        return 2
    model = load_expression_model(args.model_save_file.strip())
    os.makedirs(args.out_dir, exist_ok=True)
    score_sed(
        effects, coor, gene, model,
        maxshift=args.maxshift, n_tracks=args.nfeatures, keep_mask=keep_mask,
        fixeddist=args.fixeddist, out_dir=args.out_dir,
    )
    print(f"wrote {args.out_dir}/sed.tsv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
