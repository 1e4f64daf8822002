"""CLI: SED scoring with per-cluster attribution columns
(``python -m expecto_tpu_torch.cli.predict_by_cluster``; the arguments of
``expecto_tpu.cli.predict_by_cluster``, reference predict_by_cluster.py /
predict_by_cluster_rsat.py flags).

Host numpy only, over the per-shift h5s of ``cli.chromatin``: writes
``sed.tsv`` under ``-o`` with REF, ALT, SED, SED_PROPORTION and one column a
cluster (its share of the SED). Labels come from ``--feature_clusters_df``
(one a mark) or an RSAT ``--rsat_clusters_tab`` (a mark may sit in several
clusters). Returns 2 on a missing required table.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SED scoring with cluster attribution")
    p.add_argument("--model_save_file", required=True)
    p.add_argument("--feature_clusters_df", default=None,
                   help="all_feature_clusters.tsv with a 'cluster' column (one label per mark)")
    p.add_argument("--rsat_clusters_tab", default=None,
                   help="RSAT clusters_motif_names.tab for multi-membership attribution")
    p.add_argument("--belugaFeatures", default=None)
    p.add_argument("--coorFile", "--coorFile_chromatin", dest="coorFile", required=True)
    p.add_argument("--geneFile", required=True)
    p.add_argument("--snpEffectFilePattern", required=True)
    p.add_argument("--nfeatures", type=int, default=2002)
    p.add_argument("--fixeddist", type=int, default=0)
    p.add_argument("--maxshift", type=int, default=800)
    p.add_argument("--batchSize", type=int, default=500, help="kept for CLI parity")
    p.add_argument("--threads", type=int, default=16, help="kept for CLI parity")
    p.add_argument("--splitIndex", type=int, default=0, help="kept for CLI parity (vestigial in the reference)")
    p.add_argument("--splitFold", type=int, default=10, help="kept for CLI parity (vestigial in the reference)")
    p.add_argument("--no_tf_features", action="store_true")
    p.add_argument("--no_dnase_features", action="store_true")
    p.add_argument("--no_histone_features", action="store_true")
    p.add_argument("--intersect_with_lambert", action="store_true")
    p.add_argument("--no_pol2", action="store_true")
    p.add_argument("--lambert_hgnc", default=None, help="required with --intersect_with_lambert")
    p.add_argument("--hgnc_mapping", default=None, help="required with --intersect_with_lambert")
    p.add_argument("-o", dest="out_dir", default="predict_by_cluster_out")
    args = p.parse_args(argv)

    import numpy as np
    import pandas as pd

    from ..io.tables import load_beluga_features, load_closest_genes
    from ..io.xgb import load_expression_model
    from ..pipeline.sed import load_shift_effects, score_sed_with_clusters
    from ..utils.keep_mask import get_keep_mask

    effects = load_shift_effects(args.snpEffectFilePattern, maxshift=args.maxshift)
    coor = pd.read_csv(args.coorFile, sep="\t", header=None, comment="#")
    gene = load_closest_genes(args.geneFile)
    model = load_expression_model(args.model_save_file.strip())

    keep_mask = None
    if args.belugaFeatures and any(
        [args.no_tf_features, args.no_dnase_features, args.no_histone_features,
         args.intersect_with_lambert, args.no_pol2]
    ):
        if args.intersect_with_lambert and not (args.lambert_hgnc and args.hgnc_mapping):
            print("--intersect_with_lambert requires --lambert_hgnc and --hgnc_mapping", file=sys.stderr)
            return 2
        keep_mask = np.asarray(get_keep_mask(
            load_beluga_features(args.belugaFeatures),
            args.no_tf_features, args.no_dnase_features, args.no_histone_features,
            args.intersect_with_lambert, args.no_pol2,
            lambert_hgnc_path=args.lambert_hgnc, hgnc_mapping_path=args.hgnc_mapping,
        ))

    if args.rsat_clusters_tab:
        # RSAT table: cluster name -> comma-separated motif (mark) names;
        # membership built against the Beluga assay names
        if not args.belugaFeatures:
            print("--rsat_clusters_tab requires --belugaFeatures", file=sys.stderr)
            return 2
        features_df = load_beluga_features(args.belugaFeatures)
        rsat = pd.read_csv(args.rsat_clusters_tab, sep="\t", header=None, index_col=0)
        assays = features_df["Assay"].str.upper().values
        names = list(rsat.index)
        membership = np.zeros((len(assays), len(names)))
        for j, cname in enumerate(names):
            motifs = set(sum([str(x).upper().split(",") for x in np.atleast_1d(rsat.loc[cname]).tolist()], []))
            membership[:, j] = np.isin(assays, list(motifs))
        if keep_mask is not None:
            membership = membership[keep_mask]
        df = score_sed_with_clusters(
            effects, coor, gene, model, names,
            maxshift=args.maxshift, n_tracks=args.nfeatures, keep_mask=keep_mask,
            fixeddist=args.fixeddist, out_dir=args.out_dir, membership=membership,
        )
    else:
        if not args.feature_clusters_df:
            print("one of --feature_clusters_df / --rsat_clusters_tab is required", file=sys.stderr)
            return 2
        clusters_df = pd.read_csv(args.feature_clusters_df, sep="\t", index_col=0)
        # one label per mark: the first basis row of each mark
        clusters = clusters_df[clusters_df["coeff_idx"] == 0]["cluster"] if "coeff_idx" in clusters_df else clusters_df["cluster"]
        clusters = clusters.values
        if keep_mask is not None and len(clusters) == len(keep_mask):
            clusters = clusters[keep_mask]  # labels over all marks: subset to the kept ones
        df = score_sed_with_clusters(
            effects, coor, gene, model, clusters,
            maxshift=args.maxshift, n_tracks=args.nfeatures, keep_mask=keep_mask,
            fixeddist=args.fixeddist, out_dir=args.out_dir,
        )
    print(f"wrote {args.out_dir}/sed.tsv ({df.shape[0]} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
