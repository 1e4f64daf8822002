"""CLI: interpretation & clustering analyses
(``python -m expecto_tpu_torch.cli.analysis``; the 15 subcommands, flags,
defaults, output files and exit codes of ``expecto_tpu.cli.analysis``,
reference interpret_features.py, interpret_features_grouped.py, svd.py,
svd_transform.py, cluster_and_viz.py, cluster_and_viz_louvain.py,
cluster_by_pwm.py, query_fimo_for_predictions.py,
cluster_analysis_with_fimo.py, get_enriched_motif_set.py,
plot_bootstrapped_coefficients.py, extract_lymphoblastoid_consensus_preds.py,
resources/make_geneanno*.py, plot_susztak.py, plot_data_distributions.py,
util/rank_based_inverse_normal_transformation.py).

Host code only (numpy, pandas, scipy), as in the JAX package, so it takes
no ``--device``. Each subcommand imports its own packages when it runs:
``interpret-features``, ``svd``, ``svd-transform`` and ``cluster-viz
--method kmeans`` need scikit-learn and joblib; ``extract-consensus``,
``extract-dataset`` and ``plot-metrics`` need h5py; the plots (every
subcommand without ``--no_plots``, ``--tsne``, ``plot-metrics``,
``plot-distributions``) need matplotlib. A missing package raises its
ImportError.

Random draws come from explicit ``np.random.RandomState`` generators where
the JAX CLI seeds numpy's global state, and draw the same streams. Only
``fimo-enrich`` draws here: its generator is seeded with 1, and with
``--rank_int`` each gene's ``rank_INT`` reseeds it with 123, so the null
shuffles draw from the state the last gene's permutation left, as in the
reference. The JAX CLI's seeds before ``interpret-features`` and
``cluster-viz`` feed no draw (the estimators take their own seeds).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ExPecto-TPU analysis toolkit")
    sub = p.add_subparsers(dest="cmd", required=True)

    fp = sub.add_parser("interpret-features", help="hierarchical clustering of the 20,020 feature columns")
    fp.add_argument("--inputFile", default="./resources/Xreducedall.2002.npy")
    fp.add_argument("--annoFile", default="./resources/geneanno.csv")
    fp.add_argument("--belugaFeatures", required=True)
    fp.add_argument("--targetIndex", type=int, default=None,
                    help="with --expFile: drop genes whose log expression is not finite (interpret_features.py:57-62)")
    fp.add_argument("--expFile", default=None)
    fp.add_argument("--filterStr", default="all", choices=["all", "pc", "lincRNA"])
    fp.add_argument("--pseudocount", type=float, default=1e-4)
    fp.add_argument("--clustering_joblib", default=None,
                    help="reuse a fitted clustering instead of refitting (interpret_features.py:99-110)")
    fp.add_argument("--clustering_with_distances", action="store_true",
                    help="fit with distance_threshold=0 so dendrogram distances are kept")
    fp.add_argument("--n_clusters", type=int, default=None,
                    help="default 10 (feature mode, interpret_features.py:116) / 110 (grouped)")
    fp.add_argument("--grouped", action="store_true", help="cluster the 2,002 marks instead (n_clusters default 110)")
    fp.add_argument("--out_dir", default="interpret_features")

    sp = sub.add_parser("svd", help="TF-IDF + TruncatedSVD over replicated per-gene tracks")
    sp.add_argument("replicate_dir", help="dir of per-gene (200,2002) npy files (compute_features --replicate_raw)")
    sp.add_argument("--belugaFeatures", required=True)
    sp.add_argument("--n_components", type=int, default=100)
    sp.add_argument("--transform_out", default=None, help="also write the transformed embedding npy")
    for flag in ("--no_tf_features", "--no_dnase_features", "--no_histone_features",
                 "--intersect_with_lambert", "--no_pol2"):
        sp.add_argument(flag, action="store_true")
    sp.add_argument("--lambert_hgnc", default=None)
    sp.add_argument("--hgnc_mapping", default=None)
    sp.add_argument("--out_dir", default="svd_out")

    st = sub.add_parser("svd-transform", help="apply a fitted SVD to another replicate dir (svd_transform.py)")
    st.add_argument("replicate_dir")
    st.add_argument("svd_joblib")
    st.add_argument("--belugaFeatures", required=True)
    for flag in ("--no_tf_features", "--no_dnase_features", "--no_histone_features",
                 "--intersect_with_lambert", "--no_pol2"):
        st.add_argument(flag, action="store_true")
    st.add_argument("--lambert_hgnc", default=None)
    st.add_argument("--hgnc_mapping", default=None)
    st.add_argument("-o", dest="out_dir", default="temp_svd_transform")

    cp = sub.add_parser("cluster-viz", help="KMeans/t-SNE or Louvain clustering of an embedding")
    cp.add_argument("embedding", help="embedding npy, or an svd-transform out dir holding tf_idf_reduced_*.npy")
    cp.add_argument("--method", choices=["kmeans", "louvain"], default="kmeans")
    cp.add_argument("--k", type=int, default=30)
    cp.add_argument("--n_pcs", type=int, default=20, help="leading SVD components to cluster on (cluster_and_viz.py:39-40)")
    cp.add_argument("--tsne", action="store_true")
    cp.add_argument("--belugaFeatures", default=None,
                    help="write per-mark cluster tables like cluster_and_viz.py:89-103")
    for flag in ("--no_tf_features", "--no_dnase_features", "--no_histone_features"):
        cp.add_argument(flag, action="store_true")
    cp.add_argument("--out_dir", default="cluster_viz")

    wp = sub.add_parser("collect-pwms", help="collect JASPAR+HOCOMOCO motifs for Beluga TF assays")
    wp.add_argument("--belugaFeatures", required=True)
    wp.add_argument("--jaspar_motif_db", default=None)
    wp.add_argument("--hocomoco_jaspar_motif_file", default=None)
    wp.add_argument("--lambert_hgnc", default=None)
    wp.add_argument("--hgnc_mapping", default=None)
    wp.add_argument("--out_dir", default="cluster_by_pwm")

    qp = sub.add_parser("fimo-query", help="FIMO motif query around variants")
    qp.add_argument("--vcf_file", required=True)
    qp.add_argument("--motif_file", required=True)
    qp.add_argument("--hg19_fasta", default="resources/hg19.fa")
    qp.add_argument("--bp_pad", type=int, default=30)
    qp.add_argument("--chunk_size", type=int, default=None)
    qp.add_argument("--chunk_i", type=int, default=None)
    qp.add_argument("--fimo_engine", choices=["auto", "meme", "builtin"], default="auto",
                    help="'meme' = the external MEME-suite binary (reference bit parity); "
                         "'builtin' = the native scanner (analysis/motif_scan.py, same "
                         "published scoring model); 'auto' prefers the binary")
    qp.add_argument("-o", dest="out_dir", default="temp_query_fimo_for_predictions")

    ep = sub.add_parser("fimo-enrich", help="hypergeometric motif enrichment of top-contributing RSAT clusters (cluster_analysis_with_fimo.py)")
    ep.add_argument("--cluster_contribs_file", required=True)
    ep.add_argument("--rsat_clusters_file", required=True)
    ep.add_argument("--fimo_out_file", required=True)
    ep.add_argument("--rank_int", action="store_true", help="rank-INT the SED scores per gene before percentile stratification")
    ep.add_argument("--upstream_bp", type=int, default=30)
    ep.add_argument("--downstream_bp", type=int, default=30,
                    help="accepted for parity; the reference parses it but its filter uses "
                         "only upstream_bp (cluster_analysis_with_fimo.py:21,52)")
    ep.add_argument("--pval_match_threshold", type=float, default=1e-4)
    ep.add_argument("--n_neg_clusters", type=int, default=20)
    ep.add_argument("--no_plots", action="store_true")
    ep.add_argument("-o", dest="out_dir", default="temp_cluster_analysis_with_fimo")

    mp = sub.add_parser("enriched-motifs", help="write the MEME subset of motifs passing a q-value threshold (get_enriched_motif_set.py)")
    mp.add_argument("--hypergeom_enrichment_tsv", required=True)
    mp.add_argument("--motif_db_file", required=True)
    mp.add_argument("--qval_thresh", type=float, default=0.01)
    mp.add_argument("-o", dest="out_dir", default="temp_enriched_motif_set")

    bp = sub.add_parser("bootstrap-coefficients", help="bootstrap weight SEs, z-scores, CV ranking (plot_bootstrapped_coefficients.py)")
    bp.add_argument("--bootstrap_model_dir", required=True)
    bp.add_argument("--main_model", required=True)
    bp.add_argument("--input_features_file", required=True, help="all_feature_clusters.tsv from interpret-features")
    bp.add_argument("--pattern", default="*/*.save")
    bp.add_argument("--limit", type=int, default=800)
    bp.add_argument("--top_k_cv_hists", type=int, default=10)
    bp.add_argument("--no_plots", action="store_true")
    bp.add_argument("-o", dest="out_dir", default="bootstrap_coefficients")

    xp = sub.add_parser("extract-consensus", help="extract tracks at SNP/TSS/flank bins from consensus chromatin h5s (extract_lymphoblastoid_consensus_preds.py)")
    xp.add_argument("--chromatin_h5", required=True)
    xp.add_argument("--snp_pos", type=int, required=True)
    xp.add_argument("--tss_pos", type=int, required=True)
    xp.add_argument("--strand", choices=["+", "-"], required=True)
    xp.add_argument("--tracks", required=True, help="comma-separated track indices, or a cell-type substring matched against belugaFeatures")
    xp.add_argument("--belugaFeatures", default=None)
    xp.add_argument("--model", choices=["expecto", "basenji"], default="expecto")
    xp.add_argument("--flank", type=int, default=50)
    xp.add_argument("-o", dest="out_h5", required=True)

    xd = sub.add_parser("extract-dataset", help="directory-level SNP/TSS/50-bin extraction over all eqtls/genes "
                                                "(extract_lymphoblastoid_consensus_preds.py main loop)")
    xd.add_argument("--model", choices=["expecto", "basenji"], required=True)
    xd.add_argument("--extract_mode", choices=["snp", "tss", "50_bins"], default="snp")
    xd.add_argument("--eqtls_csv", required=True)
    xd.add_argument("--genes_csv", required=True)
    xd.add_argument("--subset_genes_txt", default=None)
    xd.add_argument("--expecto_preds_dir", default=None)
    xd.add_argument("--beluga_features_tsv", default=None)
    xd.add_argument("--basenji_preds_dir", default=None)
    xd.add_argument("--targets_file", default=None)
    xd.add_argument("--cell_type", default="GM12878")
    xd.add_argument("--n_center_bins", type=int, default=10,
                    help="accepted for parity; the reference parses but never uses it "
                         "(extract_lymphoblastoid_consensus_preds.py:20)")
    xd.add_argument("--processes", type=int, default=None,
                    help="mp.Pool size for the basenji branch (reference uses an unbounded Pool)")
    xd.add_argument("--out_dir", required=True)

    gp = sub.add_parser("make-profile", help="join a counts matrix onto the geneanno row order (resources/make_geneanno*.py)")
    gp.add_argument("--annoFile", required=True)
    gp.add_argument("--countsFile", required=True, help="CSV/TSV with gene ids or symbols as index")
    gp.add_argument("--on", choices=["index", "symbol"], default="index")
    gp.add_argument("--columns", default=None, help="comma-separated output column subset/order")
    gp.add_argument("--log2_offset", type=float, default=None, help="undo log2(RPM+offset) back to linear RPM first")
    gp.add_argument("--rank_match_col", default=None, help="rank-match every column to this column of the joined table")
    gp.add_argument("-o", dest="out_csv", required=True)

    rp = sub.add_parser("rank-int", help="rank-based inverse normal transform of a table column (util/rank_based_inverse_normal_transformation.py)")
    rp.add_argument("table", help="TSV input")
    rp.add_argument("--column", required=True)
    rp.add_argument("--group_by", default=None, help="apply per group (e.g. gene)")
    rp.add_argument("--blom_c", type=float, default=3.0 / 8)
    rp.add_argument("--deterministic", action="store_true", help="average ties instead of stochastic tie-breaking")
    rp.add_argument("-o", dest="out_tsv", required=True)

    pp = sub.add_parser("plot-metrics", help="metric scatter+histograms from a training metrics.h5 (plot_susztak.py)")
    pp.add_argument("metrics_h5")
    pp.add_argument("-o", dest="out_dir", default="metric_plots")

    dp = sub.add_parser("plot-distributions", help="expression histograms per profile column (plot_data_distributions.py)")
    dp.add_argument("--expFile", required=True)
    dp.add_argument("--columns", default=None, help="comma-separated subset (default: all numeric)")
    dp.add_argument("--pseudocount", type=float, default=1e-4)
    dp.add_argument("--kidney_exp_file", default=None,
                    help="also plot per-column kidney histograms + a kidney-vs-expecto scatter "
                         "(plot_data_distributions.py:22-75)")
    dp.add_argument("--kidney_genes_only", action="store_true",
                    help="restrict expFile rows to genes without NaNs in the kidney profile")
    dp.add_argument("--kidney_cell_type", default="PT")
    dp.add_argument("--expecto_column", default=None, help="expecto column for the scatter (default: first)")
    dp.add_argument("-o", dest="out_dir", default="distribution_plots")

    args = p.parse_args(argv)

    import numpy as np
    import pandas as pd

    from ..io.tables import load_beluga_features

    if getattr(args, "out_dir", None):
        os.makedirs(args.out_dir, exist_ok=True)

    if args.cmd == "interpret-features":
        from ..analysis.cluster import (
            cut_feature_clustering,
            cut_mark_clustering,
            fit_feature_clustering,
            fit_mark_clustering,
            feature_clusters_table,
            mark_clusters_table,
            cluster_sizes,
        )
        from ..pipeline.train import chromosome_split, gene_filter

        X = np.load(args.inputFile)
        geneanno = pd.read_csv(args.annoFile)
        trainind, _ = chromosome_split(geneanno)
        filt = gene_filter(geneanno, args.filterStr)
        if args.expFile is not None and args.targetIndex is not None:
            geneexp = pd.read_csv(args.expFile)
            print(f"Cell type: {geneexp.columns[args.targetIndex]}")
            with np.errstate(invalid="ignore", divide="ignore"):
                labels_log = np.log(np.asarray(geneexp.iloc[:, args.targetIndex], dtype=np.float64) + args.pseudocount)
            filt = filt & np.isfinite(labels_log)
        X_train = X[trainind & filt]
        features_df = load_beluga_features(args.belugaFeatures)
        import joblib

        if args.clustering_joblib:
            print(f"Loading clustering model from {args.clustering_joblib}...")
            clustering = joblib.load(args.clustering_joblib)
        else:
            fit = fit_mark_clustering if args.grouped else fit_feature_clustering
            clustering = fit(
                X_train, with_distances=args.clustering_with_distances,
                cache_dir=f"{args.out_dir}/cache",
            )
            name = "clustering_with_distances" if args.clustering_with_distances else "clustering_cached"
            joblib.dump(clustering, f"{args.out_dir}/{name}.joblib")
        n_clusters = args.n_clusters if args.n_clusters is not None else (110 if args.grouped else 10)
        if args.grouped:
            clusters = cut_mark_clustering(clustering, X_train, n_clusters)
            table = mark_clusters_table(features_df, clusters)
            cluster_sizes(table).to_csv(f"{args.out_dir}/cluster_sizes.tsv", sep="\t")
        else:
            # cut_feature_clustering returns (n_marks, n_basis) — already the
            # mark-major layout feature_clusters_table ravels
            labels = cut_feature_clustering(clustering, X_train, n_clusters)
            table = feature_clusters_table(features_df, labels)
        table.to_csv(f"{args.out_dir}/all_feature_clusters.tsv", sep="\t")
        cdir = f"{args.out_dir}/clusters"
        os.makedirs(cdir, exist_ok=True)
        for i in sorted(table["cluster"].unique()):
            table[table["cluster"] == i].to_csv(f"{cdir}/cluster_{i}.tsv", sep="\t")
        print(f"wrote {args.out_dir}/all_feature_clusters.tsv")

    elif args.cmd in ("svd", "svd-transform"):
        from ..analysis.cluster import tfidf_transform, tfidf_svd
        from ..utils.keep_mask import get_keep_mask

        npy_files = sorted(glob.glob(f"{args.replicate_dir}/*.npy"))
        if not npy_files:
            print("no npy files found", file=sys.stderr)
            return 2
        # (n_marks, n_genes*200) spatial tracks (reference svd.py:58-75)
        first = np.load(npy_files[0])
        tracks = np.empty((first.shape[1], len(npy_files), first.shape[0]), dtype=np.float32)
        for i, f in enumerate(npy_files):
            tracks[:, i] = np.load(f).T
        features_df = load_beluga_features(args.belugaFeatures)
        keep_mask = np.asarray(get_keep_mask(
            features_df, args.no_tf_features, args.no_dnase_features, args.no_histone_features,
            args.intersect_with_lambert, args.no_pol2,
            lambert_hgnc_path=args.lambert_hgnc, hgnc_mapping_path=args.hgnc_mapping,
        ))
        tracks = tracks[np.nonzero(keep_mask)[0]]
        tracks = tracks.reshape(tracks.shape[0], -1)
        print(f"Tracks shape: {tracks.shape}")
        import joblib

        if args.cmd == "svd-transform":
            svd = joblib.load(args.svd_joblib)
            X = svd.transform(tfidf_transform(tracks))
            np.save(f"{args.out_dir}/tf_idf_reduced_{X.shape[1]}.npy", X)
            print(f"wrote {args.out_dir}/tf_idf_reduced_{X.shape[1]}.npy")
        else:
            svd = tfidf_svd(tracks, n_components=args.n_components)
            joblib.dump(svd, f"{args.out_dir}/svd_{args.n_components}.joblib")
            if args.transform_out:
                np.save(args.transform_out, svd.transform(tfidf_transform(tracks)))
            print(f"wrote {args.out_dir}/svd_{args.n_components}.joblib")

    elif args.cmd == "cluster-viz":
        from ..analysis.cluster import kmeans_clusters, louvain_clusters

        emb_path = args.embedding
        if os.path.isdir(emb_path):
            hits = sorted(glob.glob(f"{emb_path}/tf_idf_reduced_*.npy"))
            if not hits:
                print(f"no tf_idf_reduced_*.npy in {emb_path}", file=sys.stderr)
                return 2
            emb_path = hits[0]
        X = np.load(emb_path)
        X = X[:, : args.n_pcs]
        if args.method == "kmeans":
            if args.tsne:
                labels, emb = kmeans_clusters(X, k=args.k, with_tsne=True)
                np.save(f"{args.out_dir}/tsne_embedding.npy", emb)
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                plt.figure()
                for i in np.unique(labels):
                    pts = emb[labels == i]
                    plt.scatter(pts[:, 0], pts[:, 1], label=f"cluster {i}", s=8)
                plt.savefig(f"{args.out_dir}/tsne_clusters.png", dpi=300)
                plt.close()
            else:
                labels = kmeans_clusters(X, k=args.k)
        else:
            labels = louvain_clusters(X)
        pd.DataFrame({"cluster": labels}).to_csv(f"{args.out_dir}/clusters.tsv", sep="\t")
        if args.belugaFeatures:
            # per-mark tables as in cluster_and_viz.py:74-103 (ablations mirror
            # the mask used when the embedding was built)
            from ..utils.keep_mask import get_keep_mask

            features_df = load_beluga_features(args.belugaFeatures)
            mask = np.asarray(get_keep_mask(
                features_df, args.no_tf_features, args.no_dnase_features, args.no_histone_features
            ))
            table = features_df[mask].copy()
            if table.shape[0] != len(labels):
                print(f"belugaFeatures mask rows ({table.shape[0]}) != embedding rows ({len(labels)})", file=sys.stderr)
                return 2
            table["cluster"] = labels
            table.to_csv(f"{args.out_dir}/all_feature_clusters.tsv", sep="\t")
            cdir = f"{args.out_dir}/clusters"
            os.makedirs(cdir, exist_ok=True)
            sizes = pd.DataFrame(columns=["size"])
            for i in sorted(set(labels)):
                cluster_df = table[table["cluster"] == i]
                cluster_df.to_csv(f"{cdir}/cluster_{i}.tsv", sep="\t")
                sizes.loc[f"cluster_{i}"] = cluster_df.shape[0]
            sizes.sort_values(by="size", ascending=False).to_csv(f"{args.out_dir}/cluster_sizes.tsv", sep="\t")
        print(f"wrote {args.out_dir}/clusters.tsv ({len(set(labels))} clusters)")

    elif args.cmd == "collect-pwms":
        from ..analysis.pwm import collect_cluster_motifs, write_jaspar
        from ..utils.keep_mask import get_keep_mask

        features_df = load_beluga_features(args.belugaFeatures)
        if args.lambert_hgnc and args.hgnc_mapping:
            keep_mask, hgnc_df = get_keep_mask(
                features_df, no_dnase_features=True, no_histone_features=True, no_pol2=True,
                intersect_with_lambert=True,
                lambert_hgnc_path=args.lambert_hgnc, hgnc_mapping_path=args.hgnc_mapping,
                return_hgnc_df=True,
            )
            included = set(hgnc_df[keep_mask]["Assay"].str.upper())
        else:
            tf_mask = features_df["Assay type"] == "TF"
            included = set(features_df[tf_mask]["Assay"].str.upper())
        motifs, found = collect_cluster_motifs(included, args.jaspar_motif_db, args.hocomoco_jaspar_motif_file)
        print(f"Found {len(found)} motifs out of {len(included)} TF assays")
        os.makedirs(args.out_dir, exist_ok=True)
        with open(f"{args.out_dir}/cluster_motifs.jaspar", "w") as f:
            f.write(write_jaspar(motifs))

    elif args.cmd == "fimo-query":
        from ..analysis.fimo import write_fimo_input, run_fimo, filter_fimo_results
        from ..genome.fasta import FastaIndex

        vcf_df = pd.read_csv(
            args.vcf_file, sep="\t", comment="#",
            names=["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"],
        )
        if args.chunk_i is not None:
            if args.chunk_size is None:
                print("--chunk_i requires --chunk_size", file=sys.stderr)
                return 2
            vcf_df = vcf_df.iloc[args.chunk_i * args.chunk_size : (args.chunk_i + 1) * args.chunk_size]
        genome = FastaIndex(args.hg19_fasta)
        os.makedirs(args.out_dir, exist_ok=True)
        fasta = f"{args.out_dir}/fimo_in.fasta"
        write_fimo_input(vcf_df, genome, fasta, bp_pad=args.bp_pad)
        out_txt = f"{args.out_dir}/fimo_out.txt"
        engine = run_fimo(args.motif_file, fasta, out_txt, engine=args.fimo_engine)
        print(f"fimo engine: {engine}")
        filtered = filter_fimo_results(out_txt, bp_pad=args.bp_pad)
        filtered.to_csv(f"{args.out_dir}/fimo_filtered.tsv", sep="\t", header=True)
        print(f"wrote {args.out_dir}/fimo_filtered.tsv")

    elif args.cmd == "fimo-enrich":
        from ..analysis.fimo import FIMO_COLUMNS, cluster_contribs_hypergeom, shuffle_along_axis
        from ..analysis.rank_int import rank_INT

        rng = np.random.RandomState(1)
        rsat_clusters_df = pd.read_csv(args.rsat_clusters_file, sep="\t", header=None, index_col=0)
        contribs = pd.read_csv(args.cluster_contribs_file, sep="\t", index_col=0)
        if "cluster_-1" in contribs.columns:
            contribs = contribs.drop("cluster_-1", axis=1)
        contribs = contribs.reset_index(drop=True)
        sed_column = "SED_PROPORTION"
        if args.rank_int:
            contribs.insert(
                loc=contribs.columns.tolist().index("SED") + 1,
                column="SED_RINT",
                value=contribs.groupby("gene")["SED"].transform(lambda x: rank_INT(x, stochastic=True, rng=rng)),
            )
            contribs = contribs.drop("SED", axis=1)
            sed_column = "SED_RINT"

        fimo_df = pd.read_table(args.fimo_out_file, sep="\t", names=FIMO_COLUMNS, comment="#")
        fimo_df = fimo_df[(fimo_df["start"] <= (args.upstream_bp + 1)) & (fimo_df["stop"] >= (args.upstream_bp + 1))]
        fimo_df = fimo_df.sort_values(by="p-value").drop_duplicates(
            subset=["motif_id", "motif_alt_id", "sequence_name"], keep="first"
        )
        fimo_df = fimo_df[fimo_df["p-value"] < args.pval_match_threshold]

        id_col = contribs.columns.tolist().index("2") if "2" in contribs.columns else 2
        # locate the cluster-contribution block by matching column names
        # against the RSAT cluster table (robust to layouts with or without
        # SED_PROPORTION, unlike the reference's hard-coded 15 —
        # cluster_analysis_with_fimo.py:52's iloc offset)
        cluster_names = set(map(str, rsat_clusters_df.index))
        matches = [i for i, c in enumerate(contribs.columns) if str(c) in cluster_names]
        start_col = min(matches) if matches else 15
        hyper_df, uniq = cluster_contribs_hypergeom(
            contribs, fimo_df, rsat_clusters_df, args.n_neg_clusters,
            id_col=id_col, contrib_start_col=start_col, return_unique_clusters=True,
        )
        hyper_df.to_csv(f"{args.out_dir}/hypergeom.tsv", sep="\t", index=False)
        pd.DataFrame.from_dict(
            {k: len(v) for k, v in uniq.items()}, orient="index", columns=["n_unique_clusters"]
        ).to_csv(f"{args.out_dir}/num_unique_clusters.tsv", sep="\t")

        # null 1: cluster contributions shuffled within each variant row
        shuf_c = contribs.copy()
        shuf_c.iloc[:, start_col:] = shuffle_along_axis(shuf_c.iloc[:, start_col:].values, 1, rng)
        cluster_contribs_hypergeom(
            shuf_c, fimo_df, rsat_clusters_df, args.n_neg_clusters,
            id_col=id_col, contrib_start_col=start_col,
        ).to_csv(f"{args.out_dir}/hypergeom_shuffled_clusters.tsv", sep="\t", index=False)

        # null 2: variant ids permuted across rows
        shuf_v = contribs.copy()
        perm = rng.choice(contribs.shape[0], contribs.shape[0], replace=False)
        id_name = contribs.columns[id_col]
        shuf_v[id_name] = shuf_v[id_name].iloc[perm].reset_index(drop=True)
        cluster_contribs_hypergeom(
            shuf_v, fimo_df, rsat_clusters_df, args.n_neg_clusters,
            id_col=id_col, contrib_start_col=start_col,
        ).to_csv(f"{args.out_dir}/hypergeom_shuffled_variants.tsv", sep="\t", index=False)

        # SED-percentile stratification
        percentile_dfs = {}
        if sed_column in contribs.columns:
            for lo_p in range(0, 100, 25):
                lo, hi = (np.percentile(contribs[sed_column], p) for p in (lo_p, lo_p + 25))
                sel = contribs[(lo <= contribs[sed_column]) & (contribs[sed_column] <= hi)]
                pdf = cluster_contribs_hypergeom(
                    sel, fimo_df, rsat_clusters_df, args.n_neg_clusters,
                    id_col=id_col, contrib_start_col=start_col,
                )
                pdf.to_csv(f"{args.out_dir}/hypergeom_percentile_{lo_p}_{lo_p + 25}.tsv", sep="\t", index=False)
                percentile_dfs[(lo_p, lo_p + 25)] = pdf

        if not args.no_plots:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure()
            plt.plot(hyper_df["top_cluster_idx"], -np.log10(hyper_df["hypergeom_pval"]), label="top")
            for name, path in (("shuffled clusters", "hypergeom_shuffled_clusters.tsv"),
                               ("shuffled variants", "hypergeom_shuffled_variants.tsv")):
                d = pd.read_csv(f"{args.out_dir}/{path}", sep="\t")
                plt.plot(d["top_cluster_idx"], -np.log10(d["hypergeom_pval"]), label=name)
            plt.xlabel("Top cluster index")
            plt.ylabel(r"-$\log_{10}$ pval")
            plt.legend()
            plt.savefig(f"{args.out_dir}/hypergeom_test_vs_cluster.pdf", dpi=300)
            plt.close()
            if percentile_dfs:
                plt.figure()
                for rng_k, pdf in percentile_dfs.items():
                    plt.plot(pdf["top_cluster_idx"], -np.log10(pdf["hypergeom_pval"]), ls="--", label=f"percentile: {rng_k}")
                plt.xlabel("Top cluster index")
                plt.ylabel(r"-$\log_{10}$ pval")
                plt.legend()
                plt.savefig(f"{args.out_dir}/hypergeom_test_vs_cluster_by_quantile.pdf", dpi=300)
                plt.close()
        print(f"wrote {args.out_dir}/hypergeom.tsv")

    elif args.cmd == "enriched-motifs":
        from ..analysis.fimo import extract_enriched_motif_set

        found = extract_enriched_motif_set(
            args.hypergeom_enrichment_tsv, args.motif_db_file,
            f"{args.out_dir}/enriched_motifs.meme", qval_thresh=args.qval_thresh,
        )
        print(f"wrote {args.out_dir}/enriched_motifs.meme ({len(found)} motifs)")

    elif args.cmd == "bootstrap-coefficients":
        from ..analysis.bootstrap import (
            bootstrap_coefficient_stats,
            features_sorted_by_zscore,
            load_bootstrap_models,
        )
        from ..io.xgb import load_expression_model

        models = load_bootstrap_models(args.bootstrap_model_dir, pattern=args.pattern, limit=args.limit)
        if not models:
            print("no bootstrap models found", file=sys.stderr)
            return 2
        main_model = load_expression_model(args.main_model)
        stats = bootstrap_coefficient_stats(models, main_model)
        feats = pd.read_csv(args.input_features_file, sep="\t", index_col=0)
        features_sorted_by_zscore(feats, stats).to_csv(
            f"{args.out_dir}/input_features_sorted_by_zscore.csv", sep="\t"
        )
        np.save(f"{args.out_dir}/se_weight.npy", stats.se_weight)
        if not args.no_plots:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            top = np.argsort(stats.coeff_of_var)[-args.top_k_cv_hists:][::-1]
            for rank, i in enumerate(top):
                plt.figure()
                plt.hist(stats.all_weights[:, i])
                plt.title(f"feature {i} (CV rank {rank})")
                plt.savefig(f"{args.out_dir}/cv_top{rank}_feature{i}.pdf", dpi=150)
                plt.close()
        print(f"wrote {args.out_dir}/input_features_sorted_by_zscore.csv ({len(models)} bootstrap models)")

    elif args.cmd == "extract-consensus":
        from ..analysis.extract import extract_consensus_track_bins

        try:
            track_indices = [int(t) for t in args.tracks.split(",")]
        except ValueError:
            if not args.belugaFeatures:
                print("--belugaFeatures required for name-based track selection", file=sys.stderr)
                return 2
            features_df = load_beluga_features(args.belugaFeatures)
            hit = features_df["Cell type"].str.contains(args.tracks, case=False, na=False)
            track_indices = list(np.flatnonzero(hit.values))
            if not track_indices:
                print(f"no tracks match {args.tracks!r}", file=sys.stderr)
                return 2
        out = extract_consensus_track_bins(
            args.chromatin_h5, args.snp_pos, args.tss_pos, args.strand,
            track_indices, out_h5_path=args.out_h5, flank=args.flank, model=args.model,
        )
        print(f"wrote {args.out_h5} (snp_bin={out['snp_bin']} tss_bin={out['tss_bin']} tracks={len(track_indices)})")

    elif args.cmd == "extract-dataset":
        from ..analysis.extract import extract_consensus_dataset

        if args.model == "expecto" and not (args.expecto_preds_dir and args.beluga_features_tsv):
            print("--expecto_preds_dir and --beluga_features_tsv required for --model expecto", file=sys.stderr)
            return 2
        if args.model == "basenji" and not (args.basenji_preds_dir and args.targets_file):
            print("--basenji_preds_dir and --targets_file required for --model basenji", file=sys.stderr)
            return 2
        done = extract_consensus_dataset(
            model=args.model, extract_mode=args.extract_mode, out_dir=args.out_dir,
            eqtls_csv=args.eqtls_csv, genes_csv=args.genes_csv,
            subset_genes_txt=args.subset_genes_txt,
            expecto_preds_dir=args.expecto_preds_dir, beluga_features_tsv=args.beluga_features_tsv,
            basenji_preds_dir=args.basenji_preds_dir, targets_file=args.targets_file,
            cell_type=args.cell_type, progress=True, processes=args.processes,
        )
        print(f"extracted {len(done)} gene dirs to {args.out_dir}")

    elif args.cmd == "make-profile":
        from ..pipeline.profiles import join_counts_to_geneanno, rank_match_to_profile

        geneanno = pd.read_csv(args.annoFile, index_col=0)
        sep = "\t" if args.countsFile.endswith((".tsv", ".txt")) else ","
        counts = pd.read_csv(args.countsFile, sep=sep, index_col=0)
        cols = args.columns.split(",") if args.columns else None
        out = join_counts_to_geneanno(
            geneanno, counts, cols, on=args.on, log2_offset=args.log2_offset
        )
        if args.rank_match_col:
            out = rank_match_to_profile(out, out[args.rank_match_col])
        out.to_csv(args.out_csv)
        print(f"wrote {args.out_csv} ({out.shape[0]} genes x {out.shape[1]} profiles)")

    elif args.cmd == "rank-int":
        from ..analysis.rank_int import rank_INT

        df = pd.read_csv(args.table, sep="\t")
        for col in filter(None, (args.column, args.group_by)):
            if col not in df.columns:
                print(f"column {col!r} not in {args.table} (has: {', '.join(df.columns)})", file=sys.stderr)
                return 2
        kwargs = dict(c=args.blom_c, stochastic=not args.deterministic)
        if args.group_by:
            df[args.column + "_RINT"] = df.groupby(args.group_by)[args.column].transform(
                lambda x: rank_INT(x, **kwargs)
            )
        else:
            df[args.column + "_RINT"] = rank_INT(df[args.column], **kwargs)
        df.to_csv(args.out_tsv, sep="\t", index=False)
        print(f"wrote {args.out_tsv}")

    elif args.cmd == "plot-metrics":
        import h5py

        from ..utils.plotting import plot_metric_hist, plot_scatter_hist

        n_written = 0
        with h5py.File(args.metrics_h5, "r") as f:
            for name in f.keys():
                if f[name].dtype.kind in "SU":  # tissue-name labels
                    continue
                vals = np.asarray(f[name])
                plot_metric_hist(vals, f"{args.out_dir}/{name}_hist.png", xlabel=name, title=name)
                n_written += 1
            # reference plot_susztak.py:64-83 train-vs-valid scatter_hists
            for metric, fname in (("pearsonr", "pearsonr.png"), ("r2", "r2.png")):
                tr, va = f"{metric}_trains", f"{metric}_valids"
                if tr in f and va in f and f[tr].shape[0] > 0:
                    plot_scatter_hist(
                        np.asarray(f[tr]), np.asarray(f[va]), f"{args.out_dir}/{fname}",
                        xlabel=f"Train {metric} (holding out chr8, chr7)",
                        ylabel=f"Valid {metric} (chr8)",
                    )
                    n_written += 1
        print(f"wrote {n_written} plots to {args.out_dir}")

    elif args.cmd == "plot-distributions":
        from ..utils.plotting import plot_expression_distributions

        exp_df = pd.read_csv(args.expFile)
        if args.columns:
            exp_df = exp_df[args.columns.split(",")]
        else:
            exp_df = exp_df.select_dtypes("number")

        nan_mask = None
        if args.kidney_exp_file:
            # kidney per-column histograms + kidney-vs-expecto scatter
            # (plot_data_distributions.py:22-75)
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            kidney_df = pd.read_csv(args.kidney_exp_file, index_col=0).reset_index(drop=True)
            nan_mask = np.asarray(kidney_df.isnull().any(axis=1))
            kidney_log = np.log(kidney_df[~nan_mask] + args.pseudocount)
            kdir = f"{args.out_dir}/kidney"
            os.makedirs(kdir, exist_ok=True)
            bins = np.linspace(float(np.min(kidney_log.values)), float(np.max(kidney_log.values)), num=50)
            for cell_type in kidney_log.columns:
                plt.figure()
                plt.hist(kidney_log[cell_type], bins=bins)
                plt.title(cell_type)
                plt.savefig(f"{kdir}/{cell_type}_hist.png", dpi=300)
                plt.close()

        if args.kidney_genes_only:
            if nan_mask is None:
                print("--kidney_genes_only requires --kidney_exp_file", file=sys.stderr)
                return 2
            exp_df = exp_df[~nan_mask]

        plot_expression_distributions(
            exp_df, f"{args.out_dir}/expression_distributions.png", pseudocount=args.pseudocount
        )

        if args.kidney_exp_file:
            from ..utils.plotting import plot_preds

            expecto_col = args.expecto_column or exp_df.columns[0]
            y_exp = np.log(np.asarray(exp_df[expecto_col], dtype=np.float64) + args.pseudocount)
            if not args.kidney_genes_only:
                y_exp = y_exp[~nan_mask]
            x_kid = np.asarray(kidney_log[args.kidney_cell_type], dtype=np.float64)
            plot_preds(
                x_kid, y_exp,
                f"{args.out_dir}/scatter_{args.kidney_cell_type}_vs_{expecto_col}.png",
                xlabel=f"{args.kidney_cell_type} expression, log(RPKM)",
                ylabel=f"{expecto_col} expression, log(RPKM)",
            )
        print(f"wrote {args.out_dir}/expression_distributions.png")

    return 0


if __name__ == "__main__":
    sys.exit(main())
