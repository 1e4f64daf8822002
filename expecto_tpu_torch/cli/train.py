"""CLI: expression-model training on a CUDA GPU
(``python -m expecto_tpu_torch.cli.train``; the arguments of
``expecto_tpu.cli.train`` plus ``--device``; reference train.py /
train_bootstrap.py / train_susztak.py flags).

Three modes: one tissue (``--targetIndex``: ``.save``/``.dump``, the
``--evalFile`` CSV and two pred-vs-label plots), ``--bootstrap_seeds N``
(N resampled models of one tissue in one sweep) and ``--allTissues`` (every
expression column, ``metrics.h5``; ``--vectorized`` trains them in one
sweep). Products are fp32 with TF32 off. Under ``torchrun`` each rank
trains on its slice of the training genes (gradient sums all-reduced) and
rank 0 writes the files::

    torchrun --standalone --nproc_per_node 2 -m expecto_tpu_torch.cli.train ...

``--trace_dir DIR`` profiles the job (``utils/profiling.trace``): the
Chrome trace shows the sweep's ``gblinear.*`` spans (the upload of X, the
state, the rounds, the fetch) beside the card's kernels and copies, and
``spans_*.jsonl`` lists every span with its host and device times.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train an ExPecto expression model")
    p.add_argument("--targetIndex", type=int, default=None, help="required unless --allTissues")
    p.add_argument("--expFile", type=str, required=True)
    p.add_argument("--belugaFeatures", type=str, default=None)
    p.add_argument("--inputFile", type=str, default="./resources/Xreducedall.2002.npy")
    p.add_argument("--annoFile", type=str, default="./resources/geneanno.csv")
    p.add_argument("--evalFile", type=str, default="")
    p.add_argument("--filterStr", type=str, default="all")
    p.add_argument("--pseudocount", type=float, default=0.0001)
    p.add_argument("--num_round", type=int, default=100)
    p.add_argument("--l2", type=float, default=100)
    p.add_argument("--l1", type=float, default=0)
    p.add_argument("--eta", type=float, default=0.01)
    p.add_argument("--base_score", type=float, default=2)
    p.add_argument("--threads", type=int, default=16, help="kept for CLI parity")
    p.add_argument("--kidney_genes_only", action="store_true",
                   help="only use genes with no NaNs in --kidney_exp_file (reference train.py:102-105)")
    p.add_argument("--kidney_exp_file", type=str, default="./resources/geneanno.exp_kidney.csv")
    p.add_argument("--match_with_basenji2", action="store_true",
                   help="only use genes whose id appears in --basenji2_tss_file's ens_id column "
                        "(reference train.py:107-112; the reference hard-codes a cluster path)")
    p.add_argument("--basenji2_tss_file", type=str, default=None)
    p.add_argument("--no_tf_features", action="store_true")
    p.add_argument("--no_dnase_features", action="store_true")
    p.add_argument("--no_histone_features", action="store_true")
    p.add_argument("--intersect_with_lambert", action="store_true")
    # the reference hard-codes these resource paths (cluster_utils.py:5-6)
    p.add_argument("--lambert_hgnc", default="./resources/Lambert-hgnc-symbol-check.csv")
    p.add_argument("--hgnc_mapping", default="./resources/beluga_hgnc_mapping.csv")
    p.add_argument("--no_pol2", action="store_true")
    p.add_argument("--seed", type=int, default=None, help="bootstrap resample seed (train_bootstrap.py)")
    p.add_argument("--bootstrap_seeds", type=int, default=None,
                   help="train N bootstrap resamples in one vectorized sweep "
                        "(replaces scripts/train_bootstrap.sh's N separate jobs)")
    p.add_argument("--allTissues", action="store_true",
                   help="train every expression column and write metrics.h5 (train_susztak.py)")
    p.add_argument("--vectorized", action="store_true",
                   help="with --allTissues: train all columns in one on-device sweep")
    p.add_argument("--output_dir", type=str, default="temp_expecto_model")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; raises if no GPU is present)")
    p.add_argument("--trace_dir", default=None,
                   help="profile the training into this directory: a Chrome trace (trace_*.json: the program's "
                        "spans, its host work and the card's kernels on one timeline) and the spans as JSON "
                        "lines (spans_*.jsonl)")
    return p


def main(argv=None) -> int:
    from ..utils.profiling import trace

    args = build_parser().parse_args(argv)
    with trace(args.trace_dir):
        return _train(args)


def _train(args) -> int:
    import os

    import numpy as np
    import pandas as pd

    from ..io.tables import load_beluga_features
    from ..models.gblinear import GBLinearParams
    from ..parallel import dist
    from ..parallel.mesh import local_device, maybe_initialize_distributed
    from ..pipeline.train import train_all_tissues, train_bootstrap, train_expression_model
    from ..utils.keep_mask import get_keep_mask

    if args.targetIndex is None and not args.allTissues:
        print("--targetIndex is required unless --allTissues is set", file=sys.stderr)
        return 2
    if args.allTissues and args.bootstrap_seeds:
        print("--allTissues and --bootstrap_seeds are mutually exclusive", file=sys.stderr)
        return 2
    # several ranks: join the process group before any CUDA work; the
    # training rows then shard across ranks (pipeline/train.py)
    maybe_initialize_distributed(args.device)
    device = local_device(args.device)

    Xreducedall = np.load(args.inputFile)
    geneanno = pd.read_csv(args.annoFile)
    geneexp = pd.read_csv(args.expFile)
    if not args.allTissues:
        print(f"Cell type: {geneexp.columns[args.targetIndex]}")

    if args.intersect_with_lambert and not (
        os.path.exists(args.lambert_hgnc) and os.path.exists(args.hgnc_mapping)
    ):
        print(
            "--intersect_with_lambert needs the Lambert/HGNC tables; pass "
            "--lambert_hgnc and --hgnc_mapping (defaults point at the "
            "reference's ./resources paths, cluster_utils.py:5-6)",
            file=sys.stderr,
        )
        return 2
    keep_mask = None
    if args.belugaFeatures and any(
        [args.no_tf_features, args.no_dnase_features, args.no_histone_features, args.intersect_with_lambert, args.no_pol2]
    ):
        keep_mask = get_keep_mask(
            load_beluga_features(args.belugaFeatures),
            args.no_tf_features, args.no_dnase_features, args.no_histone_features,
            args.intersect_with_lambert, args.no_pol2,
            lambert_hgnc_path=args.lambert_hgnc, hgnc_mapping_path=args.hgnc_mapping,
        )

    extra_filter = None
    if args.kidney_genes_only:
        print("Using only genes found in our kidney data...")
        kidney_exp_df = pd.read_csv(args.kidney_exp_file, index_col=0)
        extra_filter = ~np.asarray(kidney_exp_df.isnull().any(axis=1))
    if args.match_with_basenji2:
        if not args.basenji2_tss_file:
            print("--match_with_basenji2 requires --basenji2_tss_file", file=sys.stderr)
            return 2
        print("Using only genes found in our cultured primary tubule data...")
        tss_df = pd.read_csv(args.basenji2_tss_file, sep="\t", index_col=0)
        in_tss = geneanno["id"].isin(tss_df["ens_id"]).values
        extra_filter = in_tss if extra_filter is None else (extra_filter & in_tss)

    hp = GBLinearParams(
        eta=args.eta, reg_lambda=args.l2, reg_alpha=args.l1,
        base_score=args.base_score, num_round=args.num_round,
    )

    # created only once every validation above has passed: an error exit must
    # not litter the CWD with the reference's default `temp_expecto_model/`
    os.makedirs(args.output_dir, exist_ok=True)

    if args.allTissues:
        results = train_all_tissues(
            Xreducedall, geneanno, geneexp,
            output_dir=args.output_dir,
            metrics_path=os.path.join(args.output_dir, "metrics.h5"),
            vectorized=args.vectorized,
            params=hp, filter_str=args.filterStr, pseudocount=args.pseudocount,
            extra_filter=extra_filter, keep_mask=keep_mask, device=device,
        )
        for name, res in results.items():
            print(f"{name}: spearman (chr8 holdout) {res.spearman:.4f}")
        print(f"wrote {len(results)} tissue models + metrics.h5 to {args.output_dir}")
        return 0

    if args.bootstrap_seeds:
        results = train_bootstrap(
            Xreducedall, geneanno, geneexp.iloc[:, args.targetIndex].values,
            seeds=list(range(args.bootstrap_seeds)),
            output_dir=args.output_dir,
            params=hp, filter_str=args.filterStr, pseudocount=args.pseudocount,
            keep_mask=keep_mask, extra_filter=extra_filter, device=device,
        )
        rhos = np.array([r.spearman for r in results])
        print(f"trained {len(results)} bootstrap models; spearman mean {np.nanmean(rhos):.4f} sd {np.nanstd(rhos):.4f}")
        return 0

    seed_tag = f".seed{args.seed}" if args.seed is not None else ""
    prefix = os.path.join(
        args.output_dir,
        f"expecto_{args.filterStr}.pseudocount{args.pseudocount}.lambda{args.l2}"
        f".round{args.num_round}.basescore{args.base_score}.{geneexp.columns[args.targetIndex]}{seed_tag}",
    )
    res = train_expression_model(
        Xreducedall, geneanno, geneexp.iloc[:, args.targetIndex].values,
        filter_str=args.filterStr, pseudocount=args.pseudocount,
        params=hp, keep_mask=keep_mask, output_prefix=prefix,
        seed_resample=args.seed, extra_filter=extra_filter, verbose=True, device=device,
    )
    print(f"spearman (chr8 holdout): {res.spearman:.4f}")
    if args.evalFile and dist.is_primary():
        pd.DataFrame({"pred": res.test_pred, "target": res.test_true}).to_csv(args.evalFile)
    if res.train_pred is not None and dist.is_primary():
        from ..utils.plotting import plot_preds

        plot_preds(res.test_true, res.test_pred, os.path.join(args.output_dir, "test_plots.png"))
        plot_preds(res.train_true, res.train_pred, os.path.join(args.output_dir, "train_plots.png"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
