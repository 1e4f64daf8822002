"""Expression-model training drivers (port of expecto_tpu/pipeline/train.py;
reference train.py:83-159, train_bootstrap.py:88-98, train_susztak.py:87-181).

Shared semantics:
    - features: ``Xreducedall`` (n_genes, 20020), optionally keep-mask
      subset (train.py:122);
    - labels: ``log(expression + pseudocount)``;
    - gene filter: all (!= rRNA) / pc / lincRNA + finite labels;
    - split: train = all chroms except chrX/Y/8, test = chr8
      (train.py:127-129); the susztak variant holds out chr7+chr8 from train
      and validates on chr8 (train_susztak.py:117-122).

The bootstrap and multi-tissue sweeps replace the reference's 1000x shell
loops with one sweep of the deterministic trainer on the device
(models/gblinear.py), K models per product. Each function trains on
``device`` (default cuda; raises with no GPU). In a multi-process run
(parallel/mesh.py) each rank trains on its ``host_row_range`` slice of the
training genes through the all-reduced sharded trainers; weights are
replicated, so every rank computes the same metrics, and only the primary
writes files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import pandas as pd
from scipy.stats import spearmanr

from ..io.xgb import dump_text, save_expression_model
from ..models.gblinear import (
    GBLinearModel,
    GBLinearParams,
    bootstrap_row_weights,
    train_gblinear,
    train_gblinear_multi_sharded,
    train_gblinear_sharded,
)
from ..parallel import dist
from ..utils.keep_mask import subset_features_by_mask
from ..utils.plotting import r2_score


def gene_filter(geneanno: pd.DataFrame, filter_str: str) -> np.ndarray:
    """'all' (!= rRNA) / 'pc' / 'lincRNA' row filter (train.py:86-93)."""
    gene_type = geneanno.iloc[:, -1]
    if filter_str == "pc":
        return np.asarray(gene_type == "protein_coding")
    if filter_str == "lincRNA":
        return np.asarray(gene_type == "lincRNA")
    if filter_str == "all":
        return np.asarray(gene_type != "rRNA")
    raise ValueError("filterStr has to be one of all, pc, and lincRNA")


def chromosome_split(geneanno: pd.DataFrame, holdout_train: tuple = ("chrX", "chrY", "chr8"), test: str = "chr8"):
    """(train_mask, test_mask) by chromosome (train.py:127-129)."""
    seqnames = geneanno["seqnames"]
    train = np.ones(len(seqnames), dtype=bool)
    for c in holdout_train:
        train &= np.asarray(seqnames != c)
    return train, np.asarray(seqnames == test)


@dataclass
class TrainResult:
    model: GBLinearModel
    spearman: float
    test_pred: np.ndarray
    test_true: np.ndarray
    train_spearman: float | None = None
    train_pred: np.ndarray | None = None
    train_true: np.ndarray | None = None


def _spearman(pred, true) -> float:
    return float(spearmanr(pred, true).statistic) if len(true) > 1 else float("nan")


def train_expression_model(
    Xreducedall: np.ndarray,
    geneanno: pd.DataFrame,
    expression: np.ndarray,
    *,
    filter_str: str = "all",
    pseudocount: float = 1e-4,
    params: GBLinearParams | None = None,
    keep_mask: np.ndarray | None = None,
    n_tracks: int = 2002,
    output_prefix: str | os.PathLike | None = None,
    extra_filter: np.ndarray | None = None,
    seed_resample: int | None = None,
    holdout_train: tuple = ("chrX", "chrY", "chr8"),
    verbose: bool = False,
    distribute: bool = True,
    device="cuda",
) -> TrainResult:
    """Train one tissue model (reference train.py main).

    ``seed_resample`` draws a bootstrap resample of the training genes with
    replacement (train_bootstrap.py:88-98). ``holdout_train`` is the
    chromosomes excluded from training (train.py:127-129; the susztak sweep
    additionally holds out chr7, train_susztak.py:117-122). The per-round
    watchlist is the chr8 test genes ("eval") and the training genes
    ("train"), as the reference prints it (train.py:146-154). Early stopping
    never fires — the reference passes early_stopping_rounds where xgboost
    ignores it (train.py:140-146) — so all ``num_round`` rounds run.

    In a multi-process run (``distribute``) each rank trains on its
    ``host_row_range`` slice of the training genes
    (:func:`train_gblinear_sharded`); the watchlist's sets are the full
    test and train genes on every rank, and only the primary writes the
    ``.save``/``.dump`` files.
    """
    hp = params or GBLinearParams()
    X = Xreducedall
    if keep_mask is not None:
        X = subset_features_by_mask(X, keep_mask, n_tracks=n_tracks)

    labels = np.log(np.asarray(expression, dtype=np.float64) + pseudocount)
    filt = gene_filter(geneanno, filter_str) & np.isfinite(labels)
    if extra_filter is not None:
        filt &= extra_filter

    trainind, testind = chromosome_split(geneanno, holdout_train=holdout_train)
    tr = trainind & filt
    te = testind & filt

    tr_idx = np.nonzero(tr)[0]
    if seed_resample is not None:
        rs = np.random.RandomState(seed_resample)
        tr_idx = rs.choice(tr_idx, size=tr_idx.shape[0], replace=True)

    X_tr, y_tr = X[tr_idx], labels[tr_idx].astype(np.float32)
    X_te, y_te = X[te], labels[te].astype(np.float32)

    evals = [(X_te, y_te, "eval"), (X_tr, y_tr, "train")]
    if distribute and dist.process_info()[1] > 1:
        lo, hi = dist.host_row_range(len(tr_idx))
        model = train_gblinear_sharded(X_tr[lo:hi], y_tr[lo:hi], hp, evals=evals, verbose=verbose, device=device)
    else:
        model = train_gblinear(X_tr, y_tr, hp, evals=evals, verbose=verbose, device=device)
    pred_te = model.predict(X_te)
    pred_tr = model.predict(X_tr)

    if output_prefix is not None and dist.is_primary():
        save_expression_model(model, str(output_prefix) + ".save")
        with open(str(output_prefix) + ".dump", "w") as f:
            f.write(dump_text(model))

    return TrainResult(
        model=model, spearman=_spearman(pred_te, y_te), test_pred=pred_te, test_true=y_te,
        train_spearman=_spearman(pred_tr, y_tr), train_pred=pred_tr, train_true=y_tr,
    )


def train_bootstrap(
    Xreducedall: np.ndarray,
    geneanno: pd.DataFrame,
    expression: np.ndarray,
    seeds: list[int],
    *,
    output_dir: str | os.PathLike | None = None,
    vectorized: bool = True,
    device="cuda",
    **kwargs,
) -> list[TrainResult]:
    """Bootstrap sweep (replaces scripts/train_bootstrap.sh:4-7's 1000-job
    shell loop).

    ``vectorized=True`` trains all seeds **simultaneously** on the device:
    with-replacement resampling is expressed as per-seed integer row weights
    (weighted least squares == training on the resampled rows), so K seeds
    cost one sweep with (n, K) residual products instead of K sweeps. In a
    multi-process run the weights are drawn for all training genes, then
    each rank takes its ``host_row_range`` rows of them.
    """
    if not vectorized:
        results = []
        for seed in seeds:
            prefix = None
            if output_dir is not None:
                os.makedirs(output_dir, exist_ok=True)
                prefix = os.path.join(output_dir, f"bootstrap_seed{seed}")
            results.append(
                train_expression_model(
                    Xreducedall, geneanno, expression, seed_resample=seed, output_prefix=prefix, device=device,
                    **kwargs,
                )
            )
        return results

    hp = kwargs.pop("params", None) or GBLinearParams()
    filter_str = kwargs.pop("filter_str", "all")
    pseudocount = kwargs.pop("pseudocount", 1e-4)
    keep_mask = kwargs.pop("keep_mask", None)
    n_tracks = kwargs.pop("n_tracks", 2002)
    extra_filter = kwargs.pop("extra_filter", None)
    verbose = kwargs.pop("verbose", False)
    if kwargs:
        raise TypeError(f"unsupported kwargs for vectorized bootstrap: {sorted(kwargs)}")

    X = Xreducedall
    if keep_mask is not None:
        X = subset_features_by_mask(X, keep_mask, n_tracks=n_tracks)
    labels = np.log(np.asarray(expression, dtype=np.float64) + pseudocount)
    filt = gene_filter(geneanno, filter_str) & np.isfinite(labels)
    if extra_filter is not None:
        filt = filt & np.asarray(extra_filter)
    trainind, testind = chromosome_split(geneanno)
    tr = np.nonzero(trainind & filt)[0]
    te = np.nonzero(testind & filt)[0]

    y_tr = labels[tr].astype(np.float32)
    row_w = bootstrap_row_weights(len(tr), seeds)
    # this rank's rows (all of them in one process, where the sharded
    # trainer is train_gblinear_multi bit for bit)
    lo, hi = dist.host_row_range(len(tr))
    multi = train_gblinear_multi_sharded(
        X[tr[lo:hi]], np.tile(y_tr[lo:hi, None], (1, len(seeds))), hp, row_weights_local=row_w[lo:hi],
        verbose=verbose, device=device,
    )

    results = []
    X_te, y_te = X[te], labels[te].astype(np.float32)
    # one contiguous row a model: einsum over a strided column of (F, K)
    # runs an unvectorised loop, about 0.1 s a model at F = 20,020
    weights = np.ascontiguousarray(multi.weights.T)
    for j, seed in enumerate(seeds):
        model = GBLinearModel(weight=weights[j], bias=float(multi.biases[j]), base_score=hp.base_score)
        pred = model.predict(X_te)
        if output_dir is not None and dist.is_primary():
            os.makedirs(output_dir, exist_ok=True)
            save_expression_model(model, os.path.join(output_dir, f"bootstrap_seed{seed}.save"))
            save_expression_model(model, os.path.join(output_dir, f"bootstrap_seed{seed}.dump"))
        results.append(TrainResult(model=model, spearman=_spearman(pred, y_te), test_pred=pred, test_true=y_te))
    return results


def _pearson_r2(pred, true) -> tuple[float, float]:
    from scipy.stats import pearsonr

    if pred is None or true is None:
        return float("nan"), float("nan")
    finite = np.isfinite(pred) & np.isfinite(true)
    if finite.sum() <= 1:
        return float("nan"), float("nan")
    return float(pearsonr(pred[finite], true[finite]).statistic), r2_score(true[finite], pred[finite])


def train_all_tissues(
    Xreducedall: np.ndarray,
    geneanno: pd.DataFrame,
    expression_df: pd.DataFrame,
    *,
    target_indices: list[int] | None = None,
    output_dir: str | os.PathLike | None = None,
    metrics_path: str | os.PathLike | None = None,
    vectorized: bool = False,
    holdout_train: tuple = ("chrX", "chrY", "chr7", "chr8"),
    device="cuda",
    **kwargs,
) -> dict[str, TrainResult]:
    """Multi-tissue sweep over expression columns with a metrics.h5 summary
    (reference train_susztak.py:87-181).

    The default train split holds out chr7 AND chr8, matching the reference
    multi-tissue trainer exactly (train_susztak.py:117-122; the single-model
    trainer holds out only chr8, train.py:127-129). ``vectorized=True``
    trains all columns simultaneously in one multi-model sweep
    (:func:`train_gblinear_multi_sharded` over this rank's rows; (n, K)
    residual products); only rows where every column is
    finite participate in that mode (the per-column mode keeps per-column
    finite filters). That mode scores every column's train and test genes
    with one (n, F) x (F, K) product on the host, not one einsum a model:
    the same predictions within fp32 summation noise, at the cost of one
    product instead of K.
    """
    indices = target_indices if target_indices is not None else list(range(1, expression_df.shape[1]))
    names = [str(expression_df.columns[idx]) for idx in indices]
    if len(set(names)) != len(names):
        import warnings

        warnings.warn(
            "duplicate expression column names: later tissues overwrite "
            "earlier ones in the results dict and on disk (expecto_<name>.save)",
            stacklevel=2,
        )
    results: dict[str, TrainResult] = {}
    # reference metrics.h5 key set (train_susztak.py:177-181, consumed by
    # plot_susztak.py:64-83) plus this engine's extra spearman/tissue columns
    metrics = {
        "pearsonr_valids": [], "r2_valids": [], "pearsonr_trains": [], "r2_trains": [],
        "spearman_valid": [], "tissue": [],
    }

    def _record(name: str, res: TrainResult) -> None:
        results[name] = res
        metrics["tissue"].append(name)
        metrics["spearman_valid"].append(res.spearman)
        pr_v, r2_v = _pearson_r2(res.test_pred, res.test_true)
        pr_t, r2_t = _pearson_r2(res.train_pred, res.train_true)
        metrics["pearsonr_valids"].append(pr_v)
        metrics["r2_valids"].append(r2_v)
        metrics["pearsonr_trains"].append(pr_t)
        metrics["r2_trains"].append(r2_t)

    if vectorized:
        hp = kwargs.pop("params", None) or GBLinearParams()
        filter_str = kwargs.pop("filter_str", "all")
        pseudocount = kwargs.pop("pseudocount", 1e-4)
        extra_filter = kwargs.pop("extra_filter", None)
        keep_mask = kwargs.pop("keep_mask", None)
        n_tracks = kwargs.pop("n_tracks", 2002)
        verbose = kwargs.pop("verbose", False)
        if kwargs:
            raise TypeError(f"unsupported kwargs for vectorized sweep: {sorted(kwargs)}")
        if keep_mask is not None:
            Xreducedall = subset_features_by_mask(Xreducedall, keep_mask, n_tracks=n_tracks)
        Y = np.log(expression_df.iloc[:, indices].values.astype(np.float64) + pseudocount)
        filt = gene_filter(geneanno, filter_str) & np.isfinite(Y).all(axis=1)
        if extra_filter is not None:
            filt = filt & np.asarray(extra_filter)
        trainind, testind = chromosome_split(geneanno, holdout_train=holdout_train)
        tr = trainind & filt
        te = testind & filt
        X_tr, Y_tr = Xreducedall[tr], Y[tr]
        lo, hi = dist.host_row_range(X_tr.shape[0])  # every row in one process
        multi = train_gblinear_multi_sharded(X_tr[lo:hi], Y_tr[lo:hi].astype(np.float32), hp, verbose=verbose,
                                             device=device)
        X_te, Y_te = Xreducedall[te], Y[te]
        offset = (hp.base_score + multi.biases).astype(np.float32)
        P_te = np.ascontiguousarray((np.asarray(X_te, np.float32) @ multi.weights + offset).T)
        P_tr = np.ascontiguousarray((np.asarray(X_tr, np.float32) @ multi.weights + offset).T)
        weights = np.ascontiguousarray(multi.weights.T)
        for j, name in enumerate(names):
            model = GBLinearModel(weight=weights[j], bias=float(multi.biases[j]), base_score=hp.base_score)
            if output_dir is not None and dist.is_primary():
                os.makedirs(output_dir, exist_ok=True)
                save_expression_model(model, os.path.join(output_dir, f"expecto_{name}.save"))
                save_expression_model(model, os.path.join(output_dir, f"expecto_{name}.dump"))
            _record(name, TrainResult(
                model=model, spearman=_spearman(P_te[j], Y_te[:, j]), test_pred=P_te[j],
                test_true=Y_te[:, j].astype(np.float32), train_spearman=_spearman(P_tr[j], Y_tr[:, j]),
                train_pred=P_tr[j], train_true=Y_tr[:, j].astype(np.float32),
            ))
    else:
        for idx, name in zip(indices, names):
            prefix = None
            if output_dir is not None:
                os.makedirs(output_dir, exist_ok=True)
                prefix = os.path.join(output_dir, f"expecto_{name}")
            res = train_expression_model(
                Xreducedall, geneanno, expression_df.iloc[:, idx].values,
                output_prefix=prefix, holdout_train=holdout_train, device=device, **kwargs
            )
            _record(name, res)

    if metrics_path is not None and dist.is_primary():
        import h5py

        with h5py.File(metrics_path, "w") as f:
            # exactly the reference key set (train_susztak.py:177-181) ...
            for key in ("pearsonr_valids", "r2_valids", "pearsonr_trains", "r2_trains"):
                f.create_dataset(key, data=np.asarray(metrics[key]))
            # ... plus clearly-named engine extras
            f.create_dataset("spearman_valid", data=np.asarray(metrics["spearman_valid"]))
            f.create_dataset("tissue", data=np.array(metrics["tissue"], dtype="S"))
    return results
