"""Bootstrap coefficient statistics (port of
expecto_tpu/analysis/bootstrap.py; reference
plot_bootstrapped_coefficients.py:46-81): per-weight standard errors over
bootstrap models, z-scores of the main model's weights, and
coefficient-of-variation ranking."""

from __future__ import annotations

import glob
from dataclasses import dataclass

import numpy as np
import pandas as pd

from ..io.xgb import load_expression_model
from ..models.gblinear import GBLinearModel
from ..pipeline.merge import natsorted


@dataclass
class BootstrapStats:
    se_weight: np.ndarray
    se_bias: float
    z_score: np.ndarray
    coeff_of_var: np.ndarray
    all_weights: np.ndarray


def bootstrap_coefficient_stats(
    bootstrap_models: list[GBLinearModel],
    main_model: GBLinearModel,
) -> BootstrapStats:
    all_weights = np.vstack([m.weight for m in bootstrap_models])
    all_biases = np.array([m.bias for m in bootstrap_models])
    se_weight = np.std(all_weights, axis=0, ddof=1)
    se_bias = float(np.std(all_biases, ddof=1))
    z = np.asarray(main_model.weight) / se_weight
    cv = se_weight / np.abs(np.mean(all_weights, axis=0))
    return BootstrapStats(se_weight=se_weight, se_bias=se_bias, z_score=z, coeff_of_var=cv, all_weights=all_weights)


def load_bootstrap_models(model_dir: str, pattern: str = "*/*.save", limit: int = 800) -> list[GBLinearModel]:
    """Load up to ``limit`` bootstrap model files in natural-sort order
    (plot_bootstrapped_coefficients.py:48-49)."""
    files = natsorted(glob.glob(f"{model_dir}/{pattern}"))[:limit]
    return [load_expression_model(f) for f in files]


def features_sorted_by_zscore(
    input_features_df: pd.DataFrame, stats: BootstrapStats, n_basis: int = 10
) -> pd.DataFrame:
    """Annotate a per-feature table with z-scores and sort by |z|
    (plot_bootstrapped_coefficients.py:64-69).

    Model weights are basis-major (feature b*M + m, ops/decay.py) while
    all_feature_clusters.tsv rows are mark-major (mark repeated per basis
    coefficient) — the z-vector is reordered to mark-major before
    assignment. The reference assigns positionally without reordering
    (plot_bootstrapped_coefficients.py:65), annotating almost every row
    with another feature's z-score; the JAX package fixed that, and so
    does this port.
    """
    df = input_features_df.copy()
    z = np.asarray(stats.z_score)
    if df.shape[0] == z.shape[0] and z.shape[0] % n_basis == 0:
        z = z.reshape(n_basis, -1).T.ravel()  # basis-major -> mark-major
    df["z_score"] = z
    df["_absz"] = np.abs(df["z_score"])
    df = df.sort_values(by="_absz", ascending=False).reset_index(drop=True)
    return df.drop("_absz", axis=1)
