"""Linear-model attribution: per-mark and per-cluster SED contributions
(port of expecto_tpu/analysis/interpret.py; reference
predict_by_cluster.py:72-124, predict_by_cluster_rsat.py:122-144).

For a linear expression model the SED decomposes exactly over features:
``SED = sum_j w_j (alt_j - ref_j)``. Contributions are reshaped
(n_snps, 10 basis, n_marks), summed over the basis axis, and normalized to
proportions. Host numpy.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..models.gblinear import GBLinearModel


def model_coefficients(model: GBLinearModel) -> tuple[np.ndarray, float]:
    """(weights, bias): what parsing the gblinear text dump gives
    (plot_bootstrapped_coefficients.py:105-109)."""
    return np.asarray(model.weight, dtype=np.float64), float(model.bias)


def interpret_model(model: GBLinearModel, ref_features: np.ndarray, alt_features: np.ndarray, n_basis: int = 10) -> np.ndarray:
    """(n_snps, n_marks) per-mark contribution proportions
    (predict_by_cluster.py:72-86). The bias cancels in the difference."""
    weights, _ = model_coefficients(model)
    contrib = weights * (np.asarray(alt_features) - np.asarray(ref_features))
    n = contrib.shape[0]
    per_mark = contrib.reshape(n, n_basis, -1).transpose(0, 2, 1).sum(axis=-1)
    return per_mark / per_mark.sum(axis=-1, keepdims=True)


def interpret_model_with_clusters(
    model: GBLinearModel,
    ref_features: np.ndarray,
    alt_features: np.ndarray,
    clusters: pd.Series,
    n_basis: int = 10,
) -> np.ndarray:
    """(n_snps, n_clusters) cluster-grouped contribution proportions
    (predict_by_cluster.py:89-111). ``clusters`` assigns one label per mark;
    labels are repeated over the basis axis before grouping, and the
    columns follow the sorted labels."""
    weights, _ = model_coefficients(model)
    contrib = weights * (np.asarray(alt_features) - np.asarray(ref_features))
    n = contrib.shape[0]
    per = contrib.reshape(n, n_basis, -1).transpose(0, 2, 1)  # (n, marks, basis)
    df = pd.DataFrame(per.reshape(n, -1).T)
    cluster_labels = np.repeat(np.asarray(clusters), n_basis)
    if cluster_labels.shape[0] != df.shape[0]:
        raise AssertionError("cluster labels and output preds df should match shape")
    df["cluster"] = cluster_labels
    cluster_contribs = df.groupby("cluster").sum().values.T
    return cluster_contribs / cluster_contribs.sum(axis=-1, keepdims=True)


def interpret_model_multi_membership(
    model: GBLinearModel,
    ref_features: np.ndarray,
    alt_features: np.ndarray,
    membership: np.ndarray,
    n_basis: int = 10,
) -> np.ndarray:
    """RSAT-style multi-membership attribution
    (predict_by_cluster_rsat.py:122-144): ``membership`` is a binary
    (n_marks, n_clusters) matrix, and a mark may belong to several motif
    clusters. Returns (n_snps, n_clusters) proportions."""
    weights, _ = model_coefficients(model)
    contrib = weights * (np.asarray(alt_features) - np.asarray(ref_features))
    n = contrib.shape[0]
    per_mark = contrib.reshape(n, n_basis, -1).sum(axis=1)  # (n, marks)
    cluster_contribs = per_mark @ np.asarray(membership, dtype=np.float64)
    return cluster_contribs / cluster_contribs.sum(axis=-1, keepdims=True)
