"""Plotting helpers of the training CLI (port of the ``plot_preds`` part of
expecto_tpu/utils/plotting.py; reference train.py:162-184). Matplotlib is
imported lazily with the Agg backend so headless runs work, and R² is
computed here in numpy (:func:`r2_score`), so nothing needs scikit-learn.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def r2_score(y_true, y_pred) -> float:
    """Coefficient of determination 1 - SS_res / SS_tot of one output,
    computed as ``sklearn.metrics.r2_score`` computes it: in the inputs'
    floating dtype (float64 for integers); NaN for fewer than two samples;
    1.0 for a constant ``y_true`` predicted exactly, else 0.0 for a constant
    ``y_true``."""
    dtype = np.result_type(np.asarray(y_true), np.asarray(y_pred), np.float32)
    yt = np.asarray(y_true, dtype=dtype)
    yp = np.asarray(y_pred, dtype=dtype)
    if yt.shape[0] < 2:
        return float("nan")
    ss_res = np.sum((yt - yp) ** 2)
    ss_tot = np.sum((yt - np.mean(yt)) ** 2)
    if ss_tot == 0:
        return 1.0 if ss_res == 0 else 0.0
    return float(1 - ss_res / ss_tot)


def plot_preds(ytrue, ypred, out_path, *, xlabel="Labels (log RPM)", ylabel="Predictions (log RPM)", title=None):
    """Pred-vs-label scatter with Pearson/R2/Spearman in the title
    (train.py:162-180)."""
    from scipy.stats import pearsonr, spearmanr

    plt = _plt()
    ytrue = np.asarray(ytrue)
    ypred = np.asarray(ypred)
    fig, ax = plt.subplots()
    ax.scatter(ytrue, ypred, color="black", alpha=0.3, s=20)
    ax.plot([0, 1], [0, 1], c="orange", transform=ax.transAxes)
    ax.set_xlim(np.min(ytrue), np.max(ytrue))
    ax.set_ylim(np.min(ytrue), np.max(ytrue))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    pr = pearsonr(ytrue, ypred).statistic
    r2 = r2_score(ytrue, ypred)
    sr = spearmanr(ytrue, ypred).statistic
    head = f"{title}\n" if title else ""
    ax.set_title(f"{head}PearsonR: {pr:.3f}, R2: {r2:.3f}, SpearmanR: {sr:.3f}")
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return {"pearsonr": float(pr), "r2": float(r2), "spearmanr": float(sr)}
