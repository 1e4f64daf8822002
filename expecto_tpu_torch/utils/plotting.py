"""Plotting helpers (port of expecto_tpu/utils/plotting.py; reference
train.py:162-184, plot_susztak.py:20-84, plot_data_distributions.py) of
the training and analysis CLIs. Matplotlib is imported lazily with the Agg
backend so headless runs work, and R² is computed here in numpy
(:func:`r2_score`), so nothing needs scikit-learn.
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


def plot_scatter_hist(x, y, out_path, *, xlabel, ylabel, highlight_last=True):
    """Train-vs-valid metric scatter with marginal histograms
    (plot_susztak.py:20-62). The reference highlights the last point in
    orange ("averaged expression" — its expression table's final column is
    the cross-tissue average); ``highlight_last`` keeps that convention."""
    plt = _plt()
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xymax = max(np.max(x), np.max(y))
    xymin = min(np.min(x), np.min(y))
    max_lim, min_lim = xymax + 0.002, xymin - 0.002

    left, width = 0.12, 0.65
    bottom, height = 0.1, 0.65
    spacing = 0.005
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_axes([left, bottom, width, height])
    ax_histx = fig.add_axes([left, bottom + height + spacing, width, 0.2], sharex=ax)
    ax_histy = fig.add_axes([left + width + spacing, bottom, 0.2, height], sharey=ax)
    ax_histx.tick_params(axis="x", labelbottom=False)
    ax_histy.tick_params(axis="y", labelleft=False)

    if highlight_last and len(x) > 1:
        ax.scatter(x[:-1], y[:-1], c="black", s=30)
        ax.scatter(x[-1:], y[-1:], c="orange", s=30, label="averaged expression")
        ax.legend()
    else:
        ax.scatter(x, y, c="black", s=30)
    ax.set_xlim(min_lim, max_lim)
    ax.set_ylim(min_lim, max_lim)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)

    binwidth = (xymax - xymin) / 15
    if binwidth > 0:
        bins = np.arange(xymin, xymax, binwidth)
        ax_histx.hist(x, bins=bins, alpha=0.8)
        ax_histy.hist(y, bins=bins, orientation="horizontal", alpha=0.8)
    fig.savefig(out_path, dpi=300)
    plt.close(fig)


def plot_metric_hist(values, out_path, *, bins=30, xlabel="metric", title=None):
    """Histogram of per-tissue metrics (plot_susztak.py style)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.hist(np.asarray(values), bins=bins)
    ax.set_xlabel(xlabel)
    if title:
        ax.set_title(title)
    fig.savefig(out_path, dpi=300)
    plt.close(fig)


def plot_expression_distributions(expression_df, out_path, *, pseudocount=1e-4, log=True):
    """Per-column expression histograms (plot_data_distributions.py:10-60)."""
    plt = _plt()
    cols = [c for c in expression_df.columns if np.issubdtype(expression_df[c].dtype, np.number)]
    fig, axes = plt.subplots(len(cols), 1, figsize=(6, 2.5 * max(len(cols), 1)), squeeze=False)
    for ax, col in zip(axes[:, 0], cols):
        vals = expression_df[col].dropna().values
        if log:
            vals = np.log(vals + pseudocount)
        ax.hist(vals, bins=50)
        ax.set_title(str(col))
    fig.tight_layout()
    fig.savefig(out_path, dpi=200)
    plt.close(fig)
