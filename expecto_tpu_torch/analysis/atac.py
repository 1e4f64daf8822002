"""ATAC-peak x predicted-ChIP intersection features (port of
expecto_tpu/analysis/atac.py; reference expecto_intersect_chip_atac.py:73-107,
200-219).

DeepSEA-style binning: the TSS receptive field (200 bins x 200 bp) is
intersected with ATAC peaks; a bin is 1 iff more than 100 bp overlap a peak.
Predicted TF/Histone tracks are multiplied by the binary mask per shift
before the decay projection. pybedtools is replaced by an in-house interval
intersection.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def intersect_intervals(window: tuple[int, int], intervals: np.ndarray) -> np.ndarray:
    """Clip (start, end) 0-based half-open intervals to ``window``; drops
    empties. ``intervals`` is (n, 2)."""
    lo, hi = window
    if len(intervals) == 0:
        return np.empty((0, 2), dtype=np.int64)
    starts = np.maximum(np.asarray(intervals)[:, 0], lo)
    ends = np.minimum(np.asarray(intervals)[:, 1], hi)
    keep = starts < ends
    return np.stack([starts[keep], ends[keep]], axis=1)


def load_peaks_bed(path: str) -> dict[str, np.ndarray]:
    """BED file -> {chrom: (n, 2) int array} of 0-based half-open peaks."""
    df = pd.read_csv(path, sep="\t", header=None, comment="#", usecols=[0, 1, 2])
    return {
        chrom: grp.iloc[:, 1:3].values.astype(np.int64)
        for chrom, grp in df.groupby(df.columns[0])
    }


def get_atac_peak_bins(
    chrom: str,
    tss: int,
    strand: int,
    peaks_by_chrom: dict[str, np.ndarray],
    *,
    n_bins: int = 200,
    bin_size: int = 200,
    min_overlap: int = 100,
) -> np.ndarray:
    """(n_bins,) binary mask; bin i == 1 iff > ``min_overlap`` bp of it
    overlap a peak (expecto_intersect_chip_atac.py:200-219, including its
    receptive-field offsets rf = [tss - 20899 - strand*100,
    tss + 20900 - strand*100))."""
    rf_start = tss - 20899 - strand * 100
    rf_end = tss + 20900 - strand * 100
    peaks = intersect_intervals((rf_start, rf_end), peaks_by_chrom.get(chrom, np.empty((0, 2))))

    peak_regions = np.zeros(n_bins * bin_size)
    for start, end in peaks:
        start_pos, end_pos = int(start) - rf_start, int(end) - rf_start
        # end_pos + 1 credits each half-open peak with one base it does not
        # cover, as the reference does (expecto_intersect_chip_atac.py:214,
        # `[start_pos:end_pos + 1]`); kept so masks match reference features
        peak_regions[start_pos : end_pos + 1] = 1
    per_bin = peak_regions.reshape(-1, bin_size).sum(axis=1)
    return (per_bin > min_overlap).astype("float")


def apply_peak_mask(preds: np.ndarray, binned_peaks: np.ndarray, chip_track_indices: np.ndarray) -> np.ndarray:
    """Multiply predicted ChIP tracks by the per-shift peak mask
    (expecto_intersect_chip_atac.py:98-101). ``preds`` is
    (n_shifts, n_tracks); the mask applies along the shift axis."""
    out = preds.copy()
    out[:, chip_track_indices] = out[:, chip_track_indices] * binned_peaks[..., None]
    return out
