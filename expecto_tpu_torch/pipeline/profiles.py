"""Expression profiles (port of expecto_tpu/pipeline/profiles.py;
reference resources/make_geneanno*.py,
data_processing/make_geneanno_susztak.py): join a counts matrix onto the
geneanno row order (by Ensembl id or symbol), optionally undo a
log2(RPM + c) transform, and optionally rank-match each column to a
reference profile (double-argsort)."""

from __future__ import annotations

import numpy as np
import pandas as pd


def join_counts_to_geneanno(
    geneanno: pd.DataFrame,
    counts_df: pd.DataFrame,
    columns: list[str] | None = None,
    *,
    on: str = "index",
    log2_offset: float | None = None,
) -> pd.DataFrame:
    """Left-join counts onto the geneanno row order.

    Args:
        on: 'index' joins on Ensembl id index (make_geneanno.py:23); 'symbol'
            joins on the gene symbol column (make_geneanno_for_pbmc.py:24).
        log2_offset: if set, counts are log2(RPM + offset) and are converted
            back to linear RPM first (make_geneanno_for_pbmc.py:22).
        columns: subset/order of output columns (defaults to all counts
            columns).
    """
    if log2_offset is not None:
        counts_df = np.exp2(counts_df) - log2_offset
    if on == "index":
        merged = geneanno.merge(counts_df, how="left", left_index=True, right_index=True)
    elif on == "symbol":
        merged = geneanno.merge(counts_df, how="left", left_on="symbol", right_index=True)
    else:
        raise ValueError("on must be 'index' or 'symbol'")
    cols = columns if columns is not None else list(counts_df.columns)
    out = merged.loc[:, cols]
    if len(out) != len(geneanno):
        # a duplicated join key emits one row per match; the profile would
        # silently stop row-aligning with geneanno/Xreducedall (the
        # reference's left-merge has the same hazard, make_geneanno.py:23)
        import warnings

        warnings.warn(
            f"counts join produced {len(out)} rows for {len(geneanno)} genes — "
            f"duplicate '{on}' keys in the counts table; the profile no longer "
            "row-aligns with geneanno (dedupe the counts index first)",
            stacklevel=2,
        )
    out.index = range(1, len(out.index) + 1)
    return out


def rank_match_to_profile(df_out: pd.DataFrame, reference_col: pd.Series) -> pd.DataFrame:
    """Replace each column's values with the reference profile's values at
    matching ranks (double-argsort; make_geneanno.py:28-40). Rows with any
    NaN stay NaN.

    NaNs are masked from ``df_out`` only, exactly as the reference does:
    a NaN inside ``reference_col`` at a row where ``df_out`` is valid sorts
    to the END of the sorted reference values and lands on the top-ranked
    gene (make_geneanno.py:30-37) — pre-clean the reference profile if it
    can contain missing values."""
    df_out = df_out.copy()
    nan_mask = np.any(df_out.isnull(), axis=1).values
    col_to_match = pd.Series(reference_col).reset_index(drop=True)
    col_to_match = col_to_match[~nan_mask]
    sorted_vals = np.sort(col_to_match)
    for j in range(df_out.shape[1]):
        # float64 copy: integer counts columns cannot hold NaN, and the
        # reference profile's values are generally fractional
        vals = df_out.iloc[:, j].values.astype(np.float64, copy=True)
        ranks = vals[~nan_mask].argsort().argsort()
        vals[~nan_mask] = sorted_vals[ranks]
        vals[nan_mask] = np.nan
        df_out.isetitem(j, vals)
    return df_out
