"""Rank-based inverse normal transformation (port of
expecto_tpu/analysis/rank_int.py; reference
util/rank_based_inverse_normal_transformation.py:11-61), used to normalize
SED scores per gene. Blom constant c = 3/8; ties broken stochastically with
the reference's fixed seed.

The JAX package seeds numpy's global state with 123 on every call; here
the draws come from an explicit ``np.random.RandomState`` that the call
reseeds with 123, which draws the same stream. A caller that passes its own
generator gets it back in the state the reference leaves the global state
in, which later draws of the analysis CLI depend on (``fimo-enrich
--rank_int``)."""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.stats as ss

#: the reference's fixed seed, set again before each transform
RANK_INT_SEED = 123


def rank_to_normal(rank, c: float, n: int):
    x = (rank - c) / (n - 2 * c + 1)
    return ss.norm.ppf(x)


def rank_INT(
    series: pd.Series, c: float = 3.0 / 8, stochastic: bool = True, *, rng: np.random.RandomState | None = None
) -> pd.Series:
    """Transform a series to normal via ranks; NaNs pass through as NaN.

    ``rng`` is reseeded with :data:`RANK_INT_SEED` first (a new
    ``RandomState`` when None), in either mode, as the reference reseeds the
    global state."""
    if not isinstance(series, pd.Series):
        series = pd.Series(series)
    if rng is None:
        rng = np.random.RandomState()
    rng.seed(RANK_INT_SEED)
    # work positionally: SED tables are often indexed by gene/SNP id with
    # duplicate labels, where label-based .loc permutation inflates rows and
    # the final reindex raises; positions are always unique (same draws as
    # the label permutation on unique indices, so results are unchanged)
    pos = np.flatnonzero(~pd.isnull(series).values)
    out = np.full(len(series), np.nan)
    if stochastic:
        perm = pos[rng.permutation(len(pos))]
        rank = ss.rankdata(series.values[perm], method="ordinal")
        out[perm] = rank_to_normal(rank, c=c, n=len(rank))
    else:
        rank = ss.rankdata(series.values[pos], method="average")
        out[pos] = rank_to_normal(rank, c=c, n=len(rank))
    return pd.Series(out, index=series.index)
