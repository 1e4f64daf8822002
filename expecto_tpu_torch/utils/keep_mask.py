"""Track-ablation mask over the 2,002 chromatin marks (port of
expecto_tpu/utils/keep_mask.py; reference cluster_utils.py:8-50).

Builds a boolean keep-mask used to predict on mark subsets: drop
TF/DNase/Histone assay types, drop Pol2*, or intersect TF assays with the
Lambert-2018 curated TF list via an HGNC symbol mapping.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def get_keep_mask(
    beluga_features_df: pd.DataFrame,
    no_tf_features: bool = False,
    no_dnase_features: bool = False,
    no_histone_features: bool = False,
    intersect_with_lambert: bool = False,
    no_pol2: bool = False,
    *,
    lambert_hgnc_path: str | None = None,
    hgnc_mapping_path: str | None = None,
) -> np.ndarray:
    keep_mask = np.ones(beluga_features_df.shape[0], dtype=bool)

    if no_tf_features:
        keep_mask &= (beluga_features_df["Assay type"] != "TF").values
    if no_dnase_features:
        keep_mask &= (beluga_features_df["Assay type"] != "DNase").values
    if no_histone_features:
        keep_mask &= (beluga_features_df["Assay type"] != "Histone").values

    if intersect_with_lambert:
        if lambert_hgnc_path is None or hgnc_mapping_path is None:
            raise ValueError("intersect_with_lambert requires lambert_hgnc_path and hgnc_mapping_path")
        lambert_df = pd.read_csv(lambert_hgnc_path, index_col=0)
        mapping = pd.read_csv(hgnc_mapping_path, index_col=0).dropna(subset=["Approved symbol"])
        hgnc_assays = list(beluga_features_df["Assay"].values)
        for i, assay in enumerate(hgnc_assays):
            if assay in mapping.index:
                match = mapping.loc[assay][["Match type", "Approved symbol"]]
                if len(match.shape) != 1:
                    # prefer the 'Approved symbol' row among multi-mapped
                    # assays; a renamed TF may map via alias/previous-symbol
                    # rows only (the reference IndexErrors there,
                    # cluster_utils.py:34): fall back to the first row
                    approved = match[match["Match type"] == "Approved symbol"]
                    match = (approved if len(approved) else match).iloc[0]
                hgnc_assays[i] = match["Approved symbol"].upper()
        hgnc_assays = pd.Series(hgnc_assays)
        # one-sided .upper(): mapped assay symbols are uppercased while the
        # Lambert list is compared verbatim, as the reference does
        # (cluster_utils.py:35,40); the shipped Lambert table stores
        # uppercase approved symbols, so this matches in practice
        keep_mask &= hgnc_assays.isin(lambert_df["Approved symbol"].values).values
        keep_mask &= (~hgnc_assays.isnull()).values

    if no_pol2:
        # startswith('Pol') as the reference (cluster_utils.py:46): despite
        # the flag's name it also drops Pol3 assays, kept for mask parity
        # with reference-trained models
        keep_mask &= (~beluga_features_df["Assay"].str.startswith("Pol")).values

    return keep_mask


def subset_features_by_mask(features: np.ndarray, keep_mask: np.ndarray, n_basis: int = 10, n_tracks: int = 2002) -> np.ndarray:
    """Subset basis-major features to kept marks (reference train.py:122,
    predict.py:142-147): (N, n_basis*n_tracks) -> (N, n_basis*n_kept)."""
    keep_indices = np.nonzero(keep_mask)[0]
    n = features.shape[0]
    return features.reshape(n, n_basis, n_tracks)[:, :, keep_indices].reshape(n, -1)
