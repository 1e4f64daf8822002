"""Exponential-decay spatial basis projection (ExPecto feature reduction).

Per-shift chromatin predictions are collapsed into per-gene / per-variant
features by weighting each shift with 10 basis functions — 5 decay rates
(0.01, 0.02, 0.05, 0.1, 0.2) x {upstream d<=0, downstream d>=0} of the
strand-corrected distance to TSS — and summing over shifts. Feature layout is
basis-major: ``feature[b*n_tracks + m]``.

Two variants exist in the reference and differ subtly:

- **gene path** (compute_expecto_features.py:90-101): distance = shift,
  weight = ``exp(-rate * |shift| / 200)`` (no floor), shifts
  ``range(-20000, 20000, 200)``.
- **variant path** (predict.py:87-109): distance = strand-corrected
  (variant TSS-distance + shift), weight =
  ``exp(-rate * floor(|d| / 200))`` (**with** floor).

Both sides of the indicator fire at d == 0 (<=0 and >=0 overlap) — preserved
exactly.

The reference computes the projection with a tile/repeat python loop
(predict.py:120-136); here it is a single einsum contraction
``(S,N,B) x (S,N,M) -> (N,B,M)`` that XLA maps onto the MXU.
"""

from __future__ import annotations

import numpy as np

DECAY_RATES = (0.01, 0.02, 0.05, 0.1, 0.2)
N_BASIS = 2 * len(DECAY_RATES)  # 10


def _basis_from_distance(d: np.ndarray, floor: bool) -> np.ndarray:
    """(..., ) distances -> (..., 10) basis weights."""
    d = np.asarray(d, dtype=np.float64)
    mag = np.abs(d) / 200.0
    if floor:
        mag = np.floor(mag)
    up = (d <= 0).astype(np.float64)
    down = (d >= 0).astype(np.float64)
    cols = [np.exp(-r * mag) * up for r in DECAY_RATES] + [np.exp(-r * mag) * down for r in DECAY_RATES]
    return np.stack(cols, axis=-1)


def gene_pos_weights(shifts) -> np.ndarray:
    """(10, n_shifts) weights of the gene path (no floor),
    reference compute_expecto_features.py:91-101."""
    return _basis_from_distance(np.asarray(shifts), floor=False).T


def variant_basis(snpdists, snpstrands, shifts) -> np.ndarray:
    """(n_shifts, n_variants, 10) basis of the variant path (with floor),
    reference predict.py:87-109.

    Args:
        snpdists: distances to TSS (sign convention of the closest-gene file;
            predict.py:242 negates the file's last column before calling).
        snpstrands: '+'/'-' strand array of the associated TSS.
        shifts: shift enumeration (reference: variant_shifts(maxshift)).
    """
    sign = (np.asarray(snpstrands) == "+") * 2 - 1
    d0 = np.asarray(snpdists) * sign
    out = [_basis_from_distance(d0 + s * sign, floor=True) for s in np.asarray(shifts)]
    return np.stack(out, axis=0)


def project_features(basis: np.ndarray, preds: np.ndarray) -> np.ndarray:
    """Sum over shifts of basis-weighted predictions.

    Args:
        basis: (S, N, B) or (B, S) [gene-path pos_weights with shared basis].
        preds: (S, N, M) per-shift per-item track predictions.

    Returns:
        (N, B*M) features, basis-major (feature[b*M + m]), matching the
        reference's tile/repeat layout (predict.py:123-124) and the gene
        path's ``.flatten()`` of (10, M) (compute_expecto_features.py:124).
    """
    preds = np.asarray(preds)
    # contract in fp32 unless the caller supplied fp64 predictions: the
    # float64 basis (numpy exp default) would otherwise promote the whole
    # contraction — 4x slower and no BLAS — for precision far below the
    # pipeline's tolerances (the reference's shipped features are fp32)
    dtype = np.result_type(preds.dtype, np.float32)
    basis = np.asarray(basis, dtype=dtype)
    preds = preds.astype(dtype, copy=False)
    if basis.ndim == 2:  # (B, S) shared across items
        # tensordot lowers to one BLAS matmul: (B,S) x (S, N*M)
        feat = np.moveaxis(np.tensordot(basis, preds, axes=([1], [0])), 0, 1)
    else:  # (S, N, B)
        feat = np.einsum("snb,snm->nbm", basis, preds, optimize=True)
    return feat.reshape(feat.shape[0], -1)


def pad_legacy_20030(features: np.ndarray, n_tracks: int = 2002) -> np.ndarray:
    """Legacy 20,030-feature layout: a zero column prepended per basis block
    (reference geuvadis_predict_consensus.py:122-124), for the original
    FunctionLab models trained with 2,003-track predictions."""
    n = features.shape[0]
    blocks = features.reshape(n, N_BASIS, n_tracks)
    return np.concatenate([np.zeros((n, N_BASIS, 1), features.dtype), blocks], axis=2).reshape(n, -1)
