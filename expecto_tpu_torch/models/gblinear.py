"""gblinear expression model: the prediction side only.

A trained model predicts ``base_score + bias + X @ weight``. The serving
path stacks every tissue model's weights into one matrix and scores them on
the device (parallel/runner.py); :func:`predict_gblinear` is the host
single-model form.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GBLinearModel:
    """Trained model: prediction = base_score + bias + X @ weight."""

    weight: np.ndarray
    bias: float
    base_score: float = 2.0

    @property
    def n_features(self) -> int:
        return int(self.weight.shape[0])

    def predict(self, X: np.ndarray) -> np.ndarray:
        return predict_gblinear(self, X)


def predict_gblinear(model: GBLinearModel, X) -> np.ndarray:
    # einsum (not BLAS gemv): its fixed contraction order scores a row the
    # same whatever the number of rows in the call
    X = np.asarray(X, dtype=np.float32)
    w = np.asarray(model.weight, dtype=np.float32)
    return (model.base_score + model.bias + np.einsum("...f,f->...", X, w)).astype(np.float32)
