"""Per-shift chromatin-effect HDF5 schemas (port of expecto_tpu/io/h5.py).

Two on-disk layouts exist in the wild and both are read and written:

- **fork schema** (reference chromatin.py:282-286): datasets ``diff``,
  ``ref``, ``alt``, each (2N, n_tracks) float32 — rows [0:N] forward strand,
  rows [N:2N] reverse complement (the encodeSeqs concat order,
  expecto_utils.py:36-38).
- **legacy schema** (original FunctionLab ExPecto; the bundled
  example/*.diff.h5): a single ``pred`` dataset of shape (2N, n_tracks)
  holding the diff only.

The consumer averages forward and RC halves: ``(x[:N] + x[N:2N]) / 2``
(predict.py:183-194).

``h5py`` is imported inside the functions that touch a file, so the serving
path (``cli/score.py``), which imports this module through pipeline/sed.py,
runs where h5py is not installed.
"""

from __future__ import annotations

import os

import numpy as np


def write_shift_h5(path: str | os.PathLike, diff: np.ndarray, ref: np.ndarray, alt: np.ndarray) -> None:
    """Write the fork schema (chromatin.py:282-286)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("diff", data=np.asarray(diff, np.float32))
        f.create_dataset("ref", data=np.asarray(ref, np.float32))
        f.create_dataset("alt", data=np.asarray(alt, np.float32))


def write_legacy_shift_h5(path: str | os.PathLike, diff: np.ndarray) -> None:
    """Write the legacy single-``pred`` schema, so tools written against
    original-ExPecto outputs can read this engine's files."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("pred", data=np.asarray(diff, np.float32))


def read_shift_h5(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Read either schema. Legacy files yield {'diff': pred} only."""
    import h5py

    with h5py.File(path, "r") as f:
        if "pred" in f:
            return {"diff": np.asarray(f["pred"])}
        return {name: np.asarray(f[name]) for name in ("diff", "ref", "alt") if name in f}


def avg_fwd_rc(x: np.ndarray) -> np.ndarray:
    """Average the forward [0:N] and reverse-complement [N:2N] row halves."""
    n = x.shape[0] // 2
    return (x[:n] + x[n : 2 * n]) / 2.0


def read_shift_h5_averaged(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Read one shift file and average the forward / reverse-complement halves
    (predict.py:183-194). Returns keys present in the file."""
    return {k: avg_fwd_rc(v) for k, v in read_shift_h5(path).items()}
