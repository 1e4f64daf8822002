"""Regularized linear booster ("gblinear"): prediction and the block
coordinate-descent trainers (port of expecto_tpu/models/gblinear.py).

A trained model predicts ``base_score + bias + X @ weight``. The serving
path stacks every tissue model's weights into one matrix and scores them on
the device (parallel/runner.py); :func:`predict_gblinear` is the host
single-model form.

Training follows xgboost 0.7's gblinear rule (reference train.py:140-146:
``eta`` 0.01, ``lambda`` 100, ``base_score`` 2, 100 rounds): squared-error
gradients, a bias step ``db = -eta * sum(g) / (n + lambda_bias)`` before
each round's feature sweep, and per feature ``dw = eta * delta(G, H, w)``,
the elastic-net coordinate solution (ops/gblinear_cd.py). The sweep is
deterministic block coordinate descent: a Python loop over feature blocks
of ``block_size`` (the JAX package's ``lax.scan``), Jacobi within a block
(every feature's gradient from one product ``X_blk @ r``), the residual
advanced once per block by a second product. A block step is those two
``torch.matmul`` products and one launch of the coordinate-update kernel
(``csrc/gblinear_cd.cu``); nothing in a round waits for the host.

The row-sharded multi-process trainers of the JAX package are not ported
here (they need ``torch.distributed``).
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.gblinear_cd import coord_update
from ..parallel.runner import resolve_device

#: ``GBLinearParams.precision`` -> ``torch.set_float32_matmul_precision`` for
#: the trainers' products: "highest" is true fp32 (TF32 off); JAX's "default"
#: and "high" mean TF32 on a GPU, and so they do here. CPU products are fp32.
_MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "high"}


@dataclass(frozen=True)
class GBLinearParams:
    """Hyperparameters; defaults mirror the reference training CLI
    (train.py:43-52)."""

    eta: float = 0.01
    reg_lambda: float = 100.0
    reg_alpha: float = 0.0
    reg_lambda_bias: float = 0.0
    base_score: float = 2.0
    num_round: int = 100
    block_size: int = 512
    early_stopping_rounds: int | None = None
    #: matmul precision of the training products: "highest" is true fp32
    #: and keeps trained weights tracking xgboost 0.7 (the parity claim);
    #: "default" allows TF32 on the card (_MATMUL_PRECISION)
    precision: str = "highest"


@dataclass
class GBLinearModel:
    """Trained model: prediction = base_score + bias + X @ weight."""

    weight: np.ndarray
    bias: float
    base_score: float = 2.0
    #: optional evaluation history {name: [rmse per round]}
    eval_history: dict = field(default_factory=dict)
    best_iteration: int | None = None

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


@dataclass
class MultiTrainResult:
    weights: np.ndarray  # (F, K)
    biases: np.ndarray  # (K,)
    base_score: float
    #: optional {name: [per-round RMSE]} — (K,) arrays per round for K > 1
    eval_history: dict = field(default_factory=dict)


@contextmanager
def _matmul_precision(precision: str):
    """Run the block with ``precision``'s fp32 matmul setting, then restore
    the previous global setting."""
    if precision not in _MATMUL_PRECISION:
        raise ValueError(f"precision must be one of {sorted(_MATMUL_PRECISION)}, got {precision!r}")
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def _dev(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _pad_blocks(Xt: torch.Tensor, block_size: int) -> tuple[torch.Tensor, int]:
    """(F, n) -> (n_blocks, B, n), zero-padding the feature axis (a new
    contiguous tensor on Xt's device; Xt may be a transposed view)."""
    f, n = Xt.shape
    n_blocks = -(-f // block_size)
    out = Xt.new_zeros((n_blocks * block_size, n))
    out[:f] = Xt
    return out.view(n_blocks, block_size, n), n_blocks


def train_gblinear(
    X,
    y,
    params: GBLinearParams | None = None,
    *,
    evals: list[tuple[np.ndarray, np.ndarray, str]] | None = None,
    verbose: bool = False,
    device="cuda",
) -> GBLinearModel:
    """Train on (n, F) features / (n,) labels on ``device`` (default cuda;
    raises with no GPU). Deterministic on a given device.

    ``evals`` mirrors xgboost's watchlist: [(X_eval, y_eval, name), ...]; RMSE
    is recorded per round, and if ``params.early_stopping_rounds`` is set the
    **last** eval set controls early stopping (xgboost semantics). Note the
    reference passes early_stopping_rounds inside the params dict where
    xgboost ignores it (train.py:140-146), so the reference always runs the
    full num_round — replicated by the default of None.

    The eval sets stay on the device (an eval set that is ``X`` itself is
    not uploaded twice); each round fetches one RMSE per set, and early
    stopping keeps its best weights on the device.
    """
    hp = params or GBLinearParams()
    device = resolve_device(device)
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    n, f = X.shape

    with _matmul_precision(hp.precision):
        X_dev = _dev(X, device)
        Xt, n_blocks = _pad_blocks(X_dev.T, hp.block_size)
        # column hessians: float64 sums of squares cast to fp32, as the JAX
        # trainer takes them (there on the host)
        col_hess = torch.stack([Xb.double().square().sum(1) for Xb in Xt]).float()
        evals_dev = []
        for Xe, ye, name in evals or []:
            Xe = np.asarray(Xe, dtype=np.float32)
            evals_dev.append((X_dev if Xe is X else _dev(Xe, device), _dev(ye, device), name))
        del X_dev

        w_blocks = torch.zeros((n_blocks, hp.block_size), dtype=torch.float32, device=device)
        bias = torch.zeros((), dtype=torch.float32, device=device)
        r = _dev(np.full(n, hp.base_score, np.float32) - y, device)
        denom = torch.tensor(float(n), dtype=torch.float32, device=device) + hp.reg_lambda_bias

        history: dict[str, list[float]] = {name: [] for *_unused, name in evals_dev}
        best_round, best_score, stale, best = None, np.inf, 0, None
        for it in range(hp.num_round):
            with record_function("gblinear_round"):
                # bias step (sum_hess = n for squared error)
                db = hp.eta * (-r.sum() / denom)
                bias += db
                r += db
                for Xb, hb, wb in zip(Xt, col_hess, w_blocks):
                    dw = coord_update(Xb @ r, hb, wb, hp.eta, hp.reg_lambda, hp.reg_alpha)
                    r += dw @ Xb
            if not evals_dev:
                continue
            w_now = w_blocks.view(-1)[:f]
            offset = hp.base_score + bias
            rmse = torch.stack([((offset + Xe @ w_now - ye) ** 2).mean().sqrt() for Xe, ye, _ in evals_dev]).tolist()
            for (*_unused, name), value in zip(evals_dev, rmse):
                history[name].append(value)
                if verbose:
                    print(f"[{it}]\t{name}-rmse:{value:.6f}")
            if hp.early_stopping_rounds is not None:
                if rmse[-1] < best_score:
                    best_score, best_round, stale = rmse[-1], it, 0
                    best = (w_now.clone(), bias.clone())
                else:
                    stale += 1
                    if stale >= hp.early_stopping_rounds:
                        break

    w_final, b_final = best if best is not None else (w_blocks.view(-1)[:f], bias)
    return GBLinearModel(
        weight=w_final.cpu().numpy(),
        bias=float(b_final),
        base_score=hp.base_score,
        eval_history=history,
        best_iteration=best_round,
    )


def train_gblinear_multi(
    X,
    Y,
    params: GBLinearParams | None = None,
    *,
    row_weights: np.ndarray | None = None,
    verbose: bool = False,
    device="cuda",
) -> MultiTrainResult:
    """Train K gblinear models sharing one feature matrix in a single
    sweep on ``device`` (default cuda; raises with no GPU).

    Two sweep shapes collapse into this (SURVEY §7 step 9):
    - **multi-tissue** (train_susztak.py's per-column loop): Y is (n, K)
      labels, ``row_weights`` None (all ones) — K tissues per round via one
      matmul;
    - **bootstrap** (scripts/train_bootstrap.sh's 1000 jobs): Y tiles one
      label column; ``row_weights`` (n, K) holds each seed's resample
      multiplicities (np.bincount of the with-replacement draw,
      train_bootstrap.py:88-98). Weighted least squares with integer row
      weights is exactly training on the resampled rows.

    Per-feature stats are products over all models: G = X_blk @ (row_w * r)
    each block step, H = X_blk^2 @ row_w once, in fp32 on the device.
    """
    hp = params or GBLinearParams()
    if hp.early_stopping_rounds is not None:
        warnings.warn(
            "train_gblinear_multi runs all num_round rounds: per-model early "
            "stopping is not supported in the vectorized sweep (use "
            "train_gblinear with evals for early stopping)",
            stacklevel=2,
        )
    device = resolve_device(device)
    X = np.asarray(X, dtype=np.float32)
    Y = np.asarray(Y, dtype=np.float32)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, f = X.shape
    k = Y.shape[1]
    if row_weights is None:
        row_weights = np.ones((n, k), np.float32)
    row_weights = np.asarray(row_weights, dtype=np.float32)

    with _matmul_precision(hp.precision):
        Xt, n_blocks = _pad_blocks(_dev(X, device).T, hp.block_size)
        rw = _dev(row_weights, device)
        denom = _dev(row_weights.sum(axis=0), device) + hp.reg_lambda_bias  # effective row counts
        # per-(feature, model) hessians are loop-invariant: once, block by
        # block to bound the X*X temporary
        hess = torch.stack([(Xb * Xb) @ rw for Xb in Xt])

        w_blocks = torch.zeros((n_blocks, hp.block_size, k), dtype=torch.float32, device=device)
        bias = torch.zeros(k, dtype=torch.float32, device=device)
        r = _dev(np.full((n, k), hp.base_score, np.float32) - Y, device)
        for it in range(hp.num_round):
            with record_function("gblinear_round"):
                # bias step: sum_g / sum_h per model
                db = hp.eta * (-(rw * r).sum(0) / denom)
                bias += db
                r += db
                for Xb, hb, wb in zip(Xt, hess, w_blocks):
                    dw = coord_update(Xb @ (rw * r), hb, wb, hp.eta, hp.reg_lambda, hp.reg_alpha)
                    r += Xb.T @ dw
            if verbose and it % 10 == 0:
                print(f"[{it}] mean|r| = {float(r.abs().mean()):.5f}")

    weights = w_blocks.view(-1, k)[:f].cpu().numpy()
    return MultiTrainResult(weights=weights, biases=bias.cpu().numpy(), base_score=hp.base_score)


def bootstrap_row_weights(n_train: int, seeds: list[int]) -> np.ndarray:
    """(n_train, len(seeds)) resample multiplicities matching the reference's
    ``np.random.RandomState(seed).choice(trainind, size=n, replace=True)``
    draw (train_bootstrap.py:88-98)."""
    out = np.zeros((n_train, len(seeds)), np.float32)
    for j, seed in enumerate(seeds):
        rs = np.random.RandomState(seed)
        idx = rs.choice(np.arange(n_train), size=n_train, replace=True)
        out[:, j] = np.bincount(idx, minlength=n_train)
    return out
