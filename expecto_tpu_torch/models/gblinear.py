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
deterministic block coordinate descent over feature blocks of
``block_size`` (the JAX package's ``lax.scan``), Jacobi within a block
(every feature's gradient from one product ``X_blk @ r``), the residual
advanced once per block by a second product. :func:`train_gblinear` runs a
whole round as one launch of the round kernel (``csrc/gblinear_round.cu``
through ``ops/gblinear_round.py``); the K-model and sharded trainers run a
Python loop over the blocks, a block step on the card being two kernels
(``ops/gblinear_block.py``: the gradient product with the coordinate update
in its epilogue, then the residual product with its add, both in three TF32
passes). Nothing in a round waits for the host.

The row-sharded trainers (:func:`train_gblinear_multi_sharded`,
:func:`train_gblinear_sharded`) run the same sweep in every rank of a
``torch.distributed`` group on that rank's rows, with each row sum the JAX
package takes by ``psum`` taken by one ``all_reduce`` (:func:`_all_reduce`).
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gblinear_block import (BlockScratch, block_layout, block_scratch, grad_update, residual_update,
                                  transposed_rows)
from ..ops.gblinear_cd import coord_update
from ..ops.gblinear_round import feature_stride, gblinear_round, round_scratch
from ..parallel.runner import resolve_device
from ..utils import profiling

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


def _zero_blocks(f: int, n: int, block_size: int, device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A new zero (n_blocks, B, ld) fp32 tensor on ``device``, ld =
    ``feature_stride(n)``: its (n_blocks * B, ld) rows and its (n_blocks, B,
    n) view, and n_blocks."""
    n_blocks = -(-f // block_size)
    out = torch.zeros((n_blocks, block_size, feature_stride(n)), dtype=torch.float32, device=device)
    return out.view(n_blocks * block_size, -1), out[..., :n], n_blocks


def _pad_blocks(Xt: torch.Tensor, block_size: int) -> tuple[torch.Tensor, int]:
    """(F, n) -> (n_blocks, B, n), zero-padding the feature axis: a view of a
    new zero (n_blocks, B, ld) tensor on Xt's device whose feature rows lie
    ld = ``feature_stride(n)`` floats apart (a multiple of 4: the round
    kernel's layout; Xt may be a transposed view)."""
    f, n = Xt.shape
    rows, view, n_blocks = _zero_blocks(f, n, block_size, Xt.device)
    rows[:f, :n] = Xt
    return view, n_blocks


#: rows of the host X a training call uploads at a time into its feature blocks
UPLOAD_ROWS = 4096


def _upload_blocks(X: np.ndarray, block_size: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """:func:`_pad_blocks` of the host (n, F) array's transpose, uploaded
    ``UPLOAD_ROWS`` rows at a time: the card never holds X twice."""
    n, f = X.shape
    rows, view, n_blocks = _zero_blocks(f, n, block_size, device)
    for r0 in range(0, n, UPLOAD_ROWS):
        r1 = min(r0 + UPLOAD_ROWS, n)
        rows[:f, r0:r1] = _dev(X[r0:r1], device).T
    return view, n_blocks


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

    The eval sets stay on the device; each round fetches one RMSE per set,
    and early stopping keeps its best weights on the device. An eval set
    that is the training set itself (``X`` itself, with ``y``'s labels)
    takes its RMSE from the round's residual r, which is the prediction
    minus the label by construction: ``sqrt(mean(r^2))``, the number the
    JAX package computes from a product with X, with no second copy or read
    of X on the card.

    A round is one call of :func:`gblinear_round` (the module global, so a
    test can swap in the plain version); on the card that is one launch of
    the round kernel, whose products are fp32 FFMA whatever
    ``params.precision`` says: that meets "highest" and is at least as exact
    as "default" and "high", which still set the other watchlist sets'
    products.
    """
    hp = params or GBLinearParams()
    device = resolve_device(device)
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    n, f = X.shape

    with _matmul_precision(hp.precision):
        Xt, n_blocks = _upload_blocks(X, hp.block_size, device)
        # column hessians: float64 sums of squares cast to fp32, as the JAX
        # trainer takes them (there on the host)
        col_hess = torch.stack([Xb.double().square().sum(1) for Xb in Xt]).float()
        evals_dev, uploaded = [], {}
        for Xe, ye, name in evals or []:
            Xe, ye = np.asarray(Xe, dtype=np.float32), np.asarray(ye, dtype=np.float32)
            if Xe is X and np.array_equal(ye, y):
                evals_dev.append((None, None, name))  # the training set: its RMSE from r
                continue
            if id(Xe) not in uploaded:
                uploaded[id(Xe)] = _dev(Xe, device)
            evals_dev.append((uploaded[id(Xe)], _dev(ye, device), name))
        del uploaded

        w_blocks = torch.zeros((n_blocks, hp.block_size), dtype=torch.float32, device=device)
        bias = torch.zeros(1, dtype=torch.float32, device=device)
        r = _dev(np.full(n, hp.base_score, np.float32) - y, device)
        denom = float(np.float32(n) + np.float32(hp.reg_lambda_bias))  # sum_hess = n for squared error
        scratch = round_scratch(Xt)

        history: dict[str, list[float]] = {name: [] for *_unused, name in evals_dev}
        best_round, best_score, stale, best = None, np.inf, 0, None
        for it in range(hp.num_round):
            with profiling.span("gblinear_round"):
                gblinear_round(Xt, col_hess, w_blocks, bias, r, scratch, denom, hp.eta, hp.reg_lambda, hp.reg_alpha,
                               update=coord_update)
            if not evals_dev:
                continue
            w_now = w_blocks.view(-1)[:f]
            offset = hp.base_score + bias
            rmse = torch.stack([r.square().mean().sqrt() if Xe is None
                                else ((offset + Xe @ w_now - ye) ** 2).mean().sqrt()
                                for Xe, ye, _ in evals_dev]).tolist()
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
    each block step, H = X_blk^2 @ row_w once, in fp32 on the device. On the
    card each block step is two kernels (:func:`multi_round`), whose
    products run three TF32 passes whatever ``params.precision`` says: that
    meets "highest" and is at least as exact as "high" and "default", which
    still set the hessians' and the watchlist's products.
    """
    hp = params or GBLinearParams()
    if hp.early_stopping_rounds is not None:
        warnings.warn(
            "train_gblinear_multi runs all num_round rounds: per-model early "
            "stopping is not supported in the vectorized sweep (use "
            "train_gblinear with evals for early stopping)",
            stacklevel=2,
        )
    return _multi_sweep(X, Y, row_weights, hp, resolve_device(device), reduce=lambda t: t, verbose=verbose)


@dataclass
class MultiState:
    """The K-model sweep's state on the device. Read by every round:
    ``Xt`` (n_blocks, B, n) the padded feature blocks (``block_layout``: a
    view whose feature rows lie a 32-byte multiple apart), ``rw`` (K, n) row
    weights, ``denom`` (K,) effective row counts plus ``reg_lambda_bias``,
    ``hess`` (n_blocks, B, K) the loop-invariant hessians. Updated in place:
    ``w_blocks`` (n_blocks, B, K), ``bias`` (K,), the residual ``r`` (K, n).
    ``rw`` and ``r`` hold each model's rows as one row (``transposed_rows``:
    the transpose of the JAX package's (n, K)). ``scratch``: the block step
    kernels' (``block_scratch``) on a CUDA device, None on the CPU."""

    Xt: torch.Tensor
    rw: torch.Tensor
    denom: torch.Tensor
    hess: torch.Tensor
    w_blocks: torch.Tensor
    bias: torch.Tensor
    r: torch.Tensor
    scratch: BlockScratch | None = None


def multi_state(X: np.ndarray, Y: np.ndarray, row_weights, hp: GBLinearParams, device: torch.device, *,
                reduce=lambda t: t) -> MultiState:
    """The sweep's state before its first round from float32 ``X`` (n, f)
    and ``Y`` (n, K); ``row_weights`` (n, K), or None for ones. ``reduce`` as
    in :func:`_multi_sweep`."""
    n, k = Y.shape
    if row_weights is None:
        row_weights = np.ones((n, k), np.float32)
    row_weights = np.asarray(row_weights, dtype=np.float32)
    with _matmul_precision(hp.precision):
        with profiling.span("gblinear.upload", device=device, rows=n, bytes_up=X.nbytes):
            Xt = block_layout(_dev(X, device), hp.block_size)
        n_blocks = Xt.shape[0]
        with profiling.span("gblinear.state", device=device, rows=n, bytes_up=row_weights.nbytes + Y.nbytes):
            rw = transposed_rows(_dev(row_weights, device))
            denom = reduce(_dev(row_weights.sum(axis=0), device)) + hp.reg_lambda_bias  # effective row counts
            # per-(feature, model) hessians are loop-invariant: once, block by
            # block to bound the X*X temporary
            hess = reduce(torch.stack([(Xb * Xb) @ rw.T for Xb in Xt]))
            state = MultiState(Xt=Xt, rw=rw, denom=denom, hess=hess,
                               w_blocks=torch.zeros((n_blocks, hp.block_size, k), dtype=torch.float32, device=device),
                               bias=torch.zeros(k, dtype=torch.float32, device=device),
                               r=transposed_rows(_dev(np.full((n, k), hp.base_score, np.float32) - Y, device)),
                               scratch=block_scratch(Xt, k, _ranks()) if device.type == "cuda" else None)
    return state


def _ranks() -> int:
    """Ranks of the default process group (1 without one): the block
    step's route (``ops/gblinear_block.py::block_route``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def multi_round(hp: GBLinearParams, s: MultiState, *, reduce=lambda t: t) -> None:
    """One boosting round of the K-model sweep (the JAX package's
    ``_multi_round_body``) on ``s``, in place: the bias step, then per
    feature block the gradient ``Xb @ (rw * r).T``, one coordinate update of
    the block's (B, K) weights and the residual advanced by ``dw.T @ Xb``.
    ``reduce`` as in :func:`_multi_sweep`. A block step is the module
    globals ``grad_update`` and ``residual_update`` (ops/gblinear_block.py; a
    test may swap in the plain versions): on the card two kernels; on the
    CPU the plain versions, the update being the module global
    ``coord_update``."""
    with _matmul_precision(hp.precision):
        # bias step: sum_g / sum_h per model
        db = hp.eta * (-reduce((s.rw * s.r).sum(1)) / s.denom)
        s.bias += db
        s.r += db[:, None]
        for Xb, hb, wb in zip(s.Xt, s.hess, s.w_blocks):
            dw = grad_update(Xb, s.rw, s.r, hb, wb, hp.eta, hp.reg_lambda, hp.reg_alpha, reduce=reduce,
                             scratch=s.scratch, update=coord_update)
            residual_update(Xb, dw, s.r, scratch=s.scratch)


def _multi_sweep(X, Y, row_weights, hp: GBLinearParams, device: torch.device, *, reduce, evals=None,
                 verbose: bool = False) -> MultiTrainResult:
    """The K-model block sweep of :func:`train_gblinear_multi` and
    :func:`train_gblinear_multi_sharded` over this process's rows.
    ``reduce(t)`` turns a sum over these rows into the sum over all rows, in
    place: the identity in one process, an all-reduce across ranks. With
    ``evals`` ([(X_e, y_e, name), ...], y_e (n_e,) or (n_e, K)) each round
    records one RMSE a set and model, computed on the device."""
    X = np.asarray(X, dtype=np.float32)
    Y = np.asarray(Y, dtype=np.float32)
    if Y.ndim == 1:
        Y = Y[:, None]
    f = X.shape[1]
    k = Y.shape[1]
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    # spans: gblinear.train, the root; inside it gblinear.upload and
    # gblinear.state (multi_state), gblinear.rounds (a gblinear_round a
    # round) and gblinear.fetch
    with profiling.span("gblinear.train", rows=X.shape[0]):
        s = multi_state(X, Y, row_weights, hp, device, reduce=reduce)
        with _matmul_precision(hp.precision):
            evals_dev = []
            for Xe, ye, name in evals or []:
                ye = np.asarray(ye, dtype=np.float32)
                evals_dev.append((_dev(Xe, device), _dev(ye[:, None] if ye.ndim == 1 else ye, device), name))

            history: dict[str, list] = {name: [] for *_unused, name in evals_dev}
            with profiling.span("gblinear.rounds", device=device):
                for it in range(hp.num_round):
                    with profiling.span("gblinear_round"):
                        multi_round(hp, s, reduce=reduce)
                    if evals_dev:
                        w_now = s.w_blocks.view(-1, k)[:f]
                        offset = hp.base_score + s.bias
                        rmse = torch.stack([((offset + Xe @ w_now - ye) ** 2).mean(0).sqrt()
                                            for Xe, ye, _ in evals_dev])
                        for (*_unused, name), value in zip(evals_dev, rmse.cpu().numpy()):
                            history[name].append(float(value[0]) if k == 1 else value)
                            if verbose and rank0:
                                print(f"[{it}]\t{name}-rmse:" + ",".join(f"{v:.6f}" for v in value))
                    elif verbose and rank0 and it % 10 == 0:
                        print(f"[{it}] mean|r| = {float(s.r.abs().mean()):.5f}")

        with profiling.span("gblinear.fetch", bytes_down=4 * (f + 1) * k):
            weights = s.w_blocks.view(-1, k)[:f].cpu().numpy()
            biases = s.bias.cpu().numpy()
    return MultiTrainResult(weights=weights, biases=biases, base_score=hp.base_score, eval_history=history)


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


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` in place over the default process group and return it (one
    process: ``t`` unchanged). Every row sum of the sharded trainers goes
    through this one function, so a test can swap it."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def train_gblinear_multi_sharded(
    X_local,
    Y_local,
    params: GBLinearParams | None = None,
    *,
    row_weights_local: np.ndarray | None = None,
    evals: list[tuple] | None = None,
    verbose: bool = False,
    device="cuda",
) -> MultiTrainResult:
    """Row-sharded K-model training across the ranks of the default process
    group (replaces the reference's per-node shell loops,
    scripts/train_bootstrap.sh:4-7 and train_susztak.py's per-column loop).

    Every rank passes only its contiguous row shard (``host_row_range``
    order) and runs :func:`train_gblinear_multi`'s sweep on ``device``. The
    row sums become sums over all ranks through :func:`_all_reduce`: the
    global row count (once, to reject an empty problem on every rank), the
    effective row counts and the (F, K) hessians (once, before round 0), and
    per round the bias gradient and each block's (B, K) gradient, before the
    coordinate update. So a run makes ``3 + num_round * (1 + n_blocks)``
    all-reduce calls, and the updates, computed from the same sums on every
    rank, keep the weights replicated; on the card a block step is then the
    gradient kernel writing G, the all-reduce, the coordinate-update
    kernel's planes entry and the residual kernel on each rank
    (``ops/gblinear_block.py``'s split route). Rows are not padded: the sums
    need no static shape. One process: the sums are local, the block step
    takes the fused route, and the result equals
    :func:`train_gblinear_multi`'s bit for bit.

    ``evals``: xgboost-style watchlist [(X_eval, y_eval, name), ...], the
    same sets on every rank; ``y_eval`` may be (n_e,) or (n_e, K). The sets
    stay on the device, every rank computes the same RMSE from its
    replicated weights (one fetch a round), and only rank 0 prints it.
    Records ``eval_history`` ({name: per-round RMSE}, (K,) arrays for K >
    1). All ``num_round`` rounds run.
    """
    hp = params or GBLinearParams()
    device = resolve_device(device)
    n_global = int(_all_reduce(torch.tensor([len(X_local)], dtype=torch.int64, device=device)).item())
    if n_global == 0:
        raise ValueError("train_gblinear_multi_sharded: no training rows on any rank")
    return _multi_sweep(X_local, Y_local, row_weights_local, hp, device, reduce=lambda t: _all_reduce(t),
                        evals=evals, verbose=verbose)


def train_gblinear_sharded(
    X_local,
    y_local,
    params: GBLinearParams | None = None,
    *,
    evals: list[tuple] | None = None,
    verbose: bool = False,
    device="cuda",
) -> GBLinearModel:
    """Single-model row-sharded trainer, the K = 1 view of
    :func:`train_gblinear_multi_sharded`; runs all ``num_round`` rounds (the
    reference's behaviour: it passes early_stopping_rounds where xgboost
    ignores it, train.py:140-146). ``evals`` must be the same on every rank;
    the watchlist matches :func:`train_gblinear`'s."""
    hp = params or GBLinearParams()
    multi = train_gblinear_multi_sharded(
        X_local, np.asarray(y_local, np.float32)[:, None], hp, evals=evals, verbose=verbose, device=device
    )
    return GBLinearModel(
        weight=multi.weights[:, 0].astype(np.float32),
        bias=float(multi.biases[0]),
        base_score=hp.base_score,
        eval_history=multi.eval_history,
    )
