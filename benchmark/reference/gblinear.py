"""gblinear training in plain PyTorch: xgboost 0.7's linear booster on a
squared-error objective (ExPecto train.py: eta 0.01, lambda 100, alpha 0,
base_score 2, 100 rounds), K models over one feature matrix.

Each round: the bias step db = -eta * sum(g) / (n + lambda_bias), then the
features in blocks of ``block_size``, each block's weights all updated from
one gradient (Jacobi within a block, blocks in order, the residual advanced
after each block: the trainer's stated schedule), by xgboost's
CoordinateDelta:

    g' = g + lambda w,  h' = h + lambda
    delta = max(-(g' + alpha) / h', -w) if w - g' / h' >= 0
            else min(-(g' - alpha) / h', -w);  0 where h < 1e-5
    w += eta * delta

with g the gradient sum X_b^T r and h the hessian sum of X_b^2 over the
rows, r the residual prediction - label. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from .beluga import precision_mode, rounding


def coord_delta(g, h, w, lam: float, alpha: float):
    gl = g + lam * w
    hl = h + lam
    pos = torch.maximum(-(gl + alpha) / hl, -w)
    neg = torch.minimum(-(gl - alpha) / hl, -w)
    return torch.where(h < 1e-5, torch.zeros_like(w), torch.where(w - gl / hl >= 0, pos, neg))


def train(X: torch.Tensor, Y: torch.Tensor, *, eta: float, reg_lambda: float, reg_alpha: float,
          reg_lambda_bias: float, base_score: float, num_round: int, block_size: int,
          precision: str = "fp32") -> tuple[torch.Tensor, torch.Tensor]:
    """(weights (F, K), biases (K,)) after ``num_round`` rounds on X (n, F)
    and Y (n, K), float32 on their device; ``precision`` "fp32" or "tf32"
    (the two products' operands rounded to TF32: the control)."""
    n, f = X.shape
    k = Y.shape[1]
    q = rounding(precision)
    with precision_mode():
        w = torch.zeros((f, k), dtype=torch.float32, device=X.device)
        bias = torch.zeros(k, dtype=torch.float32, device=X.device)
        r = torch.full_like(Y, base_score) - Y  # (n, K)
        # every row weighs 1, so each model's hessian sums are the same
        hess = torch.cat([(X[:, f0 : f0 + block_size] ** 2).sum(0) for f0 in range(0, f, block_size)])
        hess = hess[:, None].expand(f, k)
        for _ in range(num_round):
            db = eta * (-r.sum(0) / (n + reg_lambda_bias))
            bias += db
            r += db
            for f0 in range(0, f, block_size):
                f1 = min(f0 + block_size, f)
                Xb = q(X[:, f0:f1])
                g = Xb.T @ q(r)
                dw = eta * coord_delta(g, hess[f0:f1], w[f0:f1], reg_lambda, reg_alpha)
                w[f0:f1] += dw
                r += Xb @ q(dw)
    return w, bias
