"""The round kernel's layout, plan and summation order on the CPU
(``csrc/gblinear_round.cu`` through ``ops/gblinear_round.py``), and the
training set's RMSE taken from the round's residual
(``models/gblinear.py::train_gblinear``), fp32, against the JAX package.

- ``_pad_blocks``' strided layout (feature rows a multiple of 4 floats
  apart, the padding zero, no second copy of X) and the plain round on that
  view against JAX's ``one_round``;
- a numpy emulation of the kernel's summation order (its 16-byte row
  slices, tiles, stages, the stages kept in shared memory and the rows read
  back from global memory in (C), every partial in its order) on fixed
  plans against the plain round and float64, within chip_smoke.py's
  TRAIN_ROUND_LIMITS, with the stale-residual fault beyond them;
- ``train_gblinear`` with the training set's RMSE from r against the JAX
  trainer (histories, weights and ``best_iteration`` within 1e-5), and the
  training set's X uploaded once.

The CUDA kernel itself and its plan are held to the plain round and to
the plan's invariants on the card (tests/test_torch_card.py,
chip_smoke.py)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from expecto_tpu.models import gblinear as jgb
from expecto_tpu_torch.models import gblinear as tgb
from expecto_tpu_torch.ops import gblinear_round as gr
from expecto_tpu_torch.ops.gblinear_cd import coord_update_plain
from torch_port_common import single_torch_thread, stale_residual_round  # noqa: F401 (autouse fixture)

TOL = 1e-5
#: chip_smoke.py's TRAIN_ROUND_LIMITS: weights over max|w|, the bias, the RMSE of r
LIMITS = {"w_over_max_w": 1e-5, "bias": 1e-6, "rmse": 1e-5}
#: consumer warps of a CTA in csrc/gblinear_round.cu, and their threads
CONSUMER_WARPS = 16
CONSUMERS = 32 * CONSUMER_WARPS
F32 = np.float32


def _state(n: int, f: int, b: int, seed: int):
    """A standard-normal (n, f) X in the kernel's layout (``_pad_blocks``),
    its column hessians, and a state part way through training: nonzero
    weights (zero on the padded features), bias and residual."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(F32)
    Xt, n_blocks = tgb._pad_blocks(torch.from_numpy(X).T, b)
    hess = torch.stack([Xb.double().square().sum(1) for Xb in Xt]).float()
    w = torch.from_numpy((rng.normal(size=(n_blocks, b)) * 0.05).astype(F32))
    w.view(-1)[f:] = 0.0
    return Xt, hess, w, torch.tensor([rng.normal() * 0.1], dtype=torch.float32), torch.from_numpy(
        rng.normal(size=n).astype(F32))


# ---- the layout ------------------------------------------------------------------

@pytest.mark.parametrize("b", [16, 64])
@pytest.mark.parametrize("n", [400, 401, 402, 403])
def test_pad_blocks_rows_a_multiple_of_4_floats_apart_padding_zero(n, b):
    X = np.random.default_rng(n).normal(size=(n, 100)).astype(F32)
    Xt, n_blocks = tgb._pad_blocks(torch.from_numpy(X).T, b)
    ld = gr.feature_stride(n)
    assert ld % 4 == 0 and 0 <= ld - n < 4 and n_blocks == -(-100 // b)
    assert Xt.shape == (n_blocks, b, n) and Xt.stride() == (b * ld, ld, 1)
    assert Xt.untyped_storage().nbytes() == 4 * n_blocks * b * ld  # the view: no second copy
    whole = Xt.as_strided((n_blocks * b, ld), (ld, 1))
    np.testing.assert_array_equal(whole[:100, :n].numpy(), X.T)
    assert (whole[100:] == 0).all() and (whole[:, n:] == 0).all()
    want, _ = jgb._pad_blocks(np.ascontiguousarray(X.T), b)
    np.testing.assert_array_equal(Xt.numpy(), want)


def _jax_round(Xt, hess, w, bias, r, hp):
    one_round = jax.jit(jgb._round_body(jgb.GBLinearParams(**hp.__dict__)))
    w_j, b_j, r_j = one_round(jnp.asarray(w.numpy()), jnp.float32(float(bias[0])), jnp.asarray(r.numpy()),
                              jnp.asarray(np.ascontiguousarray(Xt.numpy())), jnp.asarray(hess.numpy()),
                              jnp.float32(Xt.shape[2]))
    return np.asarray(w_j), float(b_j), np.asarray(r_j)


@pytest.mark.parametrize("b", [16, 512])
@pytest.mark.parametrize("n", [401, 403])
def test_plain_round_on_the_strided_view_matches_jax_one_round(n, b):
    Xt, hess, w, bias, r = _state(n, 1100, b, seed=n + b)
    hp = tgb.GBLinearParams(eta=0.3, reg_lambda=5.0, reg_alpha=1.0, reg_lambda_bias=3.0, block_size=b)
    want = _jax_round(Xt, hess, w, bias, r, hp)
    assert not Xt.is_contiguous()
    gr.gblinear_round(Xt, hess, w, bias, r, None, float(F32(n) + F32(3.0)), hp.eta, hp.reg_lambda, hp.reg_alpha)
    np.testing.assert_allclose(w.numpy(), want[0], rtol=0, atol=TOL)
    assert abs(float(bias[0]) - want[1]) < TOL
    np.testing.assert_allclose(r.numpy(), want[2], rtol=0, atol=TOL)


@pytest.mark.parametrize("rows", [1, 7, 4096])
def test_upload_in_row_chunks_equals_pad_blocks(monkeypatch, rows):
    X = np.random.default_rng(rows).normal(size=(301, 70)).astype(F32)
    monkeypatch.setattr(tgb, "UPLOAD_ROWS", rows)
    got, nb = tgb._upload_blocks(X, 16, torch.device("cpu"))
    want, nb_want = tgb._pad_blocks(torch.from_numpy(X).T, 16)
    assert nb == nb_want and got.stride() == want.stride() and torch.equal(got, want)
    assert (got.as_strided((nb * 16, gr.feature_stride(301)), (gr.feature_stride(301), 1))[:, 301:] == 0).all()


def test_wrapper_rejects_rows_not_a_multiple_of_4_floats_apart():
    Xt, hess, w, bias, r = _state(401, 100, 32, seed=3)
    dense = Xt.contiguous()  # 401 floats apart
    with pytest.raises(ValueError, match="multiple of 4 floats apart"):
        gr.gblinear_round(dense, hess, w, bias, r, None, 401.0, 0.3, 5.0, 0.0)
    with pytest.raises(ValueError, match="multiple of 4 floats apart"):
        gr.gblinear_round(Xt.transpose(1, 2).contiguous().transpose(1, 2), hess, w, bias, r, None, 401.0, 0.3, 5.0,
                          0.0)


# ---- the kernel's summation order, emulated -------------------------------------

def _fma(a, b, c):
    """fp32 fma through float64 (the fp32 product is exact there)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def _warp_sum(v):
    """The kernel's shuffle sum over the last axis (32 lanes): xor 16, 8,
    4, 2, 1."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _strided_sums(x, threads):
    """Thread t's sum of x[t], x[t + threads], ... along axis 0, in order
    from 0.0 (shape (threads, ...))."""
    m = -(-x.shape[0] // threads)
    pad = np.zeros((m * threads,) + x.shape[1:], F32)
    pad[:x.shape[0]] = x
    acc = np.zeros((threads,) + x.shape[1:], F32)
    for k in range(m):
        acc = acc + pad[k * threads:(k + 1) * threads]
    return acc


def emulate_round(Xt, hess, w, bias, r, denom, eta, lam, alpha, g, *, stale=False):
    """csrc/gblinear_round.cu's round in numpy fp32, every sum in the
    kernel's order, on plan ``g`` (a :class:`Plan`); ``stale`` leaves r
    unadvanced after the first block (the planted fault). Returns (w, bias,
    r) as numpy."""
    n_blocks, B, n = Xt.shape
    ld = Xt.stride(1)
    X = Xt.as_strided((n_blocks * B, ld), (ld, 1)).numpy()
    w, r, bias = w.numpy().copy(), r.numpy().copy(), F32(bias.numpy()[0])
    G, T, FS, NG, groups = g.ctas, g.tile, g.stage_rows, g.stages, g.groups
    cache = min(g.cache, NG)
    lo, hi = gr.row_plan(n, G)
    tiles = [-(-(z - a) // T) for a, z in zip(lo, hi)]

    # bias step: each CTA's thread sums, warp sums and warp 0's sum; then the
    # CTAs' sums, lane-strided, and db
    parts = np.array([_warp_sum(np.concatenate([_warp_sum(_strided_sums(r[a:z], CONSUMERS).reshape(-1, 32)),
                                                np.zeros(32 - CONSUMER_WARPS, F32)]))
                      for a, z in zip(lo, hi)], F32)
    s = _warp_sum(_strided_sums(parts, 32))
    db = F32(eta) * (F32(-s) / F32(denom))
    bias = bias + db
    r = r + db

    for b in range(n_blocks):
        Xb = X[b * B:(b + 1) * B]
        part = np.zeros((G, B), F32)
        for c in range(G):  # (A)
            for t in range(tiles[c]):
                c0 = lo[c] + t * T
                cols = min(T, hi[c] - c0)
                q_n = -(-cols // 4)
                xt = Xb[:, c0:c0 + 4 * q_n]
                rt = np.zeros(4 * q_n, F32)
                rt[:cols] = r[c0:c0 + cols]
                acc = np.zeros((B, 32), F32)
                for k in range(-(-q_n // 32)):
                    q = np.arange(32) + 32 * k
                    ok = q < q_n
                    for comp in range(4):
                        col = np.minimum(4 * q + comp, 4 * q_n - 1)
                        acc = np.where(ok, _fma(xt[:, col], rt[col], acc), acc)
                s = _warp_sum(acc)
                part[c] = s if t == 0 else part[c] + s
        # (B) the CTAs' partials summed lane-strided, then the coordinate step
        grad = _warp_sum(np.moveaxis(_strided_sums(part, 32), 0, -1))
        wb = torch.from_numpy(w[b])
        dw = coord_update_plain(torch.from_numpy(grad), hess[b], wb, eta, lam, alpha).numpy()
        w[b] = wb.numpy()
        if stale and b == 0:
            continue
        for c in range(G):  # (C): the tiles last read first, the cached stages first, then the rest, last read first
            for t in range(tiles[c] - 1, -1, -1):
                c0 = lo[c] + t * T
                cols = min(T, hi[c] - c0)
                red = np.zeros((groups, cols), F32)
                for grp in range(groups):
                    feats = []
                    j_lo = 0
                    if t == tiles[c] - 1:
                        for st in range(cache):
                            feats += [j for j in range(st * FS, min(B, st * FS + FS)) if j % groups == grp]
                        j_lo = min(cache * FS, B)
                    feats += [j for j in range(B - 1, j_lo - 1, -1) if j % groups == grp]
                    acc = np.zeros(cols, F32)
                    for j in feats:
                        acc = _fma(dw[j], Xb[j, c0:c0 + cols], acc)
                    red[grp] = acc
                tot = red[0]
                for grp in range(1, groups):
                    tot = tot + red[grp]
                r[c0:c0 + cols] = r[c0:c0 + cols] + tot
    return w, float(bias), r


def _gaps(got, want) -> dict:
    return {"w_over_max_w": float(np.abs(got[0] - want[0]).max() / np.abs(want[0]).max()),
            "bias": abs(got[1] - want[1]),
            "rmse": abs(float(np.sqrt(np.mean(np.square(got[2], dtype=np.float64))))
                        - float(np.sqrt(np.mean(np.square(want[2], dtype=np.float64)))))}


def _reference(state, args, dtype):
    Xt, hess, w, bias, r = (t.to(dtype).clone() for t in state)
    gr.gblinear_round_plain(Xt, hess, w, bias, r, None, *args)
    return w.numpy(), float(bias[0]), r.numpy()


class Plan(NamedTuple):
    """The fields of the kernel's plan (``ops/gblinear_round.RoundGeometry``)
    that set its summation order."""

    ctas: int
    tile: int
    stage_rows: int
    stages: int
    cache: int
    groups: int


# (n, B, the plan, a CTA's most tiles, what it exercises): plans the
# kernel's ``plan`` makes for these shapes on a card of 8, 3, 5 and 1 SMs
# (the second at 120,000 bytes of shared memory a CTA, the others at an
# H100's 232,448)
EMULATED = [
    (1000, 512, Plan(8, 128, 16, 32, 22, 8), 1, "one tile, 22 of 32 stages cached"),
    (1000, 512, Plan(3, 168, 16, 32, 6, 8), 2, "two tiles, 6 stages of the last cached"),
    (997, 16, Plan(5, 200, 16, 1, 1, 8), 1, "one stage a block, cached; a ragged last slice"),
    (8_300, 512, Plan(1, 252, 16, 32, 5, 8), 33, "33 tiles, 5 stages of the last cached"),
]


@pytest.mark.parametrize("n,b,g,tiles,what", EMULATED, ids=[e[4] for e in EMULATED])
def test_emulated_kernel_order_within_the_round_limits_and_the_stale_fault_beyond(n, b, g, tiles, what):
    lo, hi = gr.row_plan(n, g.ctas)
    assert -(-int((hi - lo).max()) // g.tile) == tiles and g.tile % 4 == 0
    assert g.stage_rows * g.stages >= b and 0 < g.cache <= g.stages
    state = _state(n, 1100, b, seed=n + b)
    args = (float(F32(n) + F32(2.0)), 0.3, 5.0, 1.0)
    got = emulate_round(*state, *args, g)
    stale = emulate_round(*state, *args, g, stale=True)
    for want in (_reference(state, args, torch.float32), _reference(state, args, torch.float64)):
        gaps = _gaps(got, want)
        assert all(gaps[k] <= v for k, v in LIMITS.items()), gaps
        stale_gaps = _gaps(stale, want)
        assert stale_gaps["w_over_max_w"] > LIMITS["w_over_max_w"] and stale_gaps["rmse"] > LIMITS["rmse"], stale_gaps
    plain = _reference(state, args, torch.float32)
    assert np.abs(got[2] - plain[2]).max() < 1e-4  # r itself close, element by element


def test_stale_plain_round_misses_the_emulated_kernel():
    """The stale-residual plain round (tests/torch_port_common.py) against
    the emulated kernel: beyond the limits, as on the card."""
    n, b, g, _tiles, _what = EMULATED[0]
    state = _state(n, 1100, b, seed=4)
    args = (float(F32(n)), 0.3, 5.0, 0.0)
    got = emulate_round(*state, *args, g)
    Xt, hess, w, bias, r = (t.clone() for t in state)
    stale_residual_round(Xt, hess, w, bias, r, None, *args)
    gaps = _gaps((w.numpy(), float(bias[0]), r.numpy()), got)
    assert gaps["w_over_max_w"] > LIMITS["w_over_max_w"] and gaps["rmse"] > LIMITS["rmse"]


# ---- the training set's RMSE from r ----------------------------------------------

@pytest.fixture(scope="module")
def small_problem():
    """90 training rows of 300 features (five informative), 40 held out:
    eta 0.5 and lambda 0.5 overfit, so early stopping fires."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(130, 300)).astype(F32)
    y = (2.0 + X[:, :5] @ rng.normal(size=5) + rng.normal(size=130)).astype(F32)
    return X[:90], y[:90], X[90:], y[90:]


@pytest.mark.parametrize("early", [None, 3], ids=["all_rounds", "early_stopping"])
@pytest.mark.parametrize("last", ["train", "eval"])
def test_train_rmse_from_r_matches_jax(small_problem, last, early):
    X, y, Xe, ye = small_problem
    evals = [(Xe, ye, "eval"), (X, y, "train")]
    if last == "eval":
        evals = evals[::-1]
    params = dict(num_round=30, eta=0.5, reg_lambda=0.5, block_size=64, early_stopping_rounds=early)
    got = tgb.train_gblinear(X, y, tgb.GBLinearParams(**params), evals=evals, device="cpu")
    want = jgb.train_gblinear(X, y, jgb.GBLinearParams(**params), evals=evals)
    assert got.best_iteration == want.best_iteration
    if early is not None:
        assert len(want.eval_history["train"]) < 30  # it fired
    for name in ("eval", "train"):
        assert len(got.eval_history[name]) == len(want.eval_history[name])
        np.testing.assert_allclose(got.eval_history[name], want.eval_history[name], rtol=0, atol=TOL)
    np.testing.assert_allclose(got.weight, want.weight, rtol=0, atol=TOL)
    assert abs(got.bias - want.bias) < TOL


def test_train_rmse_from_r_equals_the_product_form(small_problem):
    """The r form against the same call with the training set passed as a
    copy (the product with X): within 1e-5 a round, over 30 rounds."""
    X, y, Xe, ye = small_problem
    hp = tgb.GBLinearParams(num_round=30, eta=0.5, reg_lambda=0.5, block_size=64)
    from_r = tgb.train_gblinear(X, y, hp, evals=[(Xe, ye, "eval"), (X, y, "train")], device="cpu")
    product = tgb.train_gblinear(X, y, hp, evals=[(Xe, ye, "eval"), (X.copy(), y, "train")], device="cpu")
    np.testing.assert_array_equal(from_r.weight, product.weight)
    np.testing.assert_allclose(from_r.eval_history["train"], product.eval_history["train"], rtol=0, atol=TOL)
    assert from_r.eval_history["eval"] == product.eval_history["eval"]


def _uploads(monkeypatch):
    """Record the host arrays ``models/gblinear._dev`` copies to the device."""
    seen = []
    dev = tgb._dev

    def recording(a, device):
        seen.append(a)
        return dev(a, device)

    monkeypatch.setattr(tgb, "_dev", recording)
    return seen


@pytest.mark.parametrize("train_set", ["X itself", "a copy of X", "X with other labels"])
def test_training_set_x_is_uploaded_once(small_problem, monkeypatch, train_set):
    X, y, Xe, ye = small_problem
    monkeypatch.setattr(tgb, "UPLOAD_ROWS", 32)
    seen = _uploads(monkeypatch)
    Xs, ys = {"X itself": (X, y), "a copy of X": (X.copy(), y), "X with other labels": (X, y + 1)}[train_set]
    tgb.train_gblinear(X, y, tgb.GBLinearParams(num_round=2, block_size=64), evals=[(Xe, ye, "eval"), (Xs, ys, "train")],
                       device="cpu")
    rows_of_x = sum(a.shape[0] for a in seen if a.ndim == 2 and a.shape[1] == X.shape[1] and
                    (np.shares_memory(a, X) or a is Xs))
    assert rows_of_x == (90 if train_set == "X itself" else 180)  # once in row chunks (+ once for the product)
