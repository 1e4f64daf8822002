"""The port's gblinear trainers vs the JAX package, fp32 on the CPU: the
coordinate update's plain version against ``_coord_delta`` (the CUDA kernel
``csrc/gblinear_cd.cu`` is held to the plain version bit for bit on the
card, tests/test_torch_card.py), ``train_gblinear`` (block sizes, L1, the
watchlist and early stopping), ``train_gblinear_multi`` (multi-target and
bootstrap row weights), ``bootstrap_row_weights``, the xgboost-0.7 codecs
(bytes equal to the JAX package's), and the numpy R².

Tolerances: the coordinate update within rtol 1e-6 (the same fp32 ops; XLA
may evaluate the division differently); trained weights, biases and the
per-round RMSE within 1e-5, as tests/test_gblinear.py holds the JAX
trainers to each other (products summed in another order each round)."""

import warnings

import numpy as np
import pytest
import torch
from sklearn.metrics import r2_score as sk_r2_score

import jax.numpy as jnp
from expecto_tpu.io import xgb as jxgb
from expecto_tpu.models import gblinear as jgb
from expecto_tpu_torch.io import xgb as txgb
from expecto_tpu_torch.models import gblinear as tgb
from expecto_tpu_torch.ops.gblinear_cd import coord_update, coord_update_plain
from expecto_tpu_torch.utils.plotting import r2_score
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
GOLDEN = "tests/golden/gblinear_xgb07.save"


@pytest.fixture(scope="module")
def ridge_problem():
    """tests/test_gblinear.py's problem: n 400, f 60, y = 2 + X w + noise."""
    rng = np.random.default_rng(42)
    n, f = 400, 60
    X = rng.normal(size=(n, f)).astype(np.float32)
    w_true = rng.normal(size=f) * 0.5
    y = (2.0 + X @ w_true + rng.normal(size=n) * 0.1).astype(np.float32)
    return X, y


def both_params(**kw):
    return jgb.GBLinearParams(**kw), tgb.GBLinearParams(**kw)


def coord_grid():
    """(g, h, w) covering the update's branches: hessians below, at and above
    the 1e-5 guard (h = 0 is a padded feature row), both signs of g and w,
    and ties tmp == 0 (w = g = 0, and w equal to gl2 / hl2)."""
    rng = np.random.default_rng(3)
    h = np.array([0.0, 5e-6, 9.99e-6, 1e-5, 1.01e-5, 1e-3, 0.5, 1.0, 37.0, 2e3], np.float32)
    g = np.array([-50.0, -3.0, -0.25, 0.0, 0.25, 3.0, 50.0], np.float32)
    w = np.array([-0.4, -0.01, 0.0, 0.01, 0.4], np.float32)
    G, H, W = (a.ravel() for a in np.meshgrid(g, h, w, indexing="ij"))
    G = np.concatenate([G, rng.normal(size=200).astype(np.float32) * 10])
    H = np.concatenate([H, rng.random(200).astype(np.float32) * 20])
    W = np.concatenate([W, rng.normal(size=200).astype(np.float32)])
    return G, H, W


@pytest.mark.parametrize("lam,alpha", [(100.0, 0.0), (1.0, 0.0), (0.0, 0.0), (100.0, 2.5), (1.0, 40.0)])
def test_coord_update_plain_matches_jax_coord_delta(lam, alpha):
    G, H, W = coord_grid()
    # a tie: w = (g + lam w) / (h + lam) holds for g = w h
    G[:5], H[:5], W[:5] = 0.0, 1.0, 0.0
    eta = 0.01
    want = np.asarray(eta * jgb._coord_delta(jnp.asarray(G), jnp.asarray(H), jnp.asarray(W), lam, alpha))
    w = torch.from_numpy(W.copy())
    dw = coord_update_plain(torch.from_numpy(G), torch.from_numpy(H), w, eta, lam, alpha)
    np.testing.assert_allclose(dw.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(w.numpy(), W + dw.numpy())
    assert (dw.numpy()[H < np.float32(1e-5)] == 0).all()


def test_coord_update_wrapper_on_cpu_is_the_plain_version_and_checks_inputs():
    G, H, W = (torch.from_numpy(a) for a in coord_grid())
    w1, w2 = W.clone(), W.clone()
    before = coord_update.launches
    torch.testing.assert_close(coord_update(G, H, w1, 0.01, 100.0, 0.5), coord_update_plain(G, H, w2, 0.01, 100.0, 0.5),
                               rtol=0, atol=0)
    torch.testing.assert_close(w1, w2, rtol=0, atol=0)
    assert coord_update.launches == before  # CPU calls do not count
    with pytest.raises(TypeError, match="fp32"):
        coord_update(G.double(), H, W, 0.01, 100.0, 0.0)
    with pytest.raises(ValueError, match="one shape"):
        coord_update(G[:-1], H, W, 0.01, 100.0, 0.0)


def test_pad_blocks_matches_jax(ridge_problem):
    X, _ = ridge_problem
    for bs in (16, 60, 64):
        want, nb = jgb._pad_blocks(np.ascontiguousarray(X.T), bs)
        got, nb_t = tgb._pad_blocks(torch.from_numpy(X).T, bs)
        assert nb_t == nb and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


def _assert_model_close(got, want):
    np.testing.assert_allclose(got.weight, want.weight, atol=TOL, rtol=0)
    assert abs(got.bias - want.bias) < TOL
    assert got.base_score == want.base_score and got.weight.dtype == np.float32


@pytest.mark.parametrize("block_size", [8, 16, 64])
def test_train_gblinear_matches_jax(ridge_problem, block_size):
    X, y = ridge_problem
    jp, tp = both_params(eta=0.3, reg_lambda=5.0, num_round=100, block_size=block_size)
    got = tgb.train_gblinear(X, y, tp, device="cpu")
    _assert_model_close(got, jgb.train_gblinear(X, y, jp))
    assert got.eval_history == {} and got.best_iteration is None


def test_train_gblinear_l1_matches_jax(ridge_problem):
    X, y = ridge_problem
    jp, tp = both_params(eta=0.5, reg_alpha=50.0, reg_lambda=1.0, num_round=300)
    got = tgb.train_gblinear(X, y, tp, device="cpu")
    want = jgb.train_gblinear(X, y, jp)
    _assert_model_close(got, want)
    assert np.sum(got.weight == 0) > 0  # L1 zeroes some features exactly


def test_train_gblinear_default_params_match_jax(ridge_problem):
    """The reference's hyperparameters (eta .01, lambda 100, 100 rounds,
    block 512 > F: one padded block)."""
    X, y = ridge_problem
    _assert_model_close(tgb.train_gblinear(X, y, device="cpu"), jgb.train_gblinear(X, y))


def test_watchlist_and_early_stopping_match_jax(ridge_problem, capsys):
    X, y = ridge_problem
    evals = [(X[300:], y[300:], "eval"), (X[:300], y[:300], "train")]
    for kw in ({"eta": 0.5, "num_round": 50, "early_stopping_rounds": 5}, {"eta": 0.3, "num_round": 12}):
        jp, tp = both_params(**kw)
        want = jgb.train_gblinear(X[:300], y[:300], jp, evals=evals, verbose=True)
        jax_lines = capsys.readouterr().out.splitlines()
        got = tgb.train_gblinear(X[:300], y[:300], tp, evals=evals, verbose=True, device="cpu")
        lines = capsys.readouterr().out.splitlines()
        _assert_model_close(got, want)
        assert got.best_iteration == want.best_iteration
        assert set(got.eval_history) == {"eval", "train"}
        for name in ("eval", "train"):
            assert len(got.eval_history[name]) == len(want.eval_history[name])
            np.testing.assert_allclose(got.eval_history[name], want.eval_history[name], atol=TOL, rtol=0)
        assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jax_lines]
        np.testing.assert_allclose([float(ln.split(":")[1]) for ln in lines],
                                   [float(ln.split(":")[1]) for ln in jax_lines], atol=TOL, rtol=0)
    assert want.best_iteration is None and len(got.eval_history["eval"]) == 12


def test_early_stopping_stops_and_keeps_the_best_round(ridge_problem):
    """A watchlist whose RMSE rises after a few rounds (labels that the
    features do not explain, eta 1): the port stops where JAX stops and
    returns the best round's weights, not the last round's."""
    X, y = ridge_problem
    rng = np.random.default_rng(5)
    y_noise = rng.normal(size=y.shape).astype(np.float32)
    evals = [(X[300:], y_noise[300:], "eval")]
    jp, tp = both_params(eta=1.0, reg_lambda=1.0, num_round=60, early_stopping_rounds=3)
    want = jgb.train_gblinear(X[:300], y_noise[:300], jp, evals=evals)
    got = tgb.train_gblinear(X[:300], y_noise[:300], tp, evals=evals, device="cpu")
    assert got.best_iteration == want.best_iteration
    assert len(got.eval_history["eval"]) == len(want.eval_history["eval"]) < 60
    _assert_model_close(got, want)
    hp_last = tgb.GBLinearParams(eta=1.0, reg_lambda=1.0, num_round=len(got.eval_history["eval"]))
    last = tgb.train_gblinear(X[:300], y_noise[:300], hp_last, device="cpu")
    assert np.abs(last.weight - got.weight).max() > 100 * TOL


def test_multi_target_matches_jax(ridge_problem):
    X, y = ridge_problem
    Y = np.stack([y, y * 2 + 1, np.random.default_rng(0).normal(size=y.shape[0])], axis=1)
    jp, tp = both_params(eta=0.3, reg_lambda=5.0, num_round=60, block_size=16)
    got = tgb.train_gblinear_multi(X, Y, tp, device="cpu")
    want = jgb.train_gblinear_multi(X, Y, jp)
    assert got.weights.shape == (X.shape[1], 3) and got.biases.shape == (3,)
    np.testing.assert_allclose(got.weights, want.weights, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.biases, want.biases, atol=TOL, rtol=0)
    assert got.base_score == want.base_score and got.eval_history == {}


def test_bootstrap_row_weights_match_jax(ridge_problem):
    X, y = ridge_problem
    seeds = [0, 7, 123]
    W = tgb.bootstrap_row_weights(X.shape[0], seeds)
    np.testing.assert_array_equal(W, jgb.bootstrap_row_weights(X.shape[0], seeds))
    assert W.dtype == np.float32 and (W.sum(axis=0) == X.shape[0]).all()
    jp, tp = both_params(eta=0.3, reg_lambda=5.0, num_round=40, block_size=32)
    got = tgb.train_gblinear_multi(X, np.stack([y] * 3, axis=1), tp, row_weights=W, device="cpu")
    want = jgb.train_gblinear_multi(X, np.stack([y] * 3, axis=1), jp, row_weights=W)
    np.testing.assert_allclose(got.weights, want.weights, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.biases, want.biases, atol=TOL, rtol=0)


def test_multi_warns_on_early_stopping_and_1d_labels(ridge_problem):
    X, y = ridge_problem
    with pytest.warns(UserWarning, match="per-model early"):
        res = tgb.train_gblinear_multi(X, y, tgb.GBLinearParams(num_round=2, early_stopping_rounds=1), device="cpu")
    assert res.weights.shape == (X.shape[1], 1)


def test_precision_setting_is_scoped_to_the_trainer(ridge_problem, monkeypatch):
    """"default" runs the products with TF32 allowed ("high") and puts the
    previous global setting back; an unknown precision raises."""
    X, y = ridge_problem
    seen = []

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        return coord_update_plain(*args)

    monkeypatch.setattr(tgb, "coord_update", spy)
    previous = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        tgb.train_gblinear(X, y, tgb.GBLinearParams(num_round=1, precision="default"), device="cpu")
        assert seen and set(seen) == {"high"}
        assert torch.get_float32_matmul_precision() == "highest"
        tgb.train_gblinear_multi(X, y, tgb.GBLinearParams(num_round=1), device="cpu")
        assert seen[-1] == "highest"
        with pytest.raises(ValueError, match="precision"):
            tgb.train_gblinear(X, y, tgb.GBLinearParams(num_round=1, precision="fp8"), device="cpu")
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(previous)


def test_trainers_need_a_gpu_by_default(ridge_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    X, y = ridge_problem
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tgb.train_gblinear(X, y)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tgb.train_gblinear_multi(X, y)


@pytest.fixture(scope="module")
def trained(ridge_problem):
    X, y = ridge_problem
    return tgb.train_gblinear(X, y, tgb.GBLinearParams(num_round=5), device="cpu")


@pytest.mark.parametrize("ext", [".save", ".dump"])
def test_saved_bytes_equal_jax(tmp_path, trained, ext):
    jmodel = jgb.GBLinearModel(weight=trained.weight, bias=trained.bias, base_score=trained.base_score)
    txgb.save_expression_model(trained, tmp_path / f"t{ext}")
    jxgb.save_expression_model(jmodel, tmp_path / f"j{ext}")
    assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    assert txgb.dump_text(trained) == jxgb.dump_text(jmodel)


def test_npz_and_loaders_round_trip(tmp_path, trained, ridge_problem):
    X, _ = ridge_problem
    for name in ("m.save", "m.dump", "m.npz"):
        txgb.save_expression_model(trained, tmp_path / name)
        for loaded in (txgb.load_expression_model(tmp_path / name), jxgb.load_expression_model(tmp_path / name)):
            np.testing.assert_allclose(loaded.weight, trained.weight, rtol=1e-6)
    # a port-trained .save scores the same through the JAX package's loader
    jm = jxgb.load_expression_model(tmp_path / "m.save")
    np.testing.assert_array_equal(jgb.predict_gblinear(jm, X), tgb.predict_gblinear(trained, X))


def test_golden_xgb07_round_trip(tmp_path):
    """The independently assembled xgboost-0.7 file decodes to its values,
    and the port writes it back byte for byte (without the optional "binf"
    magic prefix)."""
    data = open(GOLDEN, "rb").read()
    model = txgb.load_expression_model(GOLDEN)
    np.testing.assert_array_equal(model.weight, np.array([0.5, -1.25, 3.0, 0.0, -0.0078125, 1024.0, -7.5], np.float32))
    assert (model.bias, model.base_score) == (0.75, 2.0)
    txgb.save_expression_model(model, tmp_path / "g.save")
    assert data[:4] == b"binf" and (tmp_path / "g.save").read_bytes() == data[4:]


@pytest.mark.parametrize("case", ["fp32", "fp64", "int", "constant_exact", "constant_off", "anti"])
def test_r2_score_matches_sklearn(case):
    rng = np.random.default_rng(11)
    yt = rng.normal(size=500).astype(np.float32)
    yp = (yt + rng.normal(size=500) * 0.3).astype(np.float32)
    if case == "fp64":
        yt, yp = yt.astype(np.float64), yp.astype(np.float64)
    elif case == "int":
        yt, yp = np.arange(50), np.arange(50)[::-1] % 7
    elif case == "constant_exact":
        yt = yp = np.full(20, 3.0, np.float32)
    elif case == "constant_off":
        yt, yp = np.full(20, 3.0, np.float32), np.full(20, 3.5, np.float32)
    elif case == "anti":
        yp = -yt
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_r2_score(y_true=yt, y_pred=yp)
    np.testing.assert_allclose(r2_score(yt, yp), want, rtol=1e-6)
    assert np.isnan(r2_score([1.0], [1.0]))
