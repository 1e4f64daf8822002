"""The port's serving runner vs the JAX package's BelugaRunner, fp32 on the
CPU: the wire codecs and every public scoring method, including the N-dense
fallbacks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expecto_tpu.genome.windows import variant_shifts
from expecto_tpu.parallel import runner as jrunner
from expecto_tpu_torch.parallel import runner as trunner
from torch_port_common import single_torch_thread, narrow_params, random_codes, sed_atol  # noqa: F401 (autouse fixture)

# REF/ALT: fp32, rtol 1e-4; SED: torch_port_common.sed_atol
RTOL, ATOL = 1e-4, 1e-5
MAXSHIFT = 400
SPAN_LEN = 2 * MAXSHIFT + 2000
MUTPOS = MAXSHIFT + 999
OFFSETS = tuple(s + MAXSHIFT for s in variant_shifts(MAXSHIFT))


@pytest.fixture(scope="module")
def params():
    return narrow_params(21)


@pytest.fixture(scope="module")
def runners(params):
    return jrunner.BelugaRunner(params, batch_size=16), trunner.BelugaRunner(params, batch_size=16, device="cpu")


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(8)
    W = (rng.standard_normal((10 * 2002, 3)) * 0.05).astype(np.float32)
    bias = np.array([2.0, 2.1, 1.9], np.float32)
    return W, bias


def _check(got, want):
    for name, g, w in zip(("REF", "ALT", "SED"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=sed_atol(want[0]) if name == "SED" else ATOL, err_msg=name)
    np.testing.assert_allclose(got[2], got[1] - got[0], atol=1e-5)


def _basis(n_rows, seed):
    return np.random.default_rng(seed).random((len(OFFSETS), n_rows, 10)).astype(np.float32)


# ---- wire codecs ---------------------------------------------------------

@pytest.mark.parametrize("length", [2800, 2801, 2802, 2803])
def test_pack_codes2_round_trip_with_dropped_pad_rows(length):
    codes = random_codes(np.random.default_rng(length), 4, length, n_frac=0.05)
    packed, rows, cols = trunner.pack_codes2(codes)
    j_packed, j_rows, j_cols = jrunner.pack_codes2(codes)
    np.testing.assert_array_equal(packed, j_packed)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(cols, j_cols)
    # sideband padded the JAX runner's way: row index == n_rows is out of range
    pad = 7
    rows_p = np.concatenate([rows, np.full(pad, codes.shape[0], np.int32)])
    cols_p = np.concatenate([cols, np.zeros(pad, np.int32)])
    got = trunner.unpack_codes2(torch.from_numpy(packed), length, torch.from_numpy(rows_p), torch.from_numpy(cols_p))
    np.testing.assert_array_equal(got.numpy(), codes)
    want = jrunner.unpack_codes2(jnp.asarray(packed), length, jnp.asarray(rows_p), jnp.asarray(cols_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [9, 10])
def test_pack_codes_round_trip(length):
    codes = random_codes(np.random.default_rng(length), 3, length, n_frac=0.2)
    packed = trunner.pack_codes(codes)
    np.testing.assert_array_equal(packed, jrunner.pack_codes(codes))
    got = trunner.unpack_codes(torch.from_numpy(packed), length)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), codes)


def test_onehot_and_rc_match_jax():
    codes = random_codes(np.random.default_rng(3), 2, 50, n_frac=0.2)
    x = trunner.onehot_from_codes(torch.from_numpy(codes))
    want = jrunner.onehot_from_codes(jnp.asarray(codes))
    np.testing.assert_array_equal(x.numpy(), np.asarray(want))
    assert (x.numpy()[codes == 4] == 0).all()
    np.testing.assert_array_equal(trunner.rc_onehot(x).numpy(), np.asarray(jrunner.rc_onehot(want)))


def test_fp32_wire_kw():
    class Duck:
        pass

    assert trunner.fp32_wire_kw(Duck()) == {}
    r16 = trunner.BelugaRunner(narrow_params(0), device="cpu", out_dtype=np.float16)
    assert trunner.fp32_wire_kw(r16) == {"out_dtype": np.float32}


# ---- scoring methods -----------------------------------------------------

@pytest.mark.parametrize("average_rc", [False, True])
def test_predict_codes_matches_jax(runners, average_rc):
    jr, tr = runners
    codes = random_codes(np.random.default_rng(4), 5, 2000)
    got = tr.predict_codes(codes, average_rc=average_rc)
    np.testing.assert_allclose(got, jr.predict_codes(codes, average_rc=average_rc), rtol=RTOL, atol=2e-6)


def test_predict_codes_fp16_wire_and_override(params):
    codes = random_codes(np.random.default_rng(5), 3, 2000)
    r16 = trunner.BelugaRunner(params, batch_size=2, device="cpu", out_dtype=np.float16)
    r32 = trunner.BelugaRunner(params, batch_size=2, device="cpu")
    assert r16.predict_codes(codes).dtype == np.float16
    np.testing.assert_array_equal(r16.predict_codes(codes, out_dtype=np.float32), r32.predict_codes(codes))


def _sub_inputs(n_u, seed):
    rng = np.random.default_rng(seed)
    spans = random_codes(rng, n_u, SPAN_LEN)
    alt = np.full((n_u, 2), -1, np.int8)  # -1 keeps the reference base
    alt[:, 0] = (spans[:, MUTPOS] + 1) % 4
    alt[1:, 1] = (spans[1:, MUTPOS + 1] + 2) % 4  # multi-base substitutions
    return spans, alt


@pytest.mark.parametrize("budget", [None, 0])
def test_score_variant_spans_packed_rows_matches_jax(runners, models, budget, monkeypatch):
    """budget 0 forces the N-dense fallback (expanded rows, 4-bit wire)."""
    jr, tr = runners
    W, bias = models
    if budget is not None:
        monkeypatch.setattr(jr, "PACK2_SIDE_BUDGET", budget)
        monkeypatch.setattr(tr, "PACK2_SIDE_BUDGET", budget)
    spans, alt = _sub_inputs(4, seed=6)
    row_uidx = np.array([0, 0, 0, 1, 2, 2, 3])
    basis = _basis(len(row_uidx), seed=7)
    args = (spans, MUTPOS, alt, OFFSETS, basis, row_uidx, W, bias)
    _check(tr.score_variant_spans_packed_rows(*args), jr.score_variant_spans_packed_rows(*args))


@pytest.mark.parametrize("budget", [None, 0])
def test_score_variant_spans_packed_matches_jax(runners, models, budget, monkeypatch):
    jr, tr = runners
    W, bias = models
    if budget is not None:
        monkeypatch.setattr(jr, "PACK2_SIDE_BUDGET", budget)
        monkeypatch.setattr(tr, "PACK2_SIDE_BUDGET", budget)
    spans, alt = _sub_inputs(4, seed=8)
    args = (spans, MUTPOS, alt, OFFSETS, _basis(4, seed=9), W, bias)
    _check(tr.score_variant_spans_packed(*args), jr.score_variant_spans_packed(*args))


def _pair_inputs(n_u, seed):
    rng = np.random.default_rng(seed)
    ref = random_codes(rng, n_u, SPAN_LEN)
    alt = ref.copy()
    alt[:, MUTPOS:] = np.roll(ref[:, MUTPOS:], 2, axis=1)  # an insertion-like shifted tail
    alt[:, MUTPOS : MUTPOS + 2] = rng.integers(0, 4, (n_u, 2))
    return ref, alt


@pytest.mark.parametrize("budget", [None, 0])
def test_score_variant_span_pairs_rows_matches_jax(runners, models, budget, monkeypatch):
    jr, tr = runners
    W, bias = models
    if budget is not None:
        monkeypatch.setattr(jr, "PACK2_SIDE_BUDGET", budget)
        monkeypatch.setattr(tr, "PACK2_SIDE_BUDGET", budget)
    ref, alt = _pair_inputs(3, seed=10)
    row_uidx = np.array([0, 1, 1, 2])
    args = (ref, alt, OFFSETS, _basis(4, seed=11), row_uidx, W, bias)
    _check(tr.score_variant_span_pairs_rows(*args), jr.score_variant_span_pairs_rows(*args))


def test_score_variant_spans_matches_jax(runners, models):
    jr, tr = runners
    W, bias = models
    ref, alt = _pair_inputs(3, seed=12)
    args = (ref, alt, OFFSETS, _basis(3, seed=13), W, bias)
    _check(tr.score_variant_spans(*args), jr.score_variant_spans(*args))


def test_production_wire_is_fp16_and_close_to_parity(params, models):
    """bf16 compute with an fp16 wire: SED still equals ALT - REF exactly on
    the host (ALT is rebuilt from the wire) and tracks the fp32 result."""
    W, bias = models
    spans, alt = _sub_inputs(2, seed=14)
    row_uidx = np.array([0, 1])
    args = (spans, MUTPOS, alt, OFFSETS, _basis(2, seed=15), row_uidx, W, bias)
    prod = trunner.BelugaRunner(params, device="cpu", compute_dtype=torch.bfloat16, out_dtype=np.float16)
    parity = trunner.BelugaRunner(params, device="cpu")
    R, A, S = prod.score_variant_spans_packed_rows(*args)
    np.testing.assert_array_equal(A, R + S)
    R32, _A32, _S32 = parity.score_variant_spans_packed_rows(*args)
    # bf16 activations: ~3 significant digits on |REF| ~ 2
    np.testing.assert_allclose(R, R32, rtol=2e-2, atol=2e-2)


def test_runner_defaults_to_cuda_and_raises_without_gpu(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        trunner.BelugaRunner(params)
