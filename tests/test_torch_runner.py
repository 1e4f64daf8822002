"""The port's serving runner vs the JAX package's BelugaRunner, fp32 on the
CPU: the wire codecs and every public scoring method, including the N-dense
fallbacks; and the runner's chunk producer, which packs each chunk as it
reaches it: bit-equal to one whole-batch packing plan, the 4-bit wire taken by
an N-dense chunk alone, and no packing before the first chunk is drawn."""

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

@pytest.mark.parametrize("length", [1, 2, 3, 5, 2800, 2801, 2802, 2803])
def test_pack_codes2_round_trip_with_dropped_pad_rows(length):
    codes = random_codes(np.random.default_rng(length), 4, length, n_frac=0.05)
    packed, rows, cols = trunner.pack_codes2(codes)
    j_packed, j_rows, j_cols = jrunner.pack_codes2(codes)
    for got, want in ((packed, j_packed), (rows, j_rows), (cols, j_cols)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
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
    """budget 0 sends each of the port's chunks that holds an N down the
    4-bit wire, still chunked by unique variant (the JAX runner expands the
    rows and takes its per-row path)."""
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


# ---- the chunk producer's packing ---------------------------------------------

N_U = 5  # unique variants
ROWS_FOR_CHUNKS = {1: 5, 2: 3, 5: 1}  # spans (or pairs) a chunk -> chunks of N_U


def _runner_for(params, rows: int, pairs: bool):
    """A CPU runner whose chunks hold ``rows`` spans (``rows`` pairs on the
    pair paths) at the 5 offsets."""
    batch = rows * len(OFFSETS) * (2 if pairs else 1)
    r = trunner.BelugaRunner(params, batch_size=batch, device="cpu")
    assert (r._pair_rows if pairs else r._span_rows)(len(OFFSETS)) == rows
    return r


def _whole_batch_chunks(runner):
    """``_code_chunks`` and ``_pair_chunks`` as one whole-batch
    ``pack_codes2`` plan makes them: the batch packed (the pairs interleaved
    first) before the first chunk, each chunk's sideband cut out by row and
    shifted to the chunk."""

    def code_chunks(span_codes, rows):
        n, span_len = span_codes.shape
        packed, n_rows, n_cols = trunner.pack_codes2(span_codes)
        chunks = []
        for start in range(0, n, rows):
            end = min(start + rows, n)
            i0, i1 = np.searchsorted(n_rows, [start, end])
            chunks.append((start, trunner.unpack_codes2(runner._up(packed[start:end]), span_len,
                                                        runner._up(n_rows[i0:i1] - start), runner._up(n_cols[i0:i1]))))
        return iter(chunks)

    def pair_chunks(ref_spans, alt_spans, rows):
        inter = np.empty((2 * ref_spans.shape[0], ref_spans.shape[1]), np.int8)
        inter[0::2], inter[1::2] = ref_spans, alt_spans
        return ((start2 // 2, codes) for start2, codes in code_chunks(inter, 2 * rows))

    return code_chunks, pair_chunks


def _method_call(method, models, dense: int | None = None):
    """(pair path, a call of ``method`` on a runner) over N_U unique
    variants; ``dense`` names a variant whose (ref) span starts with 1,500
    N bases."""
    W, bias = models
    spans, alt = _sub_inputs(N_U, seed=30)
    ref, alt_spans = _pair_inputs(N_U, seed=31)
    if dense is not None:
        spans[dense, :1500] = ref[dense, :1500] = 4
    row_uidx = np.array([0, 0, 1, 2, 2, 2, 3, 4])
    pos_weights = np.random.default_rng(36).random((10, len(OFFSETS))).astype(np.float32)
    calls = {
        "score_variant_spans_packed_rows": (False, lambda r: r.score_variant_spans_packed_rows(
            spans, MUTPOS, alt, OFFSETS, _basis(len(row_uidx), 32), row_uidx, W, bias)),
        "score_variant_span_pairs_rows": (True, lambda r: r.score_variant_span_pairs_rows(
            ref, alt_spans, OFFSETS, _basis(len(row_uidx), 33), row_uidx, W, bias)),
        "score_variant_spans_packed": (False, lambda r: r.score_variant_spans_packed(
            spans, MUTPOS, alt, OFFSETS, _basis(N_U, 34), W, bias)),
        "score_variant_spans": (True, lambda r: r.score_variant_spans(
            ref, alt_spans, OFFSETS, _basis(N_U, 35), W, bias)),
        "predict_span_pairs_diff": (True, lambda r: r.predict_span_pairs_diff(ref, alt_spans, OFFSETS)),
        "predict_span_pair_diffs_only": (True, lambda r: r.predict_span_pair_diffs_only(ref, alt_spans, OFFSETS)),
        "predict_span_codes": (False, lambda r: r.predict_span_codes(spans, OFFSETS, rc_mode="concat")),
        "predict_spans_project": (False, lambda r: r.predict_spans_project(spans, OFFSETS, pos_weights)),
    }
    return calls[method]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class _PackSpy:
    """Stands in for a packer of the runner's module and keeps the number of
    spans of each call."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, codes):
        self.rows.append(codes.shape[0])
        return self.fn(codes)


@pytest.mark.parametrize("chunks", sorted(ROWS_FOR_CHUNKS))
@pytest.mark.parametrize("method", ["score_variant_spans_packed_rows", "score_variant_span_pairs_rows",
                                    "score_variant_spans", "predict_span_pairs_diff"])
def test_streamed_packing_is_bit_equal_to_one_whole_batch_plan(params, models, method, chunks, monkeypatch):
    """Each chunk packed as the producer reaches it gives the outputs of the
    same call on chunks cut from one whole-batch packing, bit for bit, at
    1, 2 and 5 chunks; ``pack_codes2`` runs once a chunk."""
    pairs, call = _method_call(method, models)
    runner = _runner_for(params, ROWS_FOR_CHUNKS[chunks], pairs)
    spy = _PackSpy(trunner.pack_codes2)
    monkeypatch.setattr(trunner, "pack_codes2", spy)
    streamed = _as_tuple(call(runner))
    assert len(spy.rows) == chunks and sum(spy.rows) == N_U * (2 if pairs else 1)
    code_chunks, pair_chunks = _whole_batch_chunks(runner)
    monkeypatch.setattr(runner, "_code_chunks", code_chunks)
    monkeypatch.setattr(runner, "_pair_chunks", pair_chunks)
    whole = _as_tuple(call(runner))
    assert len(streamed) == len(whole)
    for got, want in zip(streamed, whole):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["score_variant_spans_packed_rows", "score_variant_span_pairs_rows",
                                    "predict_span_codes"])
def test_an_n_dense_chunk_takes_the_4bit_wire_alone(params, models, method, monkeypatch):
    """Variant 2's span starts with 1,500 N; one span (one pair) a chunk and
    a budget of 1,200 N, above every other chunk's N count: that chunk alone
    ships 4 bits a base, the others 2 bits, and the outputs equal those with
    the budget raised to 10**6 (every chunk on the 2-bit wire) bit for
    bit."""
    pairs, call = _method_call(method, models, dense=2)
    runner = _runner_for(params, 1, pairs)
    spy4 = _PackSpy(trunner.pack_codes)
    monkeypatch.setattr(trunner, "pack_codes", spy4)
    runner.PACK2_SIDE_BUDGET = 1200
    mixed = _as_tuple(call(runner))
    assert spy4.rows == [2 if pairs else 1]
    runner.PACK2_SIDE_BUDGET = 10**6
    all_2bit = _as_tuple(call(runner))
    assert len(spy4.rows) == 1
    for got, want in zip(mixed, all_2bit):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["score_variant_spans_packed_rows", "score_variant_span_pairs_rows",
                                    "score_variant_spans_packed", "score_variant_spans", "predict_span_pairs_diff",
                                    "predict_span_pair_diffs_only", "predict_span_codes", "predict_spans_project"])
def test_one_step_of_a_job_generator_packs_at_most_one_chunk(params, models, method, monkeypatch):
    """Nothing is packed before the first chunk is drawn, and drawing it
    packs that chunk's spans alone: the rest wait for their own steps."""
    pairs, call = _method_call(method, models)
    rows = 2
    runner = _runner_for(params, rows, pairs)
    spy = _PackSpy(trunner.pack_codes2)
    monkeypatch.setattr(trunner, "pack_codes2", spy)
    steps = []

    def one_step(jobs, write):
        steps.append(list(spy.rows))
        next(iter(jobs))
        steps.append(list(spy.rows))

    monkeypatch.setattr(runner, "_run_pipelined", one_step)
    call(runner)
    assert steps == [[], [rows * (2 if pairs else 1)]]
