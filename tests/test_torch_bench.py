"""The port's bench (``python -m expecto_tpu_torch.bench``) against the
repository's ``bench.py`` and the JAX package, on the CPU at narrow widths:
its workload generators equal ``bench.py``'s, each path's call agrees with
the JAX call on the same inputs (fp32 runners on both sides), the factored
K-model round equals the sweep bit for bit, and ``main`` prints one result
line or, on any failure, none."""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import expecto_tpu.pipeline.chromatin as jax_chromatin
from expecto_tpu.genome.fasta import FastaIndex as JaxFastaIndex
from expecto_tpu.genome.fasta import write_fasta as jax_write_fasta
from expecto_tpu.parallel.runner import BelugaRunner as JaxBelugaRunner
from expecto_tpu.pipeline.consensus import _predict_consensus_features_cohort as jax_features_cohort
from expecto_tpu.pipeline.consensus import _predict_consensus_preds as jax_consensus_preds
import expecto_tpu_torch.bench as tb
from expecto_tpu_torch.genome.fasta import FastaIndex
from expecto_tpu_torch.models import gblinear as torch_gb
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline.chromatin import compute_variant_chromatin_effects
from expecto_tpu_torch.pipeline.consensus import _predict_consensus_preds
from torch_port_common import narrow_params, sed_atol, single_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
#: bench.py's off-card sizes, which ``--device cpu`` takes
SIZES = tb.OFF_CARD
#: fp32 limits of the port against the JAX package (ROADMAP's parity mode)
REF_RTOL, REF_ATOL, TRACK_ATOL, FEATURE_RTOL, WEIGHT_RTOL = 1e-4, 1e-5, 1e-5, 1e-5, 1e-5


def _jax_bench():
    """The repository's bench.py as a module (its generators import the JAX
    package when called)."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jb = _jax_bench()


@pytest.fixture(scope="module")
def runners():
    """fp32 runners of both packages at the bench's two batch sizes."""
    params = narrow_params(0)
    return {b: (BelugaRunner(params, batch_size=b, device="cpu"), JaxBelugaRunner(params, batch_size=b))
            for b in (2048, 3200)}


@pytest.fixture(scope="module")
def work():
    return tb._variant_workload(SIZES.variants, tb.MAXSHIFT, tb.N_MODELS)


@pytest.fixture(scope="module")
def narrow_weights():
    """A stand-in for ``bench.build_weights``: narrow params for the
    runners, and a reference-keyed state dict of zeros at the oracle's
    (published) widths for the CPU baseline, whose time is all it gives."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_oracle import TorchBeluga

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in TorchBeluga().state_dict_reference_keys().items()}
    state_dict = {k: torch.zeros(shape) for k, shape in shapes.items()}
    return lambda: (state_dict, narrow_params(0))


@pytest.fixture(scope="module")
def jax_train_record():
    """``bench.py``'s training measurement at the off-card shape, with every
    call of its jitted functions recorded: [(args, outputs)] as numpy."""
    n, f, k, rounds = SIZES.train
    calls = []
    real_jit = jax.jit

    def recording_jit(fn, **kw):
        jitted = real_jit(fn, **kw)

        def call(*args):
            host_args = [np.asarray(a) for a in args]  # before a donated buffer is reused
            out = jitted(*args)
            calls.append((host_args, jax.tree.map(np.asarray, out)))
            return out

        return call

    jax.jit = recording_jit
    try:
        jb.measure_train_ms_per_round(n=n, f=f, k=k, rounds=rounds)
    finally:
        jax.jit = real_jit
    rounds_run = [c for c in calls if len(c[0]) == 7]  # (w_blocks, bias, r, rw, n_eff, Xt, hess)
    assert len(rounds_run) == 3 + rounds
    return rounds_run


# --- the workload generators equal bench.py's -------------------------------------


class _SpyRunner:
    """Records ``predict_spans_project``'s arguments (bench.py's gene path)."""

    def __init__(self):
        self.calls = []

    def predict_spans_project(self, spans, offsets, pos_weights):
        self.calls.append((spans, offsets, pos_weights))
        return np.zeros((len(spans), 1), np.float32)


def _gen_variants(monkeypatch):
    got, want = tb._variant_workload(64, 800, 218), jb._variant_workload(64, 800, 218)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _gen_genes(monkeypatch):
    spy = _SpyRunner()
    jb.measure_gene_features_per_sec(spy, n_genes=SIZES.genes, repeats=1)
    spans, offsets, pw = tb._gene_workload(SIZES.genes)
    w_spans, w_offsets, w_pw = spy.calls[-1]
    np.testing.assert_array_equal(spans, w_spans)
    assert offsets == w_offsets
    np.testing.assert_array_equal(pw, w_pw)
    np.testing.assert_array_equal(spy.calls[0][0], spans[: max(SIZES.genes // 4, 1)])


def _gen_h5(monkeypatch, variant_class):
    seen = []

    def spy(vcf, fa, runner, out_dir, **kw):
        seen.append((vcf.copy(), fa.sequence("chr1", 1, fa.contig_length("chr1")), kw))

    monkeypatch.setattr(jax_chromatin, "compute_variant_chromatin_effects", spy)
    jb.measure_h5_pipeline_variants_per_sec(None, n_variants=SIZES.h5_variants, variant_class=variant_class, repeats=1)
    seq, rng = tb._h5_genome()
    vcf = tb._h5_vcf(seq, rng, SIZES.h5_variants, variant_class)
    w_vcf, w_seq, kw = seen[-1]
    assert seq == w_seq
    pd.testing.assert_frame_equal(vcf, w_vcf)
    assert kw["maxshift"] == tb.MAXSHIFT


def _gen_cohorts(monkeypatch):
    for n, private, sites in ((SIZES.shared_samples, False, 42), (SIZES.private_samples, True, 42),
                              (SIZES.private_samples, True, 4)):
        assert tb._consensus_cohort_seqs(n, private=private, n_sites=sites) == jb._consensus_cohort_seqs(
            n, private=private, n_sites=sites)


GENERATORS = {"variants": _gen_variants, "genes": _gen_genes, "h5_sub": lambda m: _gen_h5(m, "sub"),
              "h5_indel": lambda m: _gen_h5(m, "indel"), "cohorts": _gen_cohorts}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_equals_bench_py(name, monkeypatch):
    GENERATORS[name](monkeypatch)


def test_train_workload_equals_bench_py(jax_train_record):
    """X (as bench.py's padded, transposed feature blocks) and the first
    residual base_score - Y, bit for bit."""
    n, f, k, _rounds = SIZES.train
    X, Y = tb._train_workload(n, f, k)
    args, _out = jax_train_record[0]
    Xt = args[5]
    np.testing.assert_array_equal(Xt.reshape(-1, n)[:f], X.T)
    assert not Xt.reshape(-1, n)[f:].any()
    np.testing.assert_array_equal(args[2], np.full((n, k), 2.0, np.float32) - Y)


# --- each path's call against the JAX call --------------------------------------


def _ref_alt_sed_close(got, want):
    REF, ALT, SED = (np.asarray(a, np.float32) for a in got)
    jREF, jALT, jSED = want
    np.testing.assert_allclose(REF, jREF, rtol=REF_RTOL, atol=REF_ATOL)
    np.testing.assert_allclose(ALT, jALT, rtol=REF_RTOL, atol=REF_ATOL)
    np.testing.assert_allclose(SED, jSED, rtol=0, atol=sed_atol(jREF))


def _features_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_RTOL * float(np.abs(want).max()))


def test_serving_and_ceiling_paths_match_jax(runners, work):
    port, jr = runners[2048]
    ref_spans, mutpos, alt, offsets, _span_len, basis, W, bias = work
    want = jr.score_variant_spans_packed(ref_spans, mutpos, alt, offsets, basis, W, bias)
    _ref_alt_sed_close(tb.serving_path(port, work).call(), want)
    path = tb.ceiling_path(port, work)
    REF, SED = (t.float().numpy() for t in path.call())
    rows = path.items
    assert rows == min(port._span_rows(len(offsets)), SIZES.variants) and REF.shape == (rows, tb.N_MODELS)
    _ref_alt_sed_close((REF, REF + SED, SED), tuple(a[:rows] for a in want))


def test_indel_path_matches_jax(runners, work):
    port, jr = runners[2048]
    ref_spans, _mutpos, _alt, offsets, _span_len, basis, W, bias = work
    n = SIZES.indels
    want = jr.score_variant_spans(ref_spans[:n], np.roll(ref_spans[:n], 2, axis=1), offsets,
                                  np.ascontiguousarray(basis[:, :n]), W, bias)
    _ref_alt_sed_close(tb.indel_path(port, work, n).call(), want)


def test_gene_path_matches_jax(runners):
    port, jr = runners[3200]
    spans, offsets, pw = tb._gene_workload(SIZES.genes)
    got = tb.gene_path(port, SIZES.genes).call()
    assert got.shape == (SIZES.genes, 10 * 2002)
    _features_close(got, jr.predict_spans_project(spans, offsets, pw))


@pytest.mark.parametrize("variant_class", ["sub", "indel"])
def test_h5_path_matches_jax(runners, variant_class, tmp_path):
    """The h5 path's call on the seeded genome with its arrays kept, the
    effects (ref, alt, diff of every shift) within 1e-5."""
    port, jr = runners[2048]
    seq, rng = tb._h5_genome()
    vcf = tb._h5_vcf(seq, rng, SIZES.h5_variants, variant_class)
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        jax_write_fasta(tmp_path / side / "g.fa", {"chr1": seq})
    genome = FastaIndex(tmp_path / "port" / "g.fa")
    jax_genome = JaxFastaIndex(tmp_path / "jax" / "g.fa")
    try:
        kw = dict(maxshift=tb.MAXSHIFT, verbose=False, keep_arrays=True)
        got = compute_variant_chromatin_effects(vcf, genome, port, None, **kw)
        want = jax_chromatin.compute_variant_chromatin_effects(vcf, jax_genome, jr, None, **kw)
    finally:
        genome.close()
        jax_genome.close()
    assert sorted(got.arrays) == sorted(want.arrays) == sorted(got.shifts)
    for shift in got.shifts:
        for g, w in zip(got.arrays[shift], want.arrays[shift]):
            assert g.shape == (2 * SIZES.h5_variants, 2002)
            np.testing.assert_allclose(g, w, rtol=0, atol=TRACK_ATOL)


@pytest.mark.parametrize("private", [False, True], ids=["shared", "private"])
def test_consensus_path_matches_jax(runners, private):
    """Track predictions of the cohort in fp32 within 1e-5 of JAX's; the
    path's own call (fp16 fetch) within one fp16 step of them."""
    port, jr = runners[2048]
    n = SIZES.private_samples if private else SIZES.shared_samples
    seqs = tb._consensus_cohort_seqs(n, private=private)
    got = _predict_consensus_preds(port, seqs, None, dtype=np.float32)
    np.testing.assert_allclose(got, jax_consensus_preds(jr, seqs, None, dtype=np.float32), rtol=0, atol=TRACK_ATOL)
    wire = tb.consensus_path(port, n, private=private).call()
    assert wire.dtype == np.float16 and wire.shape == got.shape
    np.testing.assert_allclose(wire.astype(np.float32), got, rtol=0, atol=2.0**-11)


@pytest.mark.parametrize("n_sites", [42, 4])
def test_featonly_path_matches_jax(runners, n_sites):
    port, jr = runners[3200]
    seqs = tb._consensus_cohort_seqs(SIZES.private_samples, private=True, n_sites=n_sites)
    got = tb.featonly_path(port, SIZES.private_samples, n_sites).call()
    _features_close(got, jax_features_cohort(jr, seqs, None))


def test_train_path_matches_jax(jax_train_record):
    """The bench's rounds (3 warm + the timed ones) against bench.py's jitted
    rounds on the same inputs: weights within 1e-5 of max|w|, biases 1e-6."""
    n, f, k, rounds = SIZES.train
    s = torch_gb.multi_state(*tb._train_workload(n, f, k), None, tb.TRAIN_HP, torch.device("cpu"))
    for _ in range(3 + rounds):
        torch_gb.multi_round(tb.TRAIN_HP, s)
    w_blocks, bias = s.w_blocks, s.bias
    want_w, want_b, _want_r = jax_train_record[-1][1]
    w, jw = w_blocks.numpy().reshape(-1, k)[:f], np.asarray(want_w).reshape(-1, k)[:f]
    assert np.abs(jw).max() > 0
    np.testing.assert_allclose(w, jw, rtol=0, atol=WEIGHT_RTOL * float(np.abs(jw).max()))
    np.testing.assert_allclose(bias.numpy(), want_b, rtol=0, atol=1e-6)


def test_multi_round_gives_the_sweep_bit_for_bit():
    """``multi_state`` and R ``multi_round`` calls give
    ``train_gblinear_multi``'s weights and biases for num_round R."""
    n, f, k, _ = SIZES.train
    X, Y = tb._train_workload(n, f, k)
    hp = torch_gb.GBLinearParams(num_round=5, block_size=64)
    s = torch_gb.multi_state(X, Y, None, hp, torch.device("cpu"))
    for _ in range(hp.num_round):
        torch_gb.multi_round(hp, s)
    w_blocks, bias = s.w_blocks, s.bias
    want = torch_gb.train_gblinear_multi(X, Y, hp, device="cpu")
    np.testing.assert_array_equal(w_blocks.numpy().reshape(-1, k)[:f], want.weights)
    np.testing.assert_array_equal(bias.numpy(), want.biases)


# --- main: one result line, or none --------------------------------------------


def _result_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_main_prints_one_line_with_every_key(monkeypatch, capsys, narrow_weights):
    """``main(["--device", "cpu", "--with-h5-writes"])`` with narrow weights
    for the runners and a 2-window baseline: one JSON line, bench.py's
    contract, every path key finite and > 0, no rescue key."""
    monkeypatch.setattr(tb, "build_weights", narrow_weights)
    monkeypatch.setattr(tb, "BASELINE_WINDOWS", 2)
    assert tb.main(["--device", "cpu", "--with-h5-writes"]) == 0
    out = capsys.readouterr().out
    (record,) = _result_lines(out)
    assert len(out.strip().splitlines()) == 1
    assert (record["metric"], record["unit"]) == ("variants_per_sec_per_chip", "variants/s")
    assert record["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "paths", "device"}
    assert set(record["paths"]) == set(tb.PATH_KEYS) | set(tb.H5_WRITE_KEYS)
    for key, v in [("value", record["value"]), ("vs_baseline", record["vs_baseline"]), *record["paths"].items()]:
        assert isinstance(v, float) and math.isfinite(v) and v > 0, key


def test_a_failing_path_exits_nonzero_with_no_result(monkeypatch, capsys, narrow_weights):
    """A step that raises (here the CPU baseline, after the headline path)
    propagates out of ``main`` and nothing is printed; run as a script, with
    JAX and the JAX package blocked, the first path raising gives a non-zero
    exit and an empty standard output."""
    monkeypatch.setattr(tb, "build_weights", narrow_weights)

    def broken(*a, **kw):
        raise RuntimeError("planted path failure")

    monkeypatch.setattr(tb, "measure_cpu_torch_windows_per_sec", broken)
    with pytest.raises(RuntimeError, match="planted path failure"):
        tb.main(["--device", "cpu"])
    assert not _result_lines(capsys.readouterr().out)

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['expecto_tpu'] = None\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        "import expecto_tpu_torch.bench as tb\n"
        "from torch_port_common import narrow_params\n"
        "tb.build_weights = lambda: (None, narrow_params(0))\n"
        "def broken(*a, **kw):\n"
        "    raise RuntimeError('planted path failure')\n"
        "tb.serving_path = broken\n"
        "sys.exit(tb.main(['--device', 'cpu']))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert res.returncode != 0 and "planted path failure" in res.stderr
    assert res.stdout == ""


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tb, "build_weights", lambda: pytest.fail("built weights without a device"))
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tb.main(argv)


def test_h5_writes_need_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(tb, "build_weights", lambda: pytest.fail("measured without h5py"))
    with pytest.raises(ImportError):
        tb.main(["--device", "cpu", "--with-h5-writes"])
