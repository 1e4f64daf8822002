"""The port runner's pipelined execution on the CPU: every public method at
pipeline depth 5 equal bit for bit to depth 1 over at least six chunks;
``predict_codes`` and ``predict_codes_fwd_rc_concat`` against the JAX
runner; sinks that run late or out of order, writes that raise, jobs that
raise, dispatch that runs ahead of the writes; ``stream_span_rows`` under
its lock; the gene block size and the gene CLI's depth.

Tolerance against the JAX runner: fp32 on both sides, the runner tests'
rtol 1e-4 / atol 1e-5. Between depths nothing may differ: the same chunks
run the same operations in the same order."""

import threading
import time

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.genome.windows import variant_shifts
from expecto_tpu.parallel import runner as jrunner
from expecto_tpu_torch.genome.fasta import FastaIndex
from expecto_tpu_torch.ops.spans import conv6_patch_sites_plan
from expecto_tpu_torch.parallel import runner as trunner
from expecto_tpu_torch.pipeline import chromatin as tchrom
from expecto_tpu_torch.pipeline import features as tfeat
from torch_port_common import COMPLEMENT, narrow_params, random_codes, serving_tables
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-4, 1e-5
MAXSHIFT = 400
SPAN_LEN = 2 * MAXSHIFT + 2000
MUTPOS = MAXSHIFT + 999
OFFSETS = tuple(s + MAXSHIFT for s in variant_shifts(MAXSHIFT))  # 5 offsets
N = 6  # spans, pairs, genes or unique variants: one a chunk at the batches below
DEEP = 5
WAIT_S = 20  # a blocked write waits this long for the jobs to run ahead, then fails


@pytest.fixture(scope="module")
def params():
    return narrow_params(13)


def _runner(params, depth, batch):
    return trunner.BelugaRunner(params, batch_size=batch, device="cpu", pipeline_depth=depth)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    spans = random_codes(rng, N, SPAN_LEN)
    alt_spans = spans.copy()
    alt_spans[:, MUTPOS:] = np.roll(spans[:, MUTPOS:], 2, axis=1)  # an insertion-like shifted tail
    alt_alleles = np.full((N, 2), -1, np.int8)
    alt_alleles[:, 0] = (spans[:, MUTPOS] + 1) % 4
    alt_alleles[::2, 1] = (spans[::2, MUTPOS + 1] + 2) % 4
    row_uidx = np.array([0, 0, 1, 2, 2, 2, 3, 4, 5, 5])
    # a cohort: sample 0 is the backbone, the others carry 1-3 sites each
    backbone = random_codes(rng, 1, SPAN_LEN, n_frac=0.0)[0]
    samples = np.repeat(backbone[None], N, axis=0)
    for i in range(1, N):
        sites = rng.choice(np.arange(1200, 1600), size=1 + i % 3, replace=False)
        samples[i, sites] = (samples[i, sites] + 1) % 4
    return {
        "codes": random_codes(rng, 2 * N, 2000), "spans": spans, "alt_spans": alt_spans,
        "alt_alleles": alt_alleles, "row_uidx": row_uidx,
        "basis": rng.random((len(OFFSETS), N, 10)).astype(np.float32),
        "basis_rows": rng.random((len(OFFSETS), len(row_uidx), 10)).astype(np.float32),
        "W": (rng.standard_normal((10 * 2002, 3)) * 0.05).astype(np.float32),
        "bias": np.array([2.0, 2.1, 1.9], np.float32),
        "pw": rng.random((3, len(OFFSETS))).astype(np.float32),
        "windows": random_codes(rng, N * len(OFFSETS), 2000),
        "backbone": backbone, "samples": samples, "patch": _patch_starts(backbone, samples),
    }


def _patch_starts(backbone, samples):
    """(starts_f, starts_r), K = 8, as the cohort engine plans them."""
    phases_f = {(o // 4) % 4 for o in OFFSETS}
    phases_r = {((SPAN_LEN - 2000 - o) // 4) % 4 for o in OFFSETS}
    sf, sr = (np.zeros((len(samples), 8, 2), np.int32) for _ in range(2))
    for m, row in enumerate(samples):
        dp = np.nonzero(row != backbone)[0]
        pf = conv6_patch_sites_plan(dp, SPAN_LEN, phases_f, max_ranges=8)
        pr = conv6_patch_sites_plan((SPAN_LEN - 1 - dp)[::-1], SPAN_LEN, phases_r, max_ranges=8)
        if pf:
            sf[m, : len(pf)] = pf
        if pr:
            sr[m, : len(pr)] = pr
    return sf, sr


def _sink_arrays(call, n_rows, n_arrays):
    """Run ``call(sink)`` and assemble what the sink received into arrays,
    each row block once."""
    got, seen = {}, []
    lock = threading.Lock()

    def sink(start, real, *arrays):
        with lock:
            seen.append((start, real))
            got[start] = arrays

    assert call(sink) is None
    starts = sorted(seen)
    assert len(set(starts)) == len(starts) and sum(r for _s, r in starts) == n_rows
    return tuple(np.concatenate([got[s][i] for s, _r in starts]) for i in range(n_arrays))


# method: (batch size, call(runner, inputs)); the batches give one span,
# pair, gene or unique variant a chunk, so each call runs six chunks
METHODS = {
    "predict_codes": (2, lambda r, d: r.predict_codes(d["codes"])),
    "predict_codes_average_rc": (2, lambda r, d: r.predict_codes(d["codes"], average_rc=True)),
    "predict_codes_fwd_rc_concat": (4, lambda r, d: r.predict_codes_fwd_rc_concat(d["codes"])),
    "predict_span_codes_none": (5, lambda r, d: r.predict_span_codes(d["spans"], OFFSETS)),
    "predict_span_codes_average": (5, lambda r, d: r.predict_span_codes(d["spans"], OFFSETS, rc_mode="average")),
    "predict_span_codes_concat": (5, lambda r, d: r.predict_span_codes(d["spans"], OFFSETS, rc_mode="concat")),
    "predict_spans_project": (5, lambda r, d: r.predict_spans_project(d["spans"], OFFSETS, d["pw"])),
    "project_spans_backbone_patch": (5, lambda r, d: r.project_spans_backbone_patch(
        d["backbone"], d["samples"], *d["patch"], OFFSETS, d["pw"])),
    "predict_and_project": (5, lambda r, d: r.predict_and_project(d["windows"], d["pw"], len(OFFSETS))),
    "predict_span_pairs_diff": (10, lambda r, d: r.predict_span_pairs_diff(d["spans"], d["alt_spans"], OFFSETS)),
    "predict_span_pairs_diff_sink": (10, lambda r, d: _sink_arrays(
        lambda sink: r.predict_span_pairs_diff(d["spans"], d["alt_spans"], OFFSETS, sink=sink), N, 3)),
    "predict_span_pair_diffs_only": (10, lambda r, d: r.predict_span_pair_diffs_only(
        d["spans"], d["alt_spans"], OFFSETS)),
    "predict_span_pair_diffs_only_sink": (10, lambda r, d: _sink_arrays(
        lambda sink: r.predict_span_pair_diffs_only(d["spans"], d["alt_spans"], OFFSETS, sink=sink), N, 1)),
    "score_variant_spans": (10, lambda r, d: r.score_variant_spans(
        d["spans"], d["alt_spans"], OFFSETS, d["basis"], d["W"], d["bias"])),
    "score_variant_spans_packed": (5, lambda r, d: r.score_variant_spans_packed(
        d["spans"], MUTPOS, d["alt_alleles"], OFFSETS, d["basis"], d["W"], d["bias"])),
    "score_variant_spans_packed_rows": (5, lambda r, d: r.score_variant_spans_packed_rows(
        d["spans"], MUTPOS, d["alt_alleles"], OFFSETS, d["basis_rows"], d["row_uidx"], d["W"], d["bias"])),
    "score_variant_span_pairs_rows": (10, lambda r, d: r.score_variant_span_pairs_rows(
        d["spans"], d["alt_spans"], OFFSETS, d["basis_rows"], d["row_uidx"], d["W"], d["bias"])),
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("method", list(METHODS))
def test_depth_5_equals_depth_1_bit_for_bit(params, inputs, method, monkeypatch):
    batch, call = METHODS[method]
    chunks = []
    orig = trunner.BelugaRunner._run_pipelined

    def counted(self, jobs, write):
        def counting():
            for job in jobs:
                chunks.append(job[0])
                yield job

        return orig(self, counting(), write)

    monkeypatch.setattr(trunner.BelugaRunner, "_run_pipelined", counted)
    shallow = _as_tuple(call(_runner(params, 1, batch), inputs))
    assert len(chunks) >= N
    deep = _as_tuple(call(_runner(params, DEEP, batch), inputs))
    assert len(shallow) == len(deep)
    for s, d in zip(shallow, deep):
        assert s.dtype == d.dtype and np.isfinite(s).all()
        np.testing.assert_array_equal(d, s)


def test_predict_codes_at_depth_5_matches_jax(params, inputs):
    codes = inputs["codes"]
    got = _runner(params, DEEP, 2).predict_codes(codes)
    want = jrunner.BelugaRunner(params, batch_size=2, pipeline_depth=DEEP).predict_codes(codes)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predict_codes_fwd_rc_concat_matches_jax(params, inputs):
    codes = inputs["codes"][:4]
    got = _runner(params, DEEP, 2).predict_codes_fwd_rc_concat(codes)
    assert got.shape == (8, 2002)
    want = jrunner.BelugaRunner(params, batch_size=2, pipeline_depth=DEEP).predict_codes_fwd_rc_concat(codes)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_a_slow_sink_still_gets_every_row_once(params, inputs):
    """The sink of chunk 0 waits until chunk 2 has landed and chunk 1's
    sleeps, so later chunks land first; each row block still arrives once,
    with the rows of the in-memory call."""
    runner = _runner(params, DEEP, 10)
    want = runner.predict_span_pairs_diff(inputs["spans"], inputs["alt_spans"], OFFSETS)
    order, got = [], {}
    lock, third = threading.Lock(), threading.Event()

    def sink(start, real, ref, alt, diff):
        if start == 0:
            assert third.wait(WAIT_S)
        elif start == 1:
            time.sleep(0.2)
        elif start == 2:
            third.set()
        with lock:
            order.append(start)
            got[start] = (ref, alt, diff)

    runner.predict_span_pairs_diff(inputs["spans"], inputs["alt_spans"], OFFSETS, sink=sink)
    assert sorted(order) == list(range(N)) and order != sorted(order)
    for k, name in enumerate(("ref", "alt", "diff")):
        rows = np.concatenate([got[s][k] for s in range(N)])  # (N, 2[fwd|rc], S, M)
        np.testing.assert_array_equal(rows[:, 0], want[k][:N], err_msg=name)
        np.testing.assert_array_equal(rows[:, 1], want[k][N:], err_msg=name)


@pytest.fixture(scope="module")
def port_fa(tiny_genome):
    fa, _ = tiny_genome
    genome = FastaIndex(fa.path)
    yield genome
    genome.close()


def test_stream_span_rows_with_late_sinks_equals_in_memory(params, tiny_genome, port_fa, monkeypatch):
    """stream_span_rows at depth 5, one pair a chunk, the sink's first rows
    written late: the numpy "datasets" equal the in-memory path's arrays."""
    contig = tiny_genome[1]["chr1"]
    rows, _genes = serving_tables(contig)
    rows += [["chr1", p, ".", contig[p - 1], COMPLEMENT[contig[p - 1]]] for p in range(27000, 51000, 3000)]
    vcf = pd.DataFrame(rows)
    runner = _runner(params, DEEP, 2 * len(OFFSETS))
    mem = tchrom.compute_variant_chromatin_effects(vcf, port_fa, runner, None, maxshift=MAXSHIFT, keep_arrays=True,
                                                   verbose=False)
    chroms, pos = vcf.iloc[:, 0].astype(str).values, vcf.iloc[:, 1].astype(int).values
    refs, alts = vcf.iloc[:, 3].astype(str).values, vcf.iloc[:, 4].astype(str).values
    span_ok = tchrom._span_eligible(port_fa, chroms, pos, refs, alts, MAXSHIFT, 2000)
    assert span_ok.sum() >= N and not span_ok.all()
    orig = runner.predict_span_pairs_diff

    def late_first_rows(*a, sink, **kw):
        def slow(start, *arrays):
            if start == 0:
                time.sleep(0.2)
            sink(start, *arrays)

        return orig(*a, sink=slow, **kw)

    monkeypatch.setattr(runner, "predict_span_pairs_diff", late_first_rows)
    n = len(vcf)
    dsets = [{k: np.full((2 * n, 2002), np.nan, np.float32) for k in ("diff", "ref", "alt")} for _ in mem.shifts]
    tchrom.stream_span_rows(port_fa, runner, chroms, pos, refs, alts, mem.shifts, MAXSHIFT, 2000, span_ok, dsets)
    for si, s in enumerate(mem.shifts):
        for name, arr in zip(("diff", "ref", "alt"), mem.arrays[s]):
            np.testing.assert_array_equal(dsets[si][name], arr, err_msg=f"shift {s} {name}")


class Planted(RuntimeError):
    pass


def test_a_write_that_raises_makes_the_call_raise(params, inputs):
    runner = _runner(params, DEEP, 10)
    written = []

    def sink(start, real, *arrays):
        if start == 3:
            raise Planted(f"sink at chunk {start}")
        written.append(start)

    with pytest.raises(Planted, match="chunk 3"):
        runner.predict_span_pairs_diff(inputs["spans"], inputs["alt_spans"], OFFSETS, sink=sink)
    assert 3 not in written


def test_a_job_that_raises_makes_the_call_raise(params, inputs, monkeypatch):
    """A device step that fails (as a kernel launch that fails raises) on the
    fourth chunk: the call raises it after the chunks in flight are written."""
    runner = _runner(params, DEEP, 2)
    orig, calls = runner._forward, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise Planted("launch failed")
        return orig(*a, **kw)

    monkeypatch.setattr(runner, "_forward", failing)
    with pytest.raises(Planted, match="launch failed"):
        runner.predict_codes(inputs["codes"])
    assert len(calls) == 4


def _blocked_first_write(depth: int):
    """(jobs counter, write): the write of job 0 waits until ``depth`` jobs
    have been produced, or fails after WAIT_S."""
    produced, released = [], threading.Event()
    ran_ahead = []

    def write(start, real, host):
        if start == 0:
            ran_ahead.append(released.wait(WAIT_S))

    def on_job():
        produced.append(1)
        if len(produced) >= depth:
            released.set()

    return produced, ran_ahead, write, on_job


@pytest.mark.parametrize("depth", [2, 4])
def test_dispatch_runs_ahead_of_the_writes(params, depth):
    runner = _runner(params, depth, 2)
    produced, ran_ahead, write, on_job = _blocked_first_write(depth)

    def jobs():
        for i in range(3 * depth):
            on_job()
            yield i, 1, trunner._Landing((), None)

    runner._run_pipelined(jobs(), write)
    assert ran_ahead == [True] and len(produced) == 3 * depth


def test_a_method_dispatches_ahead_of_its_sink(params, inputs, monkeypatch):
    """The sink of chunk 0 is released only when predict_span_pairs_diff has
    computed ``pipeline_depth`` chunks; the call then completes with the
    rows of an unblocked call."""
    runner = _runner(params, 3, 10)
    want = runner.predict_span_pair_diffs_only(inputs["spans"], inputs["alt_spans"], OFFSETS)
    produced, ran_ahead, write, on_job = _blocked_first_write(3)
    orig = runner._pair_diff_wire

    def counted(*a, **kw):
        on_job()
        return orig(*a, **kw)

    monkeypatch.setattr(runner, "_pair_diff_wire", counted)
    got = {}

    def sink(start, real, diff):
        write(start, real, None)
        got[start] = diff

    runner.predict_span_pair_diffs_only(inputs["spans"], inputs["alt_spans"], OFFSETS, sink=sink)
    assert ran_ahead == [True]
    rows = np.concatenate([got[s] for s in range(N)])
    np.testing.assert_array_equal(rows[:, 0], want[:N])
    np.testing.assert_array_equal(rows[:, 1], want[N:])


def test_depth_1_writes_each_chunk_before_the_next_is_made(params):
    runner = _runner(params, 1, 2)
    events = []

    def jobs():
        for i in range(4):
            events.append(("job", i))
            yield i, 1, trunner._Landing((), None)

    runner._run_pipelined(jobs(), lambda s, r, h: events.append(("write", s)))
    assert events == [(k, i) for i in range(4) for k in ("job", "write")]


@pytest.mark.parametrize("workers", [1, 3])
def test_one_worker_writes_in_order_in_this_thread(params, monkeypatch, workers):
    monkeypatch.setattr(trunner.BelugaRunner, "FETCH_WORKERS", workers)
    runner = _runner(params, 3, 2)
    seen = []

    def jobs():
        for i in range(7):
            yield i, 1, trunner._Landing((), None)

    runner._run_pipelined(jobs(), lambda s, r, h: seen.append((s, threading.current_thread() is threading.main_thread())))
    assert sorted(s for s, _main in seen) == list(range(7))
    if workers == 1:
        assert seen == [(i, True) for i in range(7)]
    else:
        assert not any(main for _s, main in seen)


def test_depth_and_worker_defaults(params):
    assert trunner.BelugaRunner.FETCH_WORKERS == 3
    assert trunner.BelugaRunner(params, device="cpu").pipeline_depth == 4
    assert _runner(params, 0, 2).pipeline_depth == 1
    assert _runner(params, 6, 2).pipeline_depth == 6


@pytest.mark.parametrize("depth,blocks", [(1, [64, 36]), (10, [80, 20])])
def test_gene_block_follows_rows_depth_and_4(params, port_fa, monkeypatch, depth, blocks):
    """100 genes of one strand group at batch 400 (2 spans a chunk): blocks
    of max(2 x depth x 4, 64) genes."""
    runner = trunner.BelugaRunner(params, batch_size=400, device="cpu", pipeline_depth=depth)
    sizes = []

    def spy(spans, offsets, pos_weights):
        sizes.append(len(spans))
        return np.zeros((len(spans), pos_weights.shape[0] * 2002), np.float32)

    monkeypatch.setattr(runner, "predict_spans_project", spy)
    genes = [tfeat.GeneRecord(f"G{i}", "chr1", 30000, 1) for i in range(100)]
    tfeat.compute_gene_features(genes, port_fa, runner)
    assert sizes == blocks


def test_compute_features_cli_runs_at_depth_6(params, tiny_genome, tmp_path, monkeypatch):
    from expecto_tpu_torch.cli.compute_features import main as torch_cf
    from expecto_tpu_torch.models.convert import save_params_npz

    depths = []

    class Recorded(trunner.BelugaRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            depths.append(self.pipeline_depth)

    monkeypatch.setattr(trunner, "BelugaRunner", Recorded)
    fa, _ = tiny_genome
    pd.DataFrame({"id": ["G1"], "symbol": ["a"], "seqnames": ["chr1"], "strand": ["+"], "TSS": [30000],
                  "CAGE_representative_TSS": [30000], "type": ["protein_coding"]}).to_csv(tmp_path / "anno.csv",
                                                                                         index=False)
    save_params_npz(params, tmp_path / "beluga.npz")
    assert torch_cf([str(tmp_path / "anno.csv"), "--genome", str(fa.path), "--beluga_weights",
                     str(tmp_path / "beluga.npz"), "-o", str(tmp_path / "out"), "--device", "cpu"]) == 0
    assert depths == [6]
    assert np.load(tmp_path / "out" / "Xreducedall.2002.representative_tss_top.npy").shape == (1, 20020)
