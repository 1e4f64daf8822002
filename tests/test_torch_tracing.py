"""The port's spans (expecto_tpu_torch/utils/profiling.py) on the CPU: off
without a profiler, the tree they record under one (parents, roots, threads,
counts), their ranges on the profiler's own clock, the recorder's bound, the
score path's ``sed.*`` and ``runner.*`` spans, the trainer's ``gblinear.*``
spans, outputs bit-equal with and without a profiler, and the CLIs'
``--trace_dir``."""

import json
import threading

import numpy as np
import pandas as pd
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from expecto_tpu_torch.io.xgb import save_xgb07_binary
from expecto_tpu_torch.models.convert import save_params_npz
from expecto_tpu_torch.models.gblinear import GBLinearModel, GBLinearParams, train_gblinear_multi_sharded
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline.sed import score_sed_serving
from expecto_tpu_torch.utils import profiling
from torch_port_common import narrow_params, random_codes, serving_tables, single_torch_thread, write_models  # noqa: F401

SED_STAGES = {"sed.align", "sed.models", "sed.basis", "sed.eligible", "sed.snv_spans", "sed.indel_spans",
              "sed.windows", "sed.table"}
RUNNER_PARTS = {"runner.plan", "runner.produce", "runner.in_flight", "runner.wait", "runner.write"}
HP = GBLinearParams(num_round=4, block_size=16)


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, the spans it recorded,
    the profiler)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, profiling.spans(), prof


@pytest.fixture(scope="module")
def params():
    return narrow_params(seed=5)


@pytest.fixture(scope="module")
def tables(tiny_genome):
    _fa, contigs = tiny_genome
    rows, gene_rows = serving_tables(contigs["chr1"])
    return pd.DataFrame(rows), pd.DataFrame(gene_rows)


@pytest.fixture(scope="module")
def model_paths(tmp_path_factory):
    return write_models(tmp_path_factory.mktemp("models"), save_xgb07_binary, GBLinearModel, n_models=2)


def _training_set(seed: int = 3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((96, 40)).astype(np.float32)
    Y = (X[:, :3] @ rng.standard_normal((3, 5)) + 2.0).astype(np.float32)
    return X, Y


def test_without_a_profiler_a_span_is_the_shared_no_op():
    profiling.reset()
    s = profiling.span("a", device=torch.device("cpu"), rows=3)
    assert s is profiling.OFF and not s
    with profiling.span("a") as inner:
        assert inner is profiling.OFF
        profiling.count(rows=1)
        assert profiling.current() is profiling.OFF
        assert profiling.current().child("b") is profiling.OFF
    flight = profiling.begin("b")
    flight.add(rows=2)
    flight.end()
    assert flight is profiling.OFF
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_nesting_parents_roots_and_counts_under_a_cpu_profiler():
    def nested():
        with profiling.span("outer", rows=2):
            with profiling.span("inner") as inner:
                profiling.count(bytes_up=10)
                profiling.count(bytes_up=5)
                with profiling.span("leaf"):
                    pass
            with profiling.span("second"):
                pass
        with profiling.span("another_root"):
            pass
        return inner

    inner, spans, _prof = _profiled(nested)
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["leaf", "inner", "second", "outer", "another_root"]  # the order they closed
    outer = by["outer"]
    assert outer.parent is None and outer.root == outer.id and outer.counts == {"rows": 2}
    assert by["inner"].parent == outer.id and by["second"].parent == outer.id
    assert by["leaf"].parent == by["inner"].id
    assert {by[n].root for n in ("inner", "second", "leaf")} == {outer.id}
    assert by["another_root"].parent is None and by["another_root"].root == by["another_root"].id
    assert inner is by["inner"] and inner.counts == {"bytes_up": 15}
    assert outer.start_ns <= by["inner"].start_ns <= by["leaf"].start_ns <= by["leaf"].end_ns <= outer.end_ns
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.thread == threading.get_native_id() for s in spans)


def test_spans_lie_on_the_profilers_clock():
    """Each span's ``record_function`` range is in the profiler's events,
    and the span's start and end lie within 1 ms of the range's: the same
    host clock."""

    def work():
        x = torch.randn(64, 64)
        for i in range(3):
            with profiling.span(f"step{i}"):
                with profiling.span(f"mm{i}"):
                    x = torch.matmul(x, x).tanh()
        return x

    _profiled(work)  # the profiler's first start warms its clocks
    _x, spans, prof = _profiled(work)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CPU}
    assert len(spans) == 6
    for s in spans:
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000, s.name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000, s.name
        assert s.device_ms == s.host_ms > 0  # no CUDA events on the CPU


def test_a_span_begun_here_ends_on_another_thread():
    def work():
        with profiling.span("parent") as parent:
            flight = profiling.begin("flight", rows=4)
            done = threading.Event()

            def worker():
                flight.end()
                with parent.child("written", rows=1):
                    pass
                done.set()

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert done.is_set()
        return t.native_id

    worker_tid, spans, _prof = _profiled(work)
    by = {s.name: s for s in spans}
    assert by["flight"].parent == by["parent"].id and by["flight"].counts == {"rows": 4}
    assert by["flight"].thread == threading.get_native_id()  # begun here
    assert by["written"].parent == by["parent"].id and by["written"].root == by["parent"].id
    assert by["written"].thread == worker_tid


def test_the_recorder_keeps_its_bound_and_counts_what_it_drops():
    profiling.reset(limit=5)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(8):
                with profiling.span(f"s{i}"):
                    pass
        assert [s.name for s in profiling.spans()] == [f"s{i}" for i in range(3, 8)]  # the newest
        assert profiling.dropped() == 3
    finally:
        profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("workers", [3, 1], ids=["pool", "in_order"])
def test_runner_chunks_write_under_their_method_span(params, workers):
    """``predict_codes`` over 5 chunks: one ``runner.in_flight`` and
    ``runner.write`` a chunk and a ``runner.produce`` a step of the chunk
    generator (the sixth finds it done), each under the method's span (the
    writes from the workers of the pool, or in order here), and the
    chunks' rows and bytes counted."""
    runner = BelugaRunner(params, batch_size=4, device="cpu", pipeline_depth=2)
    runner.FETCH_WORKERS = workers
    codes = random_codes(np.random.default_rng(0), 18, 2000)
    out, spans, _prof = _profiled(lambda: runner.predict_codes(codes))
    method = [s for s in spans if s.name == "runner.predict_codes"]
    assert len(method) == 1 and method[0].parent is None
    m = method[0]
    kids = [s for s in spans if s.root == m.id and s is not m]
    names = [s.name for s in kids]
    assert names.count("runner.plan") == 1
    for part, steps in (("runner.in_flight", 5), ("runner.produce", 6), ("runner.write", 5)):
        assert names.count(part) == steps, part
        assert all(s.parent == m.id for s in kids if s.name == part)
    writes = [s for s in kids if s.name == "runner.write"]
    assert sorted(s.counts["rows"] for s in writes) == [2, 4, 4, 4, 4]
    assert sum(s.counts["bytes_down"] for s in writes) == out.nbytes
    produced = [s for s in kids if s.name == "runner.produce"]
    assert sum(s.counts.get("bytes_up", 0) for s in produced) == codes.nbytes
    assert [s.counts.get("rows") for s in produced] == [4, 4, 4, 4, 2, None]
    if workers > 1:
        assert all(s.thread != m.thread for s in writes)
        assert names.count("runner.wait") >= 1
    else:
        assert all(s.thread == m.thread for s in writes)
    for s in kids:
        assert m.start_ns <= s.start_ns <= s.end_ns <= m.end_ns, s.name


@pytest.mark.parametrize("method", ["score_variant_spans_packed_rows", "score_variant_span_pairs_rows"])
def test_produce_spans_count_pack4_for_the_n_dense_chunks(params, method):
    """Five unique variants, one a chunk, the second and fourth spans
    N-dense (2,000 N, past a budget of 1,000): their ``runner.produce``
    steps, and only theirs, carry ``pack4`` 1; the plan packs nothing."""
    rng = np.random.default_rng(6)
    span_len, offsets = 2800, (0, 200, 400, 600, 800)
    spans = random_codes(rng, 5, span_len)
    spans[[1, 3], :2000] = 4
    row_uidx = np.array([0, 1, 1, 2, 3, 4])
    basis = rng.random((len(offsets), len(row_uidx), 10)).astype(np.float32)
    W, bias = (rng.standard_normal((10 * 2002, 2)) * 0.05).astype(np.float32), np.zeros(2, np.float32)
    pairs = method == "score_variant_span_pairs_rows"
    runner = BelugaRunner(params, batch_size=len(offsets) * (2 if pairs else 1), device="cpu")
    runner.PACK2_SIDE_BUDGET = 1000
    if pairs:
        call = lambda: runner.score_variant_span_pairs_rows(spans, random_codes(rng, 5, span_len), offsets, basis,
                                                            row_uidx, W, bias)
    else:
        alt = np.full((5, 1), -1, np.int8)
        call = lambda: runner.score_variant_spans_packed_rows(spans, 1399, alt, offsets, basis, row_uidx, W, bias)
    _out, spans_, _prof = _profiled(call)
    produced = [s for s in spans_ if s.name == "runner.produce"]
    assert [s.counts.get("pack4") for s in produced] == [None, 1, None, 1, None, None]  # the sixth finds it done
    plan = next(s for s in spans_ if s.name == "runner.plan")
    assert "pack4" not in plan.counts
    assert plan.counts["bytes_up"] == W.nbytes + bias.nbytes


def test_score_sed_serving_spans(tiny_genome, params, tables, model_paths):
    """A scoring call: one ``sed.score`` root over every stage span, the
    three runner methods of the fixture's routes, and one
    ``runner.in_flight`` a chunk of each (the chunks counted by their
    writes)."""
    fa, _ = tiny_genome
    vcf, gene = tables
    runner = BelugaRunner(params, batch_size=5, device="cpu")
    _df, spans, _prof = _profiled(lambda: score_sed_serving(vcf, gene, fa, runner, model_paths, maxshift=400))
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["sed.score"]
    root = roots[0]
    assert all(s.root == root.id for s in spans)
    stages = [s for s in spans if s.name.startswith("sed.") and s is not root]
    assert {s.name for s in stages} == SED_STAGES and len(stages) == len(SED_STAGES)
    assert all(s.parent == root.id for s in stages)
    methods = {s.id: s for s in spans if s.name.startswith("runner.") and s.name not in RUNNER_PARTS}
    assert sorted(s.name for s in methods.values()) == [
        "runner.predict_codes", "runner.score_variant_span_pairs_rows", "runner.score_variant_spans_packed_rows"]
    windows = next(s for s in stages if s.name == "sed.windows")
    for m in methods.values():
        assert m.parent == (windows.id if m.name == "runner.predict_codes" else root.id)
        parts = [s for s in spans if s.parent == m.id]
        flights = [s for s in parts if s.name == "runner.in_flight"]
        writes = [s for s in parts if s.name == "runner.write"]
        assert len(flights) == len(writes) >= 1
        assert sum(s.counts["rows"] for s in flights) == sum(s.counts["rows"] for s in writes)
        plan = [s for s in parts if s.name == "runner.plan"]
        assert len(plan) == 1 and plan[0].end_ns <= min(s.start_ns for s in flights)
    # the packed path's model weights go up in its plan, before any chunk
    packed = next(m for m in methods.values() if m.name == "runner.score_variant_spans_packed_rows")
    plan = next(s for s in spans if s.parent == packed.id and s.name == "runner.plan")
    assert plan.counts["bytes_up"] >= 10 * 2002 * 2 * 4


def test_multi_sweep_spans():
    """A K-model sweep: ``gblinear.train`` over ``gblinear.upload``,
    ``gblinear.state``, ``gblinear.rounds`` (a ``gblinear_round`` a
    round) and ``gblinear.fetch``; on the CPU the device time is the host
    time."""
    X, Y = _training_set()
    _res, spans, _prof = _profiled(lambda: train_gblinear_multi_sharded(X, Y, HP, device="cpu"))
    root = next(s for s in spans if s.name == "gblinear.train")
    assert root.parent is None and root.counts == {"rows": 96}
    assert all(s.root == root.id for s in spans)
    by = {s.name: s for s in spans}
    for name in ("gblinear.upload", "gblinear.state", "gblinear.rounds", "gblinear.fetch"):
        assert by[name].parent == root.id, name
        assert by[name].device_ms == by[name].host_ms > 0, name
    assert by["gblinear.upload"].counts == {"rows": 96, "bytes_up": X.nbytes}
    rounds = [s for s in spans if s.name == "gblinear_round"]
    assert len(rounds) == HP.num_round and all(s.parent == by["gblinear.rounds"].id for s in rounds)
    assert by["gblinear.upload"].end_ns <= by["gblinear.state"].start_ns <= by["gblinear.rounds"].start_ns
    assert by["gblinear.rounds"].end_ns <= by["gblinear.fetch"].start_ns


def test_outputs_bit_equal_with_and_without_a_profiler(tiny_genome, params, tables, model_paths):
    fa, _ = tiny_genome
    vcf, gene = tables
    runner = BelugaRunner(params, batch_size=5, device="cpu")
    X, Y = _training_set(seed=4)

    def both():
        return (score_sed_serving(vcf, gene, fa, runner, model_paths, maxshift=400),
                train_gblinear_multi_sharded(X, Y, HP, device="cpu"))

    plain_df, plain_fit = both()
    (traced_df, traced_fit), spans, _prof = _profiled(both)
    assert spans
    pd.testing.assert_frame_equal(traced_df, plain_df, check_exact=True)
    assert np.array_equal(traced_fit.weights, plain_fit.weights)
    assert np.array_equal(traced_fit.biases, plain_fit.biases)


def _read_trace_dir(path):
    traces, lines = sorted(path.glob("trace_*.json")), sorted(path.glob("spans_*.jsonl"))
    assert len(traces) == len(lines) == 1
    assert traces[0].name[len("trace_"):-len(".json")] == lines[0].name[len("spans_"):-len(".jsonl")]
    events = json.loads(traces[0].read_text())["traceEvents"]
    return {e.get("name") for e in events}, [json.loads(line) for line in lines[0].read_text().splitlines()]


def test_score_cli_trace_dir_writes_the_trace_and_the_spans(tmp_path, tiny_genome, tables, model_paths, params):
    from expecto_tpu_torch.cli.score import main

    fa, _ = tiny_genome
    vcf, gene = tables
    vcf.to_csv(tmp_path / "in.vcf", sep="\t", header=False, index=False)
    gene.to_csv(tmp_path / "genes.tsv", sep="\t", header=False, index=False)
    save_params_npz(params, tmp_path / "beluga.npz")
    profiling.reset()
    assert main([str(tmp_path / "in.vcf"), "--geneFile", str(tmp_path / "genes.tsv"), "--model_save_file",
                 model_paths[0], "--genome", str(fa.path), "--beluga_weights", str(tmp_path / "beluga.npz"),
                 "--maxshift", "400", "--batchsize", "8", "--fp32", "--device", "cpu",
                 "--output", str(tmp_path / "out.csv"), "--trace_dir", str(tmp_path / "trace")]) == 0
    names, lines = _read_trace_dir(tmp_path / "trace")
    assert SED_STAGES | {"sed.score", "runner.plan", "runner.produce"} <= names
    spans = {line["name"] for line in lines}
    assert SED_STAGES | {"sed.score", "runner.in_flight", "runner.write"} <= spans
    assert {"name", "id", "parent", "root", "thread", "start_ns", "end_ns", "host_ms", "device_ms",
            "counts"} == set(lines[0])
    assert (tmp_path / "out.csv").exists()


def test_train_cli_trace_dir_writes_the_trace_and_the_spans(tmp_path):
    from expecto_tpu_torch.cli.train import main

    rng = np.random.default_rng(1)
    n, f = 60, 20
    X = rng.standard_normal((n, f)).astype(np.float32)
    np.save(tmp_path / "X.npy", X)
    chroms = np.array(["chr1", "chr2", "chr8", "chrX"])[np.arange(n) % 4]
    pd.DataFrame({"id": [f"g{i}" for i in range(n)], "seqnames": chroms, "type": "protein_coding"}).to_csv(
        tmp_path / "anno.csv", index=False)
    pd.DataFrame({"a": X[:, 0] + 3.0, "b": X[:, 1] + 3.0}).to_csv(tmp_path / "exp.csv", index=False)
    profiling.reset()
    assert main(["--targetIndex", "1", "--bootstrap_seeds", "2", "--num_round", "3", "--expFile",
                 str(tmp_path / "exp.csv"), "--inputFile", str(tmp_path / "X.npy"), "--annoFile",
                 str(tmp_path / "anno.csv"), "--device", "cpu", "--output_dir", str(tmp_path / "models"),
                 "--trace_dir", str(tmp_path / "trace")]) == 0
    names, lines = _read_trace_dir(tmp_path / "trace")
    assert {"gblinear.train", "gblinear.upload", "gblinear.rounds", "gblinear_round"} <= names
    assert [line["name"] for line in lines].count("gblinear_round") == 3
    assert {"gblinear.state", "gblinear.fetch"} <= {line["name"] for line in lines}
