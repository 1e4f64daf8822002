"""The metrics read from the program's own spans (``metrics/_program.py``):
each reader reads a CPU traced run of its flow, the formulas on planted
spans, and nothing to read where the program records no spans or too few
calls."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import _program

from .conftest import tiny

PROGRAM_SPAN_METRICS = {
    "bf16-score": ("pipeline_self_ms.score_bf16", "starved_ms.score_bf16"),
    "fp32-score": ("pipeline_self_ms.score_fp32", "starved_ms.score_fp32"),
    "fp32-train218": ("x_upload_ms.train", "rounds_ms.train"),
}


def test_every_program_span_metric_is_listed_here():
    m = harness.load_manifest()
    named = {p["name"] for p in m["per_layer"] if p["source"] == "program_span"}
    assert named == {n for names in PROGRAM_SPAN_METRICS.values() for n in names}
    for cell, names in PROGRAM_SPAN_METRICS.items():
        per_layer = {p["name"] for p in harness.find_cell(m, cell).per_layer}
        assert set(names) <= per_layer, cell


@pytest.mark.parametrize("cell", sorted(PROGRAM_SPAN_METRICS))
def test_a_traced_run_reads_them(cell, bench_root, cache_dir):
    cfg, tr = tiny(cell)
    r = harness.run_cell(cell, 2**31 + 41, 0.3, True, root=bench_root, device="cpu", cfg_override=cfg,
                         traffic_override=tr, cache_dir=cache_dir)
    assert r["correct"], r["checks"]
    got = {n: r["metrics"][n]["value"] for n in PROGRAM_SPAN_METRICS[cell] if n in r["metrics"]}
    assert set(got) == set(PROGRAM_SPAN_METRICS[cell]), r["metrics"]
    assert all(v > 0 for v in got.values()), got
    if cell.endswith("score"):
        flow = cell.split("-")[0]
        host = r["metrics"][f"pipeline_host_ms.score_{flow}"]["value"]
        # both leave out the runner's methods: the harness's timers sit just
        # outside the spans, the call's wall just outside the root span
        assert got[f"pipeline_self_ms.score_{flow}"] <= host * 1.5 + 50, (got, host)


def _span(name, start, end, *, id_, parent=None, root=None, device_ms=None):
    return SimpleNamespace(name=name, start_ns=start * 10**6, end_ns=end * 10**6, id=id_, parent=parent,
                           root=id_ if root is None else root,
                           device_ms=(end - start) if device_ms is None else device_ms)


def _run(flow, calls):
    return SimpleNamespace(flow=flow, trace=object(), trace_calls=calls)


def _planted_score_call(t0, id0):
    """A 100-ms ``sed.score`` call at ``t0`` ms: two method spans
    (10-40 ms and 60-80 ms, the second nested in a stage span), chunks in
    flight over 15-35, 30-40 and 65-80 ms."""
    root = _span("sed.score", t0, t0 + 100, id_=id0)
    kids = [
        _span("sed.align", t0, t0 + 5, id_=id0 + 1, parent=id0, root=id0),
        _span("runner.score_variant_spans_packed_rows", t0 + 10, t0 + 40, id_=id0 + 2, parent=id0, root=id0),
        _span("runner.plan", t0 + 10, t0 + 15, id_=id0 + 3, parent=id0 + 2, root=id0),
        _span("runner.in_flight", t0 + 15, t0 + 35, id_=id0 + 4, parent=id0 + 2, root=id0),
        _span("runner.in_flight", t0 + 30, t0 + 40, id_=id0 + 5, parent=id0 + 2, root=id0),
        _span("sed.windows", t0 + 55, t0 + 85, id_=id0 + 6, parent=id0, root=id0),
        _span("runner.predict_codes", t0 + 60, t0 + 80, id_=id0 + 7, parent=id0 + 6, root=id0),
        _span("runner.in_flight", t0 + 65, t0 + 80, id_=id0 + 8, parent=id0 + 7, root=id0),
    ]
    return [*kids, root]


def test_formulas_on_planted_spans(monkeypatch):
    old = _planted_score_call(0, 100)  # a call before the stretch: left out
    recorded = old + _planted_score_call(1000, 200) + _planted_score_call(2000, 300)
    monkeypatch.setattr(_program, "_recorded", lambda: recorded)
    run = _run("score", 2)
    assert _program.self_ms(run, "score", "sed.score") == pytest.approx(100 - 30 - 20)
    assert _program.starved_ms(run, "score", "sed.score") == pytest.approx(100 - 25 - 15)
    assert _program.self_ms(_run("score", 3), "score", "sed.score") == pytest.approx(50)
    assert _program.self_ms(_run("score", 4), "score", "sed.score") is None  # fewer roots than calls
    assert _program.self_ms(_run("train", 2), "score", "sed.score") is None
    assert _program.self_ms(SimpleNamespace(flow="score", trace=None, trace_calls=2), "score", "sed.score") is None

    train = [
        _span("gblinear.upload", 0, 300, id_=11, parent=10, root=10, device_ms=290.0),
        _span("gblinear.rounds", 310, 950, id_=12, parent=10, root=10, device_ms=620.0),
        _span("gblinear.train", 0, 960, id_=10),
        _span("gblinear.upload", 1000, 1300, id_=21, parent=20, root=20, device_ms=310.0),
        _span("gblinear.rounds", 1310, 1950, id_=22, parent=20, root=20, device_ms=640.0),
        _span("gblinear.train", 1000, 1960, id_=20),
    ]
    monkeypatch.setattr(_program, "_recorded", lambda: train)
    run = _run("train", 2)
    assert _program.device_ms(run, "train", "gblinear.train", "gblinear.upload") == pytest.approx(300.0)
    assert _program.device_ms(run, "train", "gblinear.train", "gblinear.rounds") == pytest.approx(630.0)
    assert _program.device_ms(run, "train", "gblinear.train", "gblinear.fetch") is None


def test_nothing_to_read_from_a_program_without_spans(monkeypatch):
    """A program whose ``utils/profiling.py`` has no span recorder (the
    port before its spans) gives every reader nothing, with a trace."""
    from expecto_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    for cell, names in PROGRAM_SPAN_METRICS.items():
        run = _run("train" if cell == "fp32-train218" else "score", 1)
        for name in names:
            assert harness.load_reader(name)(run) is None, name
