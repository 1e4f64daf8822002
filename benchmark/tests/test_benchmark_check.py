"""The check at CPU size: the port agrees with the plain reference in every
cell, the control (the reference in the configuration's lower precision)
comes out wrong, and a run with the timed path broken underneath reports
``correct`` false."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness

from .conftest import FLOW_OF, tiny

CELLS = sorted(FLOW_OF)


def _run(cell, root, cache_dir, patch=None, trace=False, seed=2**31 + 99):
    cfg, tr = tiny(cell)
    return harness.run_cell(cell, seed, 0.3, trace, root=root, device="cpu", cfg_override=cfg, traffic_override=tr,
                            patch=patch, cache_dir=cache_dir)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_port_agrees_with_reference(cell, trace, bench_root, cache_dir):
    r = _run(cell, bench_root, cache_dir, trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    metrics = r["metrics"]
    if trace:
        names = {m["name"] for m in harness.find_cell(harness.load_manifest(bench_root), cell, bench_root).per_layer}
        assert set(metrics) <= names
        assert any(n.startswith("device_idle_pct.") for n in metrics) and any(n.startswith("mfu.") for n in metrics)
        assert r["device"]["window_s"] > 0
    else:
        assert "setup_s" in metrics and len(metrics) == 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, bench_root, cache_dir):
    """The reference in the configuration's lower precision, put in the
    program's place, fails one of the cell's limits."""
    c = harness.find_cell(harness.load_manifest(bench_root), cell, bench_root)
    cfg_o, tr_o = tiny(cell)
    cfg, tr = {**c.cfg, **cfg_o}, {**c.traffic, **tr_o}
    fl = harness.flow_class(tr["flow"])(cfg, tr, 4321, torch.device("cpu"), str(cache_dir), str(cache_dir))
    fl.setup()
    fl.prepare(2)
    for i in range(2):
        fl.call(i)
    fl.free()
    program = fl.check()
    control = fl.check(control=cfg["control"])
    limits = cfg["limits"][tr["flow"]]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), (control, limits)


def _scale_sed(method, factor):
    def wrapped(*a, **k):
        R, A, S = method(*a, **k)
        return R, R + S * factor, S * factor

    return wrapped


def _half_left_out(method):
    """Outputs of the first half of the rows stand in for the second's."""

    def wrapped(*a, **k):
        out = method(*a, **k)
        arrays = out if isinstance(out, tuple) else (out,)
        for x in arrays:
            h = (len(x) + 1) // 2
            x[h:] = x[: len(x) - h]
        return out

    return wrapped


def _score_fault(kind):
    """``altered``: every row's SED x 1.5; ``snv``: only the SNV path's
    ALT made equal to REF, its SED 0 (indels untouched); ``half``: half the
    rows left out."""

    def patch(fl):
        if kind == "snv":
            fl.runner.score_variant_spans_packed_rows = _scale_sed(fl.runner.score_variant_spans_packed_rows, 0.0)
            return
        for name in ("score_variant_spans_packed_rows", "score_variant_span_pairs_rows"):
            method = getattr(fl.runner, name)
            setattr(fl.runner, name, _scale_sed(method, 1.5) if kind == "altered" else _half_left_out(method))

    return patch


def _gene_fault(kind):
    def patch(fl):
        method = fl.runner.predict_spans_project
        if kind == "altered":
            fl.runner.predict_spans_project = lambda *a, **k: method(*a, **k) * np.float32(1.5)
        else:
            fl.runner.predict_spans_project = _half_left_out(method)

    return patch


def _train_fault(kind):
    def patch(fl):
        train = fl._train

        def unchanged(X, Y):
            res = train(X, Y)
            res.weights[:] = 0.0
            res.biases[:] = 0.0
            return res

        def half_rows(X, Y):
            h = len(X) // 2
            return train(X[:h], Y[:h])

        warm_x = fl.X.copy()

        def stale(X, Y):
            # X as the warm call saw it, as a device copy cached by the
            # array's identity would keep it
            return train(warm_x, Y)

        fl._train = {"unchanged": unchanged, "half": half_rows, "stale": stale}[kind]

    return patch


FAULTS = [("bf16-score", _score_fault, "altered"), ("fp32-score", _score_fault, "altered"),
          ("bf16-score", _score_fault, "half"), ("fp32-score", _score_fault, "half"),
          ("bf16-score", _score_fault, "snv"), ("fp32-score", _score_fault, "snv"),
          ("bf16-genes", _gene_fault, "altered"), ("bf16-genes", _gene_fault, "half"),
          ("fp32-train218", _train_fault, "unchanged"), ("fp32-train218", _train_fault, "half"),
          ("fp32-train218", _train_fault, "stale")]


@pytest.mark.parametrize("cell,fault,kind", FAULTS, ids=[f"{c}-{k}" for c, _f, k in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, kind, bench_root, cache_dir):
    r = _run(cell, bench_root, cache_dir, patch=fault(kind))
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_pool_covers_the_window_at_four_times_the_warm_pace():
    assert harness.pool_calls(51, 2.0) == 103
    assert harness.pool_calls(10, 0.5) == 81


def test_a_call_past_the_inputs_made_in_set_up_raises(bench_root, cache_dir):
    from benchmark.flows import PoolExhausted

    c = harness.find_cell(harness.load_manifest(bench_root), "bf16-genes", bench_root)
    cfg_o, tr_o = tiny("bf16-genes")
    fl = harness.flow_class("genes")({**c.cfg, **cfg_o}, {**c.traffic, **tr_o}, 7, torch.device("cpu"),
                                     str(cache_dir), str(cache_dir))
    fl.setup()
    fl.prepare(1)
    fl.call(0)
    with pytest.raises(PoolExhausted):
        fl.call(1)
    fl.free()


def test_each_training_call_changes_x_in_place(cache_dir):
    """Every call flips rows of the same host array, so a copy of X kept
    from an earlier call is stale."""
    c = harness.find_cell(harness.load_manifest(), "fp32-train218")
    cfg_o, tr_o = tiny("fp32-train218")
    fl = harness.flow_class("train")({**c.cfg, **cfg_o}, {**c.traffic, **tr_o}, 7, torch.device("cpu"),
                                     str(cache_dir), str(cache_dir))
    fl.setup()
    X = fl.X
    before = X.copy()
    fl.call(0)
    assert fl.X is X
    changed = np.flatnonzero(np.any(X != before, axis=1))
    assert np.array_equal(changed, fl.flipped(0)) and len(changed) == tr_o.get("flip_rows", c.traffic["flip_rows"])
    assert not np.array_equal(fl.flipped(0), fl.flipped(1))
    fl.free()
