"""On the card (marked gpu; they skip without one):

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests

The program at the published widths, on fewer variants, genes or rows than
a cell's calls, against the reference and the control, and a traced run of
each cell at that size."""

from __future__ import annotations

import tempfile

import pytest

from benchmark import harness

SMALL = {
    "bf16-score": {"variants_per_call": 512, "sample_max": 64},
    "fp32-score": {"variants_per_call": 512, "sample_max": 64},
    "bf16-genes": {"genes_per_call": 32, "sample_per_call": 8, "sample_max": 8},
    "fp32-train218": {"rows": 4096},
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_within_limits_and_control_outside(cell, cuda_device, bench_root):
    c = harness.find_cell(harness.load_manifest(bench_root), cell, bench_root)
    tr = {**c.traffic, **SMALL[cell]}
    with tempfile.TemporaryDirectory() as work:
        fl = harness.flow_class(tr["flow"])(c.cfg, tr, 2**31 + 7, cuda_device, work,
                                            harness.ROOT + "/build/benchmark")
        fl.setup()
        fl.prepare(2)
        for i in range(2):
            fl.call(i)
        fl.free()
        program = fl.check()
        control = fl.check(control=c.cfg["control"])
    limits = c.cfg["limits"][tr["flow"]]
    assert all(program[k] <= limits[k] for k in limits), (program, limits)
    assert any(control[k] > limits[k] for k in limits), (control, limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_on_card(cell, cuda_device, bench_root):
    r = harness.run_cell(cell, 2**31 + 8, 2.0, True, root=bench_root, traffic_override=SMALL[cell],
                         cache_dir=harness.ROOT + "/build/benchmark")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name, m in r["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
