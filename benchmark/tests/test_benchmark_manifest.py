"""BENCHMARK.json against the benchmark's contract: names, units, keys, and
every entry resolving to its files; a cell added as files alone is found."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                               for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_only_their_keys_and_clean_names(section):
    names = [e["name"] for e in M[section]]
    assert len(set(names)) == len(names)
    for e in M[section]:
        required = KEYS[section] - ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert required <= set(e) <= KEYS[section], e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs_resolve_and_reduce_no_width():
    for c in M["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(path)
        cfg = json.load(open(path))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert cfg["peak"] in json.load(open(os.path.join(ROOT, "benchmark", "peaks.json")))["flops"]
        assert cfg["control"] in ("fp8", "tf32")
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_workloads_resolve():
    pairs = set()
    four = 0
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        cell = harness.find_cell(M, w["name"])
        assert os.path.isfile(harness.flow_path(cell.traffic["flow"]))
        assert os.path.isfile(harness.arrival_path(cell.traffic["arrival"]))
        limits = cell.cfg["limits"][cell.traffic["flow"]]
        assert limits and all(v > 0 for v in limits.values())
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
    assert four <= max(1, len(M["workloads"]) // 4)


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


def test_end_to_end_metrics_resolve_to_readers():
    for m in M["end_to_end"]:
        assert callable(harness.load_reader(m["name"]))


def test_per_layer_metrics_resolve_to_readers():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    layers = {}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)
        assert callable(harness.load_reader(m["name"]))
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"pipeline host", "runner and device", "kernels", "model step"}


def test_readers_return_nothing_to_read():
    from benchmark.flops import Work

    run = harness.Run(flow="none", cfg={"peak": "bf16"}, traffic={}, peaks={"flops": {"bf16": 1.0}, "hbm_bytes_per_s": 1.0},
                      work=Work(), calls=0, window_s=1.0, units=0)
    for m in M["per_layer"]:
        assert harness.load_reader(m["name"])(run) is None, m["name"]


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A new traffic mix of a new flow and arrival, a new end-to-end metric
    and a new per-layer metric, each added as a file and an entry: found
    without an edit to any file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(M))
    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic", "vcf-8192.json")))
    traffic.update(variants_per_call=1024, flow="score_small", arrival="burst")
    (root / "benchmark" / "traffic" / "vcf-1024.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "flows" / "score_small.py").write_text(
        "from .score import ScoreFlow\n\n\nclass Small(ScoreFlow):\n    pass\n\n\nFLOW = Small\n")
    (root / "benchmark" / "arrivals" / "burst.py").write_text(
        "def drive(call, seconds, traffic):\n    call(0)\n    return {'calls': 1, 'window_s': 1.0}\n")
    (root / "benchmark" / "metrics" / "score_calls.score.py").write_text(
        "def read(run):\n    return float(run.calls) if run.flow == 'score_small' else None\n")
    (root / "benchmark" / "metrics" / "latency_p95_ms.py").write_text(
        "def read(run):\n    return run.window.get('p95_ms')\n")
    m["workloads"].append({"name": "bf16-score-small", "config": "expecto-beluga-bf16", "traffic": "vcf-1024",
                           "chips": 1, "why": "smaller chunks"})
    m["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.1,
                            "source": "host_clock", "workloads": ["bf16-score-small"]})
    for e in m["end_to_end"]:
        if e["name"] == "variants_per_s.bf16":
            e["workloads"].append("bf16-score-small")
    m["per_layer"].append({"name": "score_calls.score", "unit": "calls", "better": "higher", "source": "host_clock",
                           "layer": "pipeline host", "moves": "variants_per_s.bf16",
                           "workloads": ["bf16-score-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    r = str(root)
    cell = harness.find_cell(harness.load_manifest(r), "bf16-score-small", r)
    assert cell.traffic["variants_per_call"] == 1024
    assert [p["name"] for p in cell.per_layer] == ["score_calls.score"]
    assert {e["name"] for e in cell.end_to_end} == {"variants_per_s.bf16", "latency_p95_ms", "setup_s"}
    assert cell.cfg["compute_dtype"] == "bfloat16"
    assert harness.flow_class("score_small", r).__name__ == "Small"
    assert harness.arrival_drive("burst", r)(lambda i: None, 1.0, {})["calls"] == 1
    run = type("R", (), {"flow": "score_small", "calls": 3, "window": {"p95_ms": 7.0}})()
    assert harness.load_reader("score_calls.score", r)(run) == 3.0
    assert harness.load_reader("latency_p95_ms", r)(run) == 7.0
