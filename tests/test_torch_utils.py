"""The port's host utilities (expecto_tpu_torch/utils/{timing,profiling,
manifest}.py) vs the JAX package's, on the CPU: the stage timer with its
sync callable, StageLogger's JSON lines, the shard manifest's file format
and resume, and ``trace``'s Chrome trace (CPU activity here; the card's
kernels are checked by chip_smoke.py)."""

import io
import json
import time

import pytest
import torch

from expecto_tpu.utils import manifest as jmanifest
from expecto_tpu.utils import profiling as jprofiling
from expecto_tpu.utils import timing as jtiming
from expecto_tpu_torch.utils import manifest as tmanifest
from expecto_tpu_torch.utils import profiling as tprofiling
from expecto_tpu_torch.utils import timing as ttiming


@pytest.mark.parametrize("mod", [ttiming, jtiming], ids=["port", "jax"])
def test_timer_accumulates_stages_and_runs_sync_before_stopping(mod):
    timer, calls = mod.Timer(), []

    def sync():
        time.sleep(0.02)
        calls.append(1)

    for _ in range(2):
        with timer.stage("a", sync=sync):
            pass
    with timer.stage("b"):
        time.sleep(0.01)
    assert calls == [1, 1] and list(timer.stages) == ["a", "b"]
    assert timer.stages["a"] >= 0.04 and timer.stages["b"] >= 0.01
    text = timer.report()
    assert text.startswith("a: ") and " | b: " in text and text.endswith("s")


def test_timer_report_matches_jax():
    timers = [ttiming.Timer(), jtiming.Timer()]
    for t in timers:
        t.stages = {"load": 1.23456, "score": 0.5}
    assert timers[0].report() == timers[1].report() == "load: 1.235s | score: 0.500s"


def _logged(mod, **kw) -> list[dict]:
    stream = io.StringIO()
    log = mod.StageLogger(stream=stream, **kw)
    with log.stage("span", n_items=1000, unit="variants") as rec:
        rec["chunks"] = 3
    with log.stage("write"):
        pass
    with pytest.raises(RuntimeError):
        with log.stage("fails", n_items=5):
            raise RuntimeError("boom")
    return [json.loads(line) for line in stream.getvalue().splitlines()]


@pytest.mark.parametrize("kw", [{}, {"run_id": "r7"}], ids=["plain", "run_id"])
def test_stage_logger_lines_match_jax(kw):
    got, want = _logged(tprofiling, **kw), _logged(jprofiling, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the same keys in the same order
        assert {k: v for k, v in g.items() if k not in ("seconds", "per_sec")} == \
               {k: v for k, v in w.items() if k not in ("seconds", "per_sec")}
    assert got[0]["stage"] == "span" and got[0]["chunks"] == 3 and got[0]["unit"] == "variants"
    assert got[2]["stage"] == "fails" and got[2]["n"] == 5  # a failing stage still logs
    assert ("run_id" in got[1]) == bool(kw)


@pytest.mark.parametrize("writer,reader", [(tmanifest, jmanifest), (jmanifest, tmanifest)],
                         ids=["port_writes", "jax_writes"])
def test_manifest_resume_across_packages(tmp_path, writer, reader):
    """A run of one package writes the manifest and dies half-way; the other
    package resumes from it: the same pending, done and failed items, and
    the same file after the same calls."""
    path = tmp_path / "m" / "manifest.json"
    m = writer.ShardManifest(path, items=["g1", "g2", "g3", 4])
    m.mark_done("g1", output=str(tmp_path / "g1.h5"))
    (tmp_path / "g1.h5").write_text("x")
    m.mark_failed("g2", "oom")
    m.mark_done("g3", output=str(tmp_path / "missing.h5"))
    resumed = reader.ShardManifest(path, items=["g1", "g2", "g3", "4", "g5"])
    assert resumed.pending() == ["g2", "4", "g5"] and resumed.done() == ["g1", "g3"]
    assert not resumed.is_complete() and resumed.verify_outputs() == ["g3"]
    # the added item is on disk before any mark_done: a reader without items sees it
    assert writer.ShardManifest(path).pending() == ["g2", "4", "g5"]
    for item in resumed.pending():
        resumed.mark_done(item)
    assert reader.ShardManifest(path).is_complete()
    assert not path.with_suffix(".tmp").exists()


def test_manifest_files_equal_jax(tmp_path):
    for mod, tag in ((tmanifest, "port"), (jmanifest, "jax")):
        m = mod.ShardManifest(tmp_path / tag / "manifest.json", items=["a", "b"])
        m._state["a"] = {"status": "done", "output": "a.h5", "t": 1.0}  # fixed times: the files compare
        m._flush()
        mod.ShardManifest(tmp_path / tag / "manifest.json", items=["a", "b", "c"])
    assert (tmp_path / "port" / "manifest.json").read_bytes() == (tmp_path / "jax" / "manifest.json").read_bytes()


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    x = torch.randn(64, 64)
    with tprofiling.trace(str(tmp_path / "traces")):
        torch.matmul(x, x).relu()
    files = list((tmp_path / "traces").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::matmul" in names and "aten::relu" in names
    if not torch.cuda.is_available():
        assert not any(e.get("cat") == "kernel" for e in events)  # CPU activity only
