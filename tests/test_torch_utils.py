"""The port's host utilities (expecto_tpu_torch/utils/{profiling,
manifest}.py) vs the JAX package's, on the CPU: the shard manifest's file
format and resume, and ``trace``'s Chrome trace (CPU activity here; the
card's kernels are checked by chip_smoke.py). The spans ``trace`` also
writes are tested in tests/test_torch_tracing.py."""

import json

import pytest
import torch

from expecto_tpu.utils import manifest as jmanifest
from expecto_tpu_torch.utils import manifest as tmanifest
from expecto_tpu_torch.utils import profiling as tprofiling


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
