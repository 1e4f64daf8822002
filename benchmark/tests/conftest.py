"""Shared fixtures of the benchmark's tests: narrow CPU sizes of each cell
(the published widths stay on the card) and the card check."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import harness

TINY_BELUGA = {"conv_channels": [8, 8, 8, 8, 8, 8], "fc1_out": 16}
TINY_GENOME = {"contigs": 2, "contig_len": 300000, "n_runs_per_mb": 20, "n_run_len": [50, 500]}
TINY_TRAFFIC = {
    "score": {"variants_per_call": 40, "genome": TINY_GENOME, "sample_snv": 6, "sample_indel": 3, "sample_max": 16,
              "trace_calls": 1},
    "genes": {"genes_per_call": 6, "genome": TINY_GENOME, "sample_per_call": 6, "sample_max": 12, "trace_calls": 1},
    "train": {"rows": 300, "trace_calls": 1},
}
TINY_TRAIN = {"tracks": 30, "gblinear": {"eta": 0.01, "reg_lambda": 100.0, "reg_alpha": 0.0, "num_round": 5,
                                         "block_size": 64}}
FLOW_OF = {"bf16-score": "score", "fp32-score": "score", "bf16-genes": "genes", "fp32-train218": "train"}


def tiny(cell: str) -> tuple[dict, dict]:
    """(configuration override, traffic override) of ``cell`` at CPU size."""
    flow = FLOW_OF[cell]
    return (TINY_TRAIN if flow == "train" else TINY_BELUGA), TINY_TRAFFIC[flow]


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card: python -m pytest -m gpu benchmark/tests)")
    return torch.device("cuda", 0)


@pytest.fixture
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench-cache"))


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    """A checkout's root whose BENCHMARK.json is the repository's with the
    entries of ``left_out.json`` added: every flow runs in the tests,
    including a cell that waits outside the manifest."""
    root = tmp_path_factory.mktemp("checkout")
    m = harness.load_manifest()
    with open(os.path.join(os.path.dirname(__file__), "left_out.json")) as f:
        extra = json.load(f)
    for key in ("workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in m[key]}
        m[key] += [e for e in extra[key] if e["name"] not in have]
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    os.symlink(os.path.join(harness.ROOT, "benchmark"), root / "benchmark")
    return str(root)
