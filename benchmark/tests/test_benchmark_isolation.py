"""Nothing the benchmark runs imports JAX or the JAX package: module names
compared whole at the top level, so ``expecto_tpu_torch`` passes."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")


def test_forbidden_names_compare_whole():
    assert harness.forbidden_loaded({"expecto_tpu_torch": 1, "expecto_tpu_torch.ops.fc1": 1, "numpy": 1}) == []
    assert harness.forbidden_loaded({"expecto_tpu.ops": 1}) == ["expecto_tpu"]
    assert harness.forbidden_loaded({"jaxlib.xla_client": 1, "flax": 1}) == ["flax", "jaxlib"]
    assert harness.forbidden_loaded({"jaxtyping": 1, "flaxen": 1}) == []


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                found = _imports(os.path.join(dirpath, f)) & set(harness.FORBIDDEN_MODULES)
                assert not found, (f, found)


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            assert "expecto_tpu_torch" not in _imports(os.path.join(BENCH, "reference", f)), f


def test_a_cpu_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "from benchmark.tests.conftest import tiny\n"
        "cfg, tr = tiny('fp32-score')\n"
        "r = harness.run_cell('fp32-score', 5, 0.2, True, device='cpu', cfg_override=cfg, traffic_override=tr,\n"
        "                     cache_dir=%r)\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_loaded())\n"
    ) % (harness.ROOT, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "bf16-score", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "harness.run_cell('fp32-score', 5, 0.2, False, device='cpu', root=%r)\n") % (str(tmp_path), str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "expecto_tpu_torch" in out.stderr
