"""expecto_tpu_torch stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless asked for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    pkg = REPO / "expecto_tpu_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    required = ["expecto_tpu_torch.ops.conv8", "expecto_tpu_torch.cli.score", "expecto_tpu_torch.cli.chromatin",
                "expecto_tpu_torch.cli.predict", "expecto_tpu_torch.io.h5", "expecto_tpu_torch.utils.keep_mask",
                "expecto_tpu_torch.pipeline.features", "expecto_tpu_torch.cli.compute_features",
                "expecto_tpu_torch.genome.liftover", "expecto_tpu_torch.analysis.atac",
                "expecto_tpu_torch.pipeline.consensus", "expecto_tpu_torch.pipeline.merge",
                "expecto_tpu_torch.cli.consensus", "expecto_tpu_torch.models.gblinear",
                "expecto_tpu_torch.ops.gblinear_cd", "expecto_tpu_torch.pipeline.train",
                "expecto_tpu_torch.utils.plotting", "expecto_tpu_torch.cli.train"]
    assert set(required) <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, v in sys.modules.items()\n"
        "             if v is not None and (m == 'expecto_tpu' or m.startswith(('expecto_tpu.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_sources_name_no_jax_import():
    for path in (REPO / "expecto_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), f"{path}: {line}"
            assert "expecto_tpu." not in stripped.split("#")[0] or not stripped.startswith(("import", "from")), (
                f"{path}: {line}"
            )


def test_runner_without_device_needs_a_gpu():
    from expecto_tpu_torch.parallel.runner import BelugaRunner, resolve_device
    from torch_port_common import narrow_params

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        BelugaRunner(narrow_params(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda:0")
