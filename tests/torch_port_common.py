"""Shared inputs of the tests/test_torch_*.py parity tests: narrow-width
Beluga weights and serving tables, made from a seed with numpy so the JAX
package and its PyTorch port see the same numbers."""

import numpy as np
import pytest
import torch

#: (in, out) of the six width-8 convs at test width; fc1 is 106*32 -> 64 and
#: fc2 keeps the real 2002 tracks (the decay features are N_BASIS*2002 wide)
NARROW_CONVS = [(4, 16), (16, 16), (16, 24), (24, 24), (24, 32), (32, 32)]
NARROW_FC1_OUT = 64
N_TRACKS = 2002

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """One torch intra-op thread while a test module runs (import this
    fixture into the module). The suite runs in several worker processes at
    once, and a full torch thread pool in each of them oversubscribes the
    cores: the serving tests ran 12x slower under 6 workers on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sed_atol(ref) -> float:
    """Absolute tolerance of an fp32 SED column. SED = ALT - REF differences
    two separately rounded ~20,020-term fp32 products, so it carries their
    summation-order noise at the scale of |REF|, not of SED: the JAX
    package's own packed-rows and N-dense routes differ by up to
    2.8e-6 * max|REF| on the same inputs. 1e-5 * max|REF| (about 80 fp32
    ulps of REF) bounds that noise on both sides."""
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref, dtype=np.float64)).max()))


def narrow_params(seed: int = 0, convs=NARROW_CONVS) -> dict:
    """He-scaled random Beluga weights at test widths (``convs``: the six
    (in, out) conv widths), as the numpy pytree of expecto_tpu.models.beluga
    (WIO conv kernels, length-major fc1)."""
    rng = np.random.default_rng(seed)

    def layer(shape, fan_in):
        w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        b = rng.standard_normal(shape[-1]) * 0.05
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    params = {f"conv{i}": layer((8, cin, cout), 8 * cin) for i, (cin, cout) in enumerate(convs)}
    c6 = convs[-1][1]
    params["fc1"] = layer((106 * c6, NARROW_FC1_OUT), 106 * c6)
    params["fc2"] = layer((NARROW_FC1_OUT, N_TRACKS), NARROW_FC1_OUT)
    return params


def random_codes(rng, n: int, length: int, n_frac: float = 0.02) -> np.ndarray:
    """(n, length) int8 base codes with about ``n_frac`` N bases (code 4)."""
    codes = rng.integers(0, 4, size=(n, length)).astype(np.int8)
    codes[rng.random((n, length)) < n_frac] = 4
    return codes


def onehot(codes: np.ndarray) -> np.ndarray:
    """int codes -> float32 one-hot; code 4 (N) is all zeros."""
    return np.eye(5, 4, dtype=np.float32)[codes]


def serving_tables(contig: str):
    """(vcf rows, gene rows) on ``contig`` of the ``tiny_genome`` fixture
    covering every serving route at maxshift 400: substitutions with 1-3
    genes per variant (one a multi-base substitution), an insertion with two
    genes, a deletion, and a contig-edge substitution whose upstream shift
    windows cross the contig start (per-window fallback)."""
    rows, gene_rows = [], []

    def add(pos, ref, alt, n_genes):
        rows.append(["chr1", pos, ".", ref, alt])
        for gi in range(n_genes):
            tss = pos + 3000 * (gi + 1) * (-1) ** gi
            strand = "+" if gi % 2 == 0 else "-"
            gene_rows.append(["1", pos - 1, pos, ref, alt, "1", tss - 1, tss, strand, f"G{pos}_{gi}", tss - pos])

    add(7000, contig[6999], COMPLEMENT[contig[6999]], 3)
    add(11000, contig[10999], COMPLEMENT[contig[10999]], 1)
    add(15000, contig[14999], contig[14999] + "AC", 2)          # insertion
    add(19000, contig[18999:19003], contig[18999], 1)           # deletion
    add(24000, contig[23999:24002], "TAG", 2)                   # multi-base substitution
    add(900, contig[899], COMPLEMENT[contig[899]], 1)           # contig-edge row
    return rows, gene_rows


def write_models(dirpath, save_xgb07_binary, GBLinearModel, n_models: int = 2, seed: int = 4) -> list[str]:
    """``n_models`` seeded gblinear models written as xgboost-0.7 ``.save``
    files with the given codec; returns their paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for j in range(n_models):
        model = GBLinearModel(
            weight=(rng.standard_normal(10 * N_TRACKS) * 0.05).astype(np.float32), bias=0.1 * j, base_score=2.0
        )
        path = str(dirpath / f"m{j}.save")
        save_xgb07_binary(model, path)
        paths.append(path)
    return paths
