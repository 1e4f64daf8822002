"""expecto_tpu_torch serving vs the JAX package: score_sed_serving and the
score CLI's output.csv on the tiny_genome fixture, fp32 on the CPU, every
route (substitutions with 1-3 genes per variant, an insertion, a deletion, a
multi-base substitution, a contig-edge row on the per-window fallback)."""

import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.io.xgb import save_xgb07_binary as jax_save_xgb07_binary
from expecto_tpu.models.convert import save_params_npz as jax_save_params_npz
from expecto_tpu.models.gblinear import GBLinearModel as JaxGBLinearModel
from expecto_tpu.parallel.runner import BelugaRunner as JaxBelugaRunner
from expecto_tpu.pipeline.sed import score_sed_serving as jax_score_sed_serving
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline.sed import score_sed_serving
from torch_port_common import single_torch_thread, narrow_params, sed_atol, serving_tables, write_models  # noqa: F401 (autouse fixture)

# fp32 on both sides, summed in different orders. REF and ALT: rtol 1e-4;
# SED (model-name columns): torch_port_common.sed_atol
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def params():
    return narrow_params(seed=3)


@pytest.fixture(scope="module")
def tables(tiny_genome):
    _fa, contigs = tiny_genome
    rows, gene_rows = serving_tables(contigs["chr1"])
    return pd.DataFrame(rows), pd.DataFrame(gene_rows)


@pytest.fixture(scope="module")
def model_paths(tmp_path_factory):
    return write_models(tmp_path_factory.mktemp("models"), jax_save_xgb07_binary, JaxGBLinearModel, n_models=2)


@pytest.fixture(scope="module")
def jax_serving(tiny_genome, params, tables, model_paths):
    fa, _ = tiny_genome
    vcf, gene = tables
    runner = JaxBelugaRunner(params, batch_size=32)
    return jax_score_sed_serving(vcf, gene, fa, runner, model_paths, maxshift=400)


@pytest.mark.parametrize("batch_size", [32, 5])
def test_score_sed_serving_matches_jax(tiny_genome, params, tables, model_paths, jax_serving, batch_size):
    """batch_size 5 puts one span per chunk (5 shifts), 2 pairs per pair chunk
    with a ragged tail, so the chunked loops and row gathers are exercised."""
    fa, _ = tiny_genome
    vcf, gene = tables
    runner = BelugaRunner(params, batch_size=batch_size, device="cpu")
    got = score_sed_serving(vcf, gene, fa, runner, model_paths, maxshift=400)
    assert list(got.columns) == list(jax_serving.columns)
    assert len(got) == len(gene)
    for col in got.columns[5:]:
        if col in ("gene", "strand"):
            assert (got[col].values == jax_serving[col].values).all()
            continue
        atol = ATOL if col == "dist" or col.startswith(("REF_", "ALT_")) else sed_atol(jax_serving[f"REF_{col}"])
        np.testing.assert_allclose(got[col].values.astype(np.float64), jax_serving[col].values.astype(np.float64),
                                   rtol=RTOL, atol=atol, err_msg=col)


def test_serving_routes_are_all_taken(tiny_genome, params, tables, model_paths, monkeypatch):
    """The fixture reaches the packed-rows, pair-rows and window routes."""
    fa, _ = tiny_genome
    vcf, gene = tables
    runner = BelugaRunner(params, batch_size=32, device="cpu")
    calls = []
    for name in ("score_variant_spans_packed_rows", "score_variant_span_pairs_rows", "predict_codes"):
        orig = getattr(runner, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(runner, name, spy)
    score_sed_serving(vcf, gene, fa, runner, model_paths, maxshift=400)
    assert sorted(calls) == ["predict_codes", "score_variant_span_pairs_rows", "score_variant_spans_packed_rows"]


def _write_inputs(tmp_path, tiny_genome, tables, model_paths, params):
    fa, _ = tiny_genome
    vcf, gene = tables
    vcf_path = tmp_path / "in.vcf"
    vcf.to_csv(vcf_path, sep="\t", header=False, index=False)
    gene_path = tmp_path / "genes.tsv"
    gene.to_csv(gene_path, sep="\t", header=False, index=False)
    mlist = tmp_path / "modellist"
    mlist.write_text("ModelName\tTissue\n" + "".join(f"{p}\tT{j}\n" for j, p in enumerate(model_paths)))
    weights = tmp_path / "beluga.npz"
    jax_save_params_npz(params, weights)
    return [str(vcf_path), "--geneFile", str(gene_path), "--modelList", str(mlist), "--genome", str(fa.path),
            "--beluga_weights", str(weights), "--maxshift", "400", "--batchsize", "32", "--fp32"]


def test_score_cli_output_csv_matches_jax(tmp_path, tiny_genome, tables, model_paths, params):
    from expecto_tpu.cli.score import main as jax_main
    from expecto_tpu_torch.cli.score import main as torch_main

    common = _write_inputs(tmp_path, tiny_genome, tables, model_paths, params)
    assert jax_main(common + ["--output", str(tmp_path / "jax.csv")]) == 0
    assert torch_main(common + ["--device", "cpu", "--output", str(tmp_path / "torch.csv")]) == 0
    want = pd.read_csv(tmp_path / "jax.csv")
    got = pd.read_csv(tmp_path / "torch.csv")
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape == (len(tables[1]), 8 + 3 * len(model_paths))
    for col in got.columns:
        if got[col].dtype.kind in "fc":
            atol = ATOL if col.startswith(("REF_", "ALT_")) else sed_atol(want[f"REF_{col}"])
            np.testing.assert_allclose(got[col].values, want[col].values, rtol=RTOL, atol=atol, err_msg=col)
        else:
            assert (got[col].values == want[col].values).all(), col
    for j in range(len(model_paths)):
        np.testing.assert_allclose(got[f"T{j}"], got[f"ALT_T{j}"] - got[f"REF_T{j}"], atol=1e-5)


def test_score_cli_defaults_to_cuda(tmp_path, tiny_genome, tables, model_paths, params):
    """With no --device the CLI asks for the card; without one it raises
    instead of running on the CPU."""
    from expecto_tpu_torch.cli.score import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    common = _write_inputs(tmp_path, tiny_genome, tables, model_paths, params)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        torch_main(common + ["--output", str(tmp_path / "out.csv")])
    assert not (tmp_path / "out.csv").exists()
