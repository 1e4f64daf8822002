"""The port's training pipeline and CLI vs the JAX package, fp32 on the CPU:
``gene_filter``, ``chromosome_split``, ``train_expression_model``,
``train_bootstrap`` (both modes), ``train_all_tissues`` (both modes, the
``metrics.h5`` key set and values) and ``expecto_tpu_torch.cli.train`` in its
three modes against ``expecto_tpu.cli.train``'s files, on a tiny gene table
with genes on chrX, chrY, chr7 and chr8, rRNA genes and NaN labels.

Tolerances: weights, biases and predictions within 1e-5 (the trainers'
products are summed in another order each round, tests/test_gblinear.py);
Spearman, Pearson and R² within 1e-4 (statistics of those predictions)."""

import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.cli import train as jcli
from expecto_tpu.io.xgb import load_expression_model as jload
from expecto_tpu.models.gblinear import GBLinearParams as JParams
from expecto_tpu.pipeline import train as jtrain
from expecto_tpu_torch.cli import train as tcli
from expecto_tpu_torch.io.xgb import load_expression_model as tload
from expecto_tpu_torch.models.gblinear import GBLinearParams as TParams
from expecto_tpu_torch.pipeline import train as ttrain
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TOL, STAT_TOL = 1e-5, 1e-4
N_GENES, N_FEAT = 180, 24
HP = {"eta": 0.3, "reg_lambda": 5.0, "num_round": 20, "block_size": 16}


@pytest.fixture(scope="module")
def tables():
    """(X, geneanno, expression) with the real geneanno columns; three
    tissue columns; rRNA rows; NaN and zero expression (log(0 + 1e-4) is
    finite, NaN is not)."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(N_GENES, N_FEAT)).astype(np.float32)
    chroms = rng.choice(["chr1", "chr2", "chr7", "chr8", "chrX", "chrY"], size=N_GENES,
                        p=[0.35, 0.25, 0.12, 0.16, 0.08, 0.04])
    gtype = rng.choice(["protein_coding", "lincRNA", "rRNA"], size=N_GENES, p=[0.75, 0.2, 0.05])
    geneanno = pd.DataFrame({
        "id": [f"ENSG{i:05d}" for i in range(N_GENES)], "symbol": [f"S{i}" for i in range(N_GENES)],
        "seqnames": chroms, "strand": rng.choice(["+", "-"], size=N_GENES),
        "TSS": rng.integers(1, 10**7, size=N_GENES), "CAGE_representative_TSS": rng.integers(1, 10**7, size=N_GENES),
        "type": gtype,
    })
    cols = {}
    for t in range(3):
        e = np.exp(X @ rng.normal(size=N_FEAT) * 0.2 + 1.0)
        e[rng.random(N_GENES) < 0.05] = np.nan
        e[rng.random(N_GENES) < 0.03] = 0.0
        cols[f"tissue{t}"] = e
    expression = pd.DataFrame({"gene": geneanno["id"], **cols})
    assert {"chr7", "chr8", "chrX", "chrY"} <= set(chroms) and (gtype == "rRNA").any()
    return X, geneanno, expression


def test_gene_filter_and_split_match_jax(tables):
    _, geneanno, _ = tables
    for f in ("all", "pc", "lincRNA"):
        np.testing.assert_array_equal(ttrain.gene_filter(geneanno, f), jtrain.gene_filter(geneanno, f))
    with pytest.raises(ValueError, match="filterStr"):
        ttrain.gene_filter(geneanno, "snRNA")
    for hold in (("chrX", "chrY", "chr8"), ("chrX", "chrY", "chr7", "chr8")):
        for got, want in zip(ttrain.chromosome_split(geneanno, hold), jtrain.chromosome_split(geneanno, hold)):
            np.testing.assert_array_equal(got, want)


def _assert_results_close(got, want):
    np.testing.assert_allclose(got.model.weight, want.model.weight, atol=TOL, rtol=0)
    assert abs(got.model.bias - want.model.bias) < TOL
    np.testing.assert_array_equal(got.test_true, want.test_true)
    np.testing.assert_allclose(got.test_pred, want.test_pred, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.spearman, want.spearman, atol=STAT_TOL, rtol=0)
    for key in ("train_pred", "train_true", "train_spearman"):
        g, w = getattr(got, key), getattr(want, key)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g, w, atol=STAT_TOL if key == "train_spearman" else TOL, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"filter_str": "pc", "seed_resample": 3},
                                {"filter_str": "lincRNA", "holdout_train": ("chrX", "chrY", "chr7", "chr8")}],
                         ids=["all", "pc_resampled", "lincRNA_susztak_split"])
def test_train_expression_model_matches_jax(tables, tmp_path, kw):
    X, geneanno, expression = tables
    e = expression["tissue0"].values
    got = ttrain.train_expression_model(X, geneanno, e, params=TParams(**HP), output_prefix=tmp_path / "t",
                                        device="cpu", **kw)
    want = jtrain.train_expression_model(X, geneanno, e, params=JParams(**HP), output_prefix=tmp_path / "j", **kw)
    _assert_results_close(got, want)
    for name in ("eval", "train"):
        np.testing.assert_allclose(got.model.eval_history[name], want.model.eval_history[name], atol=TOL, rtol=0)
    for ext in (".save", ".dump"):
        np.testing.assert_allclose(tload(str(tmp_path / "t") + ext).weight, want.model.weight, atol=TOL, rtol=0)
    assert (tmp_path / "t.dump").read_text().startswith("bias:\n")


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_seed"])
def test_train_bootstrap_matches_jax(tables, tmp_path, vectorized):
    X, geneanno, expression = tables
    e = expression["tissue1"].values
    seeds = [0, 5, 9]
    got = ttrain.train_bootstrap(X, geneanno, e, seeds, output_dir=tmp_path / "t", vectorized=vectorized,
                                 params=TParams(**HP), device="cpu")
    want = jtrain.train_bootstrap(X, geneanno, e, seeds, output_dir=tmp_path / "j", vectorized=vectorized,
                                  params=JParams(**HP))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_results_close(g, w)
    assert not np.allclose(got[0].model.weight, got[1].model.weight)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names and len(names) == 6
    for seed, res in zip(seeds, got):
        for ext in (".save", ".dump"):
            loaded = tload(tmp_path / "t" / f"bootstrap_seed{seed}{ext}")
            np.testing.assert_array_equal(loaded.weight, res.model.weight)
        assert (tmp_path / "t" / f"bootstrap_seed{seed}.dump").read_text().startswith("bias:\n")


def test_vectorized_bootstrap_rejects_unknown_kwargs(tables):
    X, geneanno, expression = tables
    with pytest.raises(TypeError, match="unsupported kwargs"):
        ttrain.train_bootstrap(X, geneanno, expression["tissue0"].values, [0], device="cpu", seed_resample=1)


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "per_column"])
def test_train_all_tissues_matches_jax(tables, tmp_path, vectorized):
    X, geneanno, expression = tables
    got = ttrain.train_all_tissues(X, geneanno, expression, output_dir=tmp_path / "t", metrics_path=tmp_path / "t.h5",
                                   vectorized=vectorized, params=TParams(**HP), device="cpu")
    want = jtrain.train_all_tissues(X, geneanno, expression, output_dir=tmp_path / "j", metrics_path=tmp_path / "j.h5",
                                    vectorized=vectorized, params=JParams(**HP))
    assert list(got) == list(want) == ["tissue0", "tissue1", "tissue2"]
    for name in got:
        _assert_results_close(got[name], want[name])
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())
    with h5py.File(tmp_path / "t.h5", "r") as ft, h5py.File(tmp_path / "j.h5", "r") as fj:
        assert set(ft) == set(fj) == {"pearsonr_valids", "r2_valids", "pearsonr_trains", "r2_trains",
                                      "spearman_valid", "tissue"}
        np.testing.assert_array_equal(ft["tissue"][:], fj["tissue"][:])
        for key in ("pearsonr_valids", "r2_valids", "pearsonr_trains", "r2_trains", "spearman_valid"):
            assert ft[key].shape == (3,) and np.isfinite(ft[key][:]).all()
            np.testing.assert_allclose(ft[key][:], fj[key][:], atol=STAT_TOL, rtol=0)


def _cli_files(tmp_path, tables):
    X, geneanno, expression = tables
    if not (tmp_path / "X.npy").exists():
        np.save(tmp_path / "X.npy", X)
        geneanno.to_csv(tmp_path / "anno.csv", index=False)
        expression.to_csv(tmp_path / "exp.csv", index=False)
    return ["--expFile", str(tmp_path / "exp.csv"), "--inputFile", str(tmp_path / "X.npy"),
            "--annoFile", str(tmp_path / "anno.csv"), "--num_round", "6", "--eta", "0.3", "--l2", "5"]


@pytest.fixture(scope="module")
def cli_runs(tables, tmp_path_factory):
    """Each mode run through both CLIs on the same files: {mode: (port out
    dir, JAX out dir)}."""
    tmp = tmp_path_factory.mktemp("train_cli")
    base = _cli_files(tmp, tables)
    modes = {
        "single": ["--targetIndex", "2"],
        "bootstrap": ["--targetIndex", "1", "--bootstrap_seeds", "3"],
        "all_vectorized": ["--allTissues", "--vectorized"],
        "all_per_column": ["--allTissues"],
    }
    runs = {}
    for mode, flags in modes.items():
        out_t, out_j = tmp / f"{mode}_t", tmp / f"{mode}_j"
        extra_t = ["--evalFile", str(tmp / f"{mode}_t.csv")] if mode == "single" else []
        extra_j = ["--evalFile", str(tmp / f"{mode}_j.csv")] if mode == "single" else []
        assert tcli.main(base + flags + extra_t + ["--output_dir", str(out_t), "--device", "cpu"]) == 0
        assert jcli.main(base + flags + extra_j + ["--output_dir", str(out_j)]) == 0
        runs[mode] = (out_t, out_j)
    return tmp, runs


@pytest.mark.parametrize("mode", ["single", "bootstrap", "all_vectorized", "all_per_column"])
def test_cli_matches_jax_cli(cli_runs, mode):
    tmp, runs = cli_runs
    out_t, out_j = runs[mode]
    names = sorted(p.name for p in out_j.iterdir())
    assert sorted(p.name for p in out_t.iterdir()) == names
    models = [n for n in names if n.endswith((".save", ".dump"))]
    assert len(models) == {"single": 2, "bootstrap": 6}.get(mode, 6)
    for name in models:
        got, want = tload(out_t / name), jload(out_j / name)
        np.testing.assert_allclose(got.weight, want.weight, atol=TOL, rtol=0)
        assert abs(got.bias - want.bias) < TOL
    if mode == "single":
        assert {"test_plots.png", "train_plots.png"} <= set(names)
        got, want = pd.read_csv(tmp / "single_t.csv"), pd.read_csv(tmp / "single_j.csv")
        assert list(got.columns) == list(want.columns)
        np.testing.assert_allclose(got.values, want.values, atol=TOL, rtol=0)
    if mode.startswith("all"):
        with h5py.File(out_t / "metrics.h5", "r") as ft, h5py.File(out_j / "metrics.h5", "r") as fj:
            assert set(ft) == set(fj)
            for key in ("pearsonr_valids", "r2_valids", "pearsonr_trains", "r2_trains", "spearman_valid"):
                np.testing.assert_allclose(ft[key][:], fj[key][:], atol=STAT_TOL, rtol=0)


def test_cli_defaults_to_cuda_and_raises_without_gpu(tables, tmp_path):
    base = _cli_files(tmp_path, tables)
    args = tcli.build_parser().parse_args(base + ["--targetIndex", "1"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(base + ["--targetIndex", "1", "--output_dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(base + ["--targetIndex", "1", "--device", "cuda", "--output_dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def test_cli_argument_errors(tables, tmp_path, capsys):
    base = _cli_files(tmp_path, tables) + ["--device", "cpu", "--output_dir", str(tmp_path / "x")]
    assert tcli.main(base) == 2
    assert tcli.main(base + ["--allTissues", "--bootstrap_seeds", "2"]) == 2
    assert tcli.main(base + ["--targetIndex", "1", "--match_with_basenji2"]) == 2
    assert not (tmp_path / "x").exists()
    assert "required" in capsys.readouterr().err


def test_bootstrap_cli_runs_without_h5py_and_sklearn(tables, tmp_path):
    """The card's machine has neither h5py nor (as far as is known)
    scikit-learn: with both unimportable, the training modules import and
    the bootstrap CLI trains and writes its models on the CPU."""
    argv = _cli_files(tmp_path, tables) + ["--targetIndex", "1", "--bootstrap_seeds", "2", "--device", "cpu",
                                           "--output_dir", str(tmp_path / "boot")]
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from expecto_tpu_torch.cli.train import main\n"
        f"assert main({argv!r}) == 0\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and m.startswith(('h5py', 'sklearn'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert len(list((tmp_path / "boot").glob("bootstrap_seed*.save"))) == 2
