"""The port's h5-contract scoring half vs the JAX package on the CPU: the
track keep-mask, score_sed (fork and legacy inputs, a 20,030-feature model)
and score_sed_multimodel with its sign, the chromatin -> predict CLI chain,
the h5 path against the port's fused serving, the golden SED fixture, and
the serving path without h5py."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.io.xgb import save_xgb07_binary as jax_save_xgb07_binary
from expecto_tpu.models.convert import save_params_npz as jax_save_params_npz
from expecto_tpu.models.gblinear import GBLinearModel as JaxGBLinearModel
from expecto_tpu.parallel.runner import BelugaRunner as JaxBelugaRunner
from expecto_tpu.pipeline import sed as jsed
from expecto_tpu.utils import keep_mask as jkm
from expecto_tpu_torch.genome.fasta import FastaIndex
from expecto_tpu_torch.models.gblinear import GBLinearModel
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline import chromatin as tchrom
from expecto_tpu_torch.pipeline import sed as tsed
from expecto_tpu_torch.utils import keep_mask as tkm
from torch_port_common import single_torch_thread, narrow_params, sed_atol, serving_tables, write_models  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
MAXSHIFT = 400
N_SHIFTS = 5
# host numpy fp32 on both sides: the same einsum and matmul, summed in the
# same or another order. REF/ALT rtol 1e-4 atol 1e-5; SED:
# torch_port_common.sed_atol
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def tables(tiny_genome):
    _fa, contigs = tiny_genome
    rows, gene_rows = serving_tables(contigs["chr1"])
    return pd.DataFrame(rows), pd.DataFrame(gene_rows)


@pytest.fixture(scope="module")
def effects(tables):
    """Seeded fork-schema effects, (S, N, 2002) each, with diff = alt - ref."""
    vcf, _gene = tables
    rng = np.random.default_rng(12)
    ref = rng.random((N_SHIFTS, len(vcf), 2002)).astype(np.float32)
    alt = np.clip(ref + rng.normal(0, 0.02, ref.shape), 0, 1).astype(np.float32)
    return {"ref": ref, "alt": alt, "diff": alt - ref}


@pytest.fixture(scope="module")
def model_paths(tmp_path_factory):
    return write_models(tmp_path_factory.mktemp("models"), jax_save_xgb07_binary, JaxGBLinearModel, n_models=3)


def _models(n_features, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(n_features) * 0.05).astype(np.float32)
    return GBLinearModel(weight=w, bias=0.3, base_score=2.0), JaxGBLinearModel(weight=w, bias=0.3, base_score=2.0)


# ---- keep mask ----------------------------------------------------------------

def _feature_tables(tmp_path):
    """A 2,002-mark metadata table and Lambert/HGNC tables covering the
    mapping's branches: one-row matches, a multi-row match with an 'Approved
    symbol' row, a multi-row match of alias rows only (first row taken), an
    unmapped assay, a NaN symbol (dropped), and Pol2/Pol3 assays."""
    assays = ["CTCF", "zfp1", "MULTI", "ALIASED", "UNMAPPED", "NANSYM", "Pol2", "Pol3", "POLR2A", "H3K4me3", "DNase"]
    kinds = ["TF", "TF", "TF", "TF", "TF", "TF", "TF", "TF", "TF", "Histone", "DNase"]
    reps = -(-2002 // len(assays))
    df = pd.DataFrame({
        "Cell type": [f"C{i % 7}" for i in range(2002)],
        "Assay": (assays * reps)[:2002],
        "Assay type": (kinds * reps)[:2002],
    })
    mapping = pd.DataFrame(
        [["CTCF", "Approved symbol", "CTCF"], ["zfp1", "Approved symbol", "zfp1"],
         ["MULTI", "Alias symbol", "WRONG"], ["MULTI", "Approved symbol", "MULTI1"],
         ["ALIASED", "Previous symbol", "ALIAS1"], ["ALIASED", "Alias symbol", "ALIAS2"],
         ["NANSYM", "Approved symbol", None], ["POLR2A", "Approved symbol", "POLR2A"]],
        columns=["Input", "Match type", "Approved symbol"],
    ).set_index("Input")
    lambert = pd.DataFrame({"Approved symbol": ["CTCF", "ZFP1", "MULTI1", "ALIAS1", "POLR2A"]})
    mapping.to_csv(tmp_path / "hgnc.csv")
    lambert.to_csv(tmp_path / "lambert.csv")
    return df, {"lambert_hgnc_path": str(tmp_path / "lambert.csv"), "hgnc_mapping_path": str(tmp_path / "hgnc.csv")}


FLAGS = ["no_tf_features", "no_dnase_features", "no_histone_features", "intersect_with_lambert", "no_pol2"]


@pytest.mark.parametrize("flags", [[f] for f in FLAGS] + [FLAGS, []], ids=FLAGS + ["all", "none"])
def test_get_keep_mask_matches_jax(tmp_path, flags):
    df, paths = _feature_tables(tmp_path)
    args = [f in flags for f in FLAGS]
    got = tkm.get_keep_mask(df, *args, **paths)
    np.testing.assert_array_equal(got, jkm.get_keep_mask(df, *args, **paths))
    assert got.dtype == bool and got.shape == (2002,)
    if flags:
        assert got.sum() < 2002
    else:
        assert got.all()
    if "intersect_with_lambert" in flags and len(flags) == 1:
        kept = set(df["Assay"][got])
        assert kept == {"CTCF", "zfp1", "MULTI", "ALIASED", "POLR2A"}  # zfp1 -> ZFP1, ALIASED -> first row


def test_keep_mask_needs_both_tables():
    df = pd.DataFrame({"Assay": ["CTCF"], "Assay type": ["TF"]})
    with pytest.raises(ValueError, match="lambert_hgnc_path"):
        tkm.get_keep_mask(df, intersect_with_lambert=True)


def test_subset_features_by_mask_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.random((4, 10 * 2002)).astype(np.float32)
    mask = rng.random(2002) < 0.3
    np.testing.assert_array_equal(tkm.subset_features_by_mask(feats, mask), jkm.subset_features_by_mask(feats, mask))


# ---- score_sed / score_sed_multimodel ------------------------------------------

def _assert_tables_equal(got: pd.DataFrame, want: pd.DataFrame, sed_cols=(), ref_col=None):
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape
    for col in got.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if g.dtype.kind in "fc":
            atol = sed_atol(want[ref_col]) if col in sed_cols and ref_col else ATOL
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=str(col), equal_nan=True)
        else:
            assert (g.astype(str) == w.astype(str)).all(), col


def _sed_tables(tmp_path, effects, tables, n_features=20020, keep_mask=None, seed=5):
    vcf, gene = tables
    tm, jm = _models(n_features, seed)
    kw = {"maxshift": MAXSHIFT, "keep_mask": keep_mask}
    got = tsed.score_sed(effects, vcf, gene, tm, out_dir=tmp_path / "port", **kw)
    want = jsed.score_sed(effects, vcf, gene, jm, out_dir=tmp_path / "jax", **kw)
    for res_g, res_w in ((got.table, want.table), (got.sorted_by_magnitude, want.sorted_by_magnitude),
                         (got.sorted_by_proportion, want.sorted_by_proportion)):
        _assert_tables_equal(res_g, res_w, sed_cols=("SED",), ref_col="REF")
    for name in ("sed.tsv", "sed_sorted_by_magnitude.tsv", "sed_sorted_by_proportion.tsv"):
        _assert_tables_equal(pd.read_csv(tmp_path / "port" / name, sep="\t"),
                             pd.read_csv(tmp_path / "jax" / name, sep="\t"), sed_cols=("SED",), ref_col="REF")
    return got


def test_score_sed_fork_inputs_match_jax(tmp_path, effects, tables):
    got = _sed_tables(tmp_path, effects, tables)
    t = got.table
    assert len(t) == len(tables[1])
    np.testing.assert_allclose(t["SED"], t["ALT"] - t["REF"], atol=1e-5)
    assert np.isfinite(got.sorted_by_proportion["SED_PROPORTION"]).all()


def test_score_sed_legacy_inputs_match_jax(tmp_path, effects, tables):
    """Legacy single-'pred' inputs: REF = ALT = 0, SED from the diff, and a
    NaN proportion."""
    got = _sed_tables(tmp_path, {"diff": effects["diff"]}, tables)
    assert (got.table["REF"] == 0).all() and (got.table["ALT"] == 0).all()
    assert got.sorted_by_proportion["SED_PROPORTION"].isna().all()
    assert np.abs(got.table["SED"]).max() > 0


def test_score_sed_pads_to_a_20030_feature_model(tmp_path, effects, tables):
    got = _sed_tables(tmp_path, effects, tables, n_features=20030)
    assert len(got.table) == len(tables[1])
    with pytest.raises(ValueError, match="model expects"):
        tsed.score_sed(effects, *tables, _models(20021, 1)[0], maxshift=MAXSHIFT)


def test_score_sed_with_a_keep_mask_matches_jax(tmp_path, effects, tables):
    mask = np.random.default_rng(6).random(2002) < 0.5
    _sed_tables(tmp_path, effects, tables, n_features=10 * int(mask.sum()), keep_mask=mask)


def test_score_sed_multimodel_matches_jax(tmp_path, effects, tables, model_paths):
    vcf, gene = tables
    names = ["A", "B", "C"]
    got = tsed.score_sed_multimodel(effects, vcf, gene, model_paths, maxshift=MAXSHIFT, model_names=names,
                                    output_csv=tmp_path / "port.csv")
    want = jsed.score_sed_multimodel(effects, vcf, gene, model_paths, maxshift=MAXSHIFT, model_names=names,
                                     output_csv=tmp_path / "jax.csv")
    _assert_tables_equal(got, want)
    _assert_tables_equal(pd.read_csv(tmp_path / "port.csv"), pd.read_csv(tmp_path / "jax.csv"))
    assert list(got.columns[-3:]) == names
    unnamed = tsed.score_sed_multimodel(effects, vcf, gene, model_paths[:1], maxshift=MAXSHIFT)
    assert unnamed.columns[-1] == "m0.save"


# ---- the h5 path against fused serving: the sign contract -----------------------

def _assert_close_rows(got, want, rtol, atol, what):
    """assert_allclose with a per-row atol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert (err <= atol + rtol * np.abs(want)).all(), f"{what}: max |err| {err.max()}"


@pytest.fixture(scope="module")
def params():
    return narrow_params(seed=17)


@pytest.fixture(scope="module")
def keep_arrays_effects(tiny_genome, params, tables):
    """Fork-schema effects from the port's chromatin path, fwd/RC averaged
    as the h5 reader averages them."""
    fa, _ = tiny_genome
    vcf, _gene = tables
    genome = FastaIndex(fa.path)
    runner = BelugaRunner(params, batch_size=32, device="cpu")
    res = tchrom.compute_variant_chromatin_effects(vcf, genome, runner, None, maxshift=MAXSHIFT, keep_arrays=True,
                                                   verbose=False)
    genome.close()
    n = len(vcf)
    return {k: np.stack([(res.arrays[s][i][:n] + res.arrays[s][i][n:]) / 2 for s in res.shifts])
            for i, k in ((0, "diff"), (1, "ref"), (2, "alt"))}


def test_h5_scorers_against_fused_serving(tiny_genome, params, tables, model_paths, keep_arrays_effects):
    """score_sed on the chromatin path's arrays gives the fused scorer's
    REF and SED, and score_sed_multimodel minus its SED: the reference's
    effect pred(0) - pred(diff).

    Tolerances: tests/test_spans.py's (REF rtol 1e-4 atol 1e-4, SED rtol
    1e-3 atol 1e-5), SED's atol raised to sed_atol(REF) on span rows (the
    fused scorer's substitution alt is the conv6 patch and fc1 delta,
    another rounding) and to 1e-4 on the contig-edge row. Both scorers take
    that row's predictions from the same per-window path and differ only in
    the order of the host's 20,020-term products; the JAX package's own two
    scorers differ there by up to 3.9e-5 on this fixture, where |REF| is
    below 3.1."""
    fa, _ = tiny_genome
    vcf, gene = tables
    runner = BelugaRunner(params, batch_size=32, device="cpu")
    serving = tsed.score_sed_serving(vcf, gene, fa, runner, model_paths, maxshift=MAXSHIFT)
    multi = tsed.score_sed_multimodel(keep_arrays_effects, vcf, gene, model_paths, maxshift=MAXSHIFT)
    window_row = (serving.iloc[:, 1] == 900).to_numpy()  # serving_tables' contig-edge row
    assert window_row.sum() == 1
    for path in model_paths:
        name = Path(path).name
        h5_res = tsed.score_sed(keep_arrays_effects, vcf, gene, tsed.load_expression_model(path), maxshift=MAXSHIFT)
        atol = np.where(window_row, 1e-4, sed_atol(serving[f"REF_{name}"]))
        _assert_close_rows(serving[name], h5_res.table["SED"], 1e-3, atol, f"SED {name}")
        np.testing.assert_allclose(serving[f"REF_{name}"], h5_res.table["REF"], rtol=1e-4, atol=1e-4)
        _assert_close_rows(multi[name], -serving[name], 1e-3, atol, f"-multimodel {name}")
        assert np.abs(serving[name]).max() > 1e-4


def test_multimodel_sign_on_jax_and_port(tiny_genome, params, tables, model_paths, keep_arrays_effects):
    """The JAX package's own multimodel output is minus its serving SED, and
    the port's multimodel output equals the JAX package's (tolerances of
    test_h5_scorers_against_fused_serving)."""
    fa, _ = tiny_genome
    vcf, gene = tables
    jserving = jsed.score_sed_serving(vcf, gene, fa, JaxBelugaRunner(params, batch_size=32), model_paths[:1],
                                      maxshift=MAXSHIFT)
    jmulti = jsed.score_sed_multimodel(keep_arrays_effects, vcf, gene, model_paths[:1], maxshift=MAXSHIFT)
    tmulti = tsed.score_sed_multimodel(keep_arrays_effects, vcf, gene, model_paths[:1], maxshift=MAXSHIFT)
    name = "m0.save"
    atol = np.where((jserving.iloc[:, 1] == 900).to_numpy(), 1e-4, sed_atol(jserving[f"REF_{name}"]))
    _assert_close_rows(jmulti[name], -jserving[name], 1e-3, atol, "JAX -multimodel")
    np.testing.assert_allclose(tmulti[name], jmulti[name], rtol=RTOL, atol=1e-6)
    assert (np.sign(tmulti[name]) == -np.sign(jserving[name])).mean() > 0.9


# ---- the CLI chain -----------------------------------------------------------------

def _cli_inputs(tmp_path, tiny_genome, tables, params):
    """VCF (with a row on a non-canonical contig, dropped by the chromatin
    CLI), gene table, weights and a 2,002-mark feature table."""
    fa, _ = tiny_genome
    vcf, gene = tables
    rows = vcf.copy()
    rows.loc[len(rows)] = ["chrUn_x", 500, ".", "A", "C"]
    vcf_path = tmp_path / "in.vcf"
    rows.to_csv(vcf_path, sep="\t", header=False, index=False)
    gene_path = tmp_path / "genes.tsv"
    gene.to_csv(gene_path, sep="\t", header=False, index=False)
    weights = tmp_path / "beluga.npz"
    jax_save_params_npz(params, weights)
    feats = tmp_path / "features.tsv"
    pd.DataFrame({"Cell type": ["C"] * 2002, "Assay": ["CTCF", "H3K4me3"] * 1001,
                  "Assay type": ["TF", "Histone"] * 1001}).to_csv(feats, sep="\t")
    return [str(vcf_path), "--genome", str(fa.path), "--beluga_weights", str(weights), "--maxshift",
            str(MAXSHIFT), "--batchsize", "32"], gene_path, feats


def test_chromatin_then_predict_cli_matches_jax(tmp_path, tiny_genome, tables, params, model_paths):
    from expecto_tpu.cli.chromatin import main as jax_chromatin
    from expecto_tpu.cli.predict import main as jax_predict
    from expecto_tpu_torch.cli.chromatin import main as torch_chromatin
    from expecto_tpu_torch.cli.predict import main as torch_predict

    common, gene_path, feats = _cli_inputs(tmp_path, tiny_genome, tables, params)
    out = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    assert torch_chromatin(common + ["--output_dir", str(out["port"]), "--device", "cpu", "--legacy_h5"]) == 0
    assert jax_chromatin(common + ["--output_dir", str(out["jax"]), "--legacy_h5"]) == 0
    assert sorted(p.name for p in out["port"].iterdir()) == sorted(p.name for p in out["jax"].iterdir())
    for name in ("snps_hg19.vcf", "dropped_contigs.vcf"):
        assert (out["port"] / name).read_text() == (out["jax"] / name).read_text()

    mlist = tmp_path / "modellist"
    mlist.write_text("ModelName\tTissue\n" + "".join(f"{p}\tT{j}\n" for j, p in enumerate(model_paths)))
    runs = {
        "sed": ["--model_save_file", model_paths[0]],
        "sed_masked": ["--model_save_file", model_paths[0], "--belugaFeatures", str(feats), "--no_histone_features"],
        "multi": ["--modelList", str(mlist)],
        "multi_legacy": ["--modelList", str(mlist), "--snpEffectFilePattern", "LEGACY"],
        "multi_split": ["--modelList", str(mlist), "--splitFlag", "--splitFold", "2", "--splitIndex", "1"],
    }
    for run, extra in runs.items():
        for tag, main in (("port", torch_predict), ("jax", jax_predict)):
            pattern = out[tag] / ("snps.shift_SHIFT.legacy.diff.h5" if "LEGACY" in extra else "snps.shift_SHIFT.diff.h5")
            extra_t = [str(pattern) if a == "LEGACY" else a for a in extra]
            if "--snpEffectFilePattern" not in extra_t:
                extra_t += ["--snpEffectFilePattern", str(pattern)]
            if "--model_save_file" in extra and "--belugaFeatures" in extra:
                # a masked model sees 10 x 1,001 features
                mpath = tmp_path / "masked.save"
                w = np.random.default_rng(2).standard_normal(10 * 1001).astype(np.float32) * 0.05
                jax_save_xgb07_binary(JaxGBLinearModel(weight=w, bias=0.1), mpath)
                extra_t[1] = str(mpath)
            args = ["--coorFile", str(out[tag] / "snps_hg19.vcf"), "--geneFile", str(gene_path), "--maxshift",
                    str(MAXSHIFT), "-o", str(tmp_path / f"{run}_{tag}"), "--output",
                    str(tmp_path / f"{run}_{tag}.csv"), *extra_t]
            assert main(args) == 0, (run, tag)
        if run.startswith("sed"):
            for name in ("sed.tsv", "sed_sorted_by_magnitude.tsv", "sed_sorted_by_proportion.tsv"):
                got = pd.read_csv(tmp_path / f"{run}_port" / name, sep="\t")
                want = pd.read_csv(tmp_path / f"{run}_jax" / name, sep="\t")
                _assert_tables_equal(got, want, sed_cols=("SED",), ref_col="REF")
        else:
            got, want = pd.read_csv(tmp_path / f"{run}_port.csv"), pd.read_csv(tmp_path / f"{run}_jax.csv")
            _assert_tables_equal(got, want)
            assert {"T0", "T1", "T2"} <= set(got.columns)
    assert len(pd.read_csv(tmp_path / "multi_split_port.csv")) < len(tables[1])


def test_chromatin_cli_refuses_hg38_and_defaults_to_cuda(tmp_path, tiny_genome, tables, params, capsys):
    from expecto_tpu_torch.cli.chromatin import main as torch_chromatin

    common, _gene, _feats = _cli_inputs(tmp_path, tiny_genome, tables, params)
    assert torch_chromatin(common + ["--hg38", "--output_dir", str(tmp_path / "o")]) == 2
    assert "--hg38 requires --chain_file" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        torch_chromatin(common + ["--output_dir", str(tmp_path / "o")])
    assert not list(tmp_path.glob("o/*.h5"))


def test_predict_cli_needs_a_model_and_the_lambert_tables(tmp_path, capsys):
    from expecto_tpu_torch.cli.predict import main as torch_predict

    base = ["--coorFile", "x", "--geneFile", "y", "--snpEffectFilePattern", "z"]
    assert torch_predict(base + ["--intersect_with_lambert", "--lambert_hgnc", str(tmp_path / "none")]) == 2
    assert "Lambert" in capsys.readouterr().err


def test_load_shift_effects_matches_jax(tmp_path, tiny_genome, tables, params):
    from expecto_tpu_torch.cli.chromatin import main as torch_chromatin

    common, _gene, _feats = _cli_inputs(tmp_path, tiny_genome, tables, params)
    assert torch_chromatin(common + ["--output_dir", str(tmp_path), "--device", "cpu", "--legacy_h5"]) == 0
    for pattern in ("snps.shift_SHIFT.diff.h5", "snps.shift_SHIFT.legacy.diff.h5"):
        got = tsed.load_shift_effects(str(tmp_path / pattern), maxshift=MAXSHIFT)
        want = jsed.load_shift_effects(str(tmp_path / pattern), maxshift=MAXSHIFT)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == (N_SHIFTS, len(tables[0]), 2002)
            np.testing.assert_array_equal(got[k], want[k])


# ---- golden fixture ---------------------------------------------------------------

def test_port_chain_reproduces_golden_sed_tiny(tmp_path):
    """tests/golden/sed_tiny.json through the port: chromatin to h5 files,
    load_shift_effects, score_sed, at tests/test_golden.py's tolerances. The
    weights are built as that test builds them."""
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_oracle import TorchBeluga

    from expecto_tpu.models.convert import state_dict_to_params
    from expecto_tpu_torch.genome.fasta import write_fasta

    torch.manual_seed(1234)
    net = TorchBeluga().eval()
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(0.08)
    params = state_dict_to_params(net.state_dict_reference_keys())
    rs = np.random.RandomState(99)
    contigs = {"chr1": "".join(np.array(list("ACGT"))[rs.randint(0, 4, 40000)])}
    rows, gene_rows = [], []
    for pos in [8000, 20000, 31000]:
        ref = contigs["chr1"][pos - 1]
        alt = {"A": "T", "C": "G", "G": "C", "T": "A"}[ref]
        rows.append(["chr1", pos, ".", ref, alt])
        gene_rows.append(["1", pos - 1, pos, ref, alt, "1", 9999, 10000, "+", "G1", 10000 - pos])
    vcf, gene = pd.DataFrame(rows), pd.DataFrame(gene_rows)
    model = GBLinearModel(weight=np.random.RandomState(5).normal(size=20020).astype(np.float32), bias=0.25,
                          base_score=2.0)
    write_fasta(tmp_path / "g.fa", contigs)
    fa = FastaIndex(tmp_path / "g.fa")
    runner = BelugaRunner(params, batch_size=64, device="cpu")
    tchrom.compute_variant_chromatin_effects(vcf, fa, runner, tmp_path, maxshift=400, output_prefix="snps",
                                             verbose=False)
    fa.close()
    effects = tsed.load_shift_effects(str(tmp_path / "snps.shift_SHIFT.diff.h5"), maxshift=400)
    sed = tsed.score_sed(effects, vcf, gene, model, maxshift=400)
    diff0 = effects["diff"][0]

    want = json.loads((REPO / "tests" / "golden" / "sed_tiny.json").read_text())
    np.testing.assert_allclose(sed.table["SED"].tolist(), want["sed"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(sed.table["REF"].tolist(), want["ref"], rtol=1e-5)
    np.testing.assert_allclose(sed.table["ALT"].tolist(), want["alt"], rtol=1e-5)
    np.testing.assert_allclose(diff0[:, :8].ravel().tolist(), want["diff0_head"], atol=1e-6)
    np.testing.assert_allclose(float(np.linalg.norm(diff0)), want["diff0_norm"], rtol=1e-4)


# ---- serving without h5py --------------------------------------------------------

def test_serving_runs_without_h5py(tmp_path, tiny_genome, tables, params, model_paths):
    """With h5py unimportable, the port's serving CLI, the pipelines and the
    h5-contract CLIs still import, and expecto-score serves on the CPU."""
    fa, _ = tiny_genome
    vcf, gene = tables
    vcf.to_csv(tmp_path / "in.vcf", sep="\t", header=False, index=False)
    gene.to_csv(tmp_path / "genes.tsv", sep="\t", header=False, index=False)
    jax_save_params_npz(params, tmp_path / "beluga.npz")
    argv = [str(tmp_path / "in.vcf"), "--geneFile", str(tmp_path / "genes.tsv"), "--model_save_file", model_paths[0],
            "--genome", str(fa.path), "--beluga_weights", str(tmp_path / "beluga.npz"), "--maxshift",
            str(MAXSHIFT), "--fp32", "--device", "cpu", "--output", str(tmp_path / "out.csv")]
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"  # any `import h5py` now raises ImportError
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import expecto_tpu_torch.pipeline.sed, expecto_tpu_torch.pipeline.chromatin\n"
        "import expecto_tpu_torch.cli.chromatin, expecto_tpu_torch.cli.predict\n"
        "from expecto_tpu_torch.cli.score import main\n"
        f"assert main({argv!r}) == 0\n"
        "assert 'h5py' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert len(pd.read_csv(tmp_path / "out.csv")) == len(gene)
