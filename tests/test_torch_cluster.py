"""The port's cluster-attributed SED (expecto_tpu_torch/analysis/interpret.py,
pipeline/sed.py::score_sed_with_clusters, cli/predict_by_cluster.py) vs the
JAX package's, on the CPU: the attribution functions, the scorer with
cluster labels, with a keep mask and with an RSAT multi-membership, and the
CLI end to end on h5 files that the port's h5 writer wrote (labels with
the ``coeff_idx`` rule, RSAT clusters, keep-mask ablations), its sed.tsv
equal within rtol 1e-6, and the CLI's exit-2 cases."""

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.analysis import interpret as jinterp
from expecto_tpu.cli.predict_by_cluster import main as jax_pbc_main
from expecto_tpu.models.gblinear import GBLinearModel as JaxGBLinearModel
from expecto_tpu.pipeline import sed as jsed
from expecto_tpu_torch.analysis import interpret as tinterp
from expecto_tpu_torch.cli.predict_by_cluster import main as pbc_main
from expecto_tpu_torch.genome.windows import variant_shifts
from expecto_tpu_torch.io.xgb import save_xgb07_binary
from expecto_tpu_torch.models.gblinear import GBLinearModel
from expecto_tpu_torch.pipeline import sed as tsed

MAXSHIFT = 400
N_TRACKS = 2002
# host numpy on both sides, the same operations in the same order: equal in
# practice; held within rtol 1e-6 (atol 1e-12 for proportions near zero)
RTOL, ATOL = 1e-6, 1e-12
ASSAYS = ["CTCF", "ZFP1", "MULTI", "Pol2", "POLR2A", "H3K4me3", "DNase", "GATA1"]
KINDS = ["TF", "TF", "TF", "TF", "TF", "Histone", "DNase", "TF"]


@pytest.fixture(scope="module")
def inputs():
    """Six variants (a variant with three genes, both strands), their
    11-column gene table, and fork-schema per-shift effects (S, N, 2002)
    with ref and alt apart, seeded."""
    rng = np.random.default_rng(31)
    vcf_rows, gene_rows = [], []
    for i, n_genes in enumerate((1, 3, 1, 2, 1, 1)):
        pos = 10_000 + 5_000 * i
        vcf_rows.append(["chr1", pos, f"rs{i}", "A", "G"])
        for g in range(n_genes):
            tss = pos + int(rng.integers(-15_000, 15_000))
            gene_rows.append(["1", pos - 1, pos, "A", "G", "1", tss - 1, tss, "+-"[g % 2], f"G{i}_{g}", tss - pos])
    s = len(variant_shifts(MAXSHIFT))
    ref = rng.random((s, len(vcf_rows), N_TRACKS)).astype(np.float32)
    alt = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1).astype(np.float32)
    return pd.DataFrame(vcf_rows), pd.DataFrame(gene_rows), {"ref": ref, "alt": alt, "diff": alt - ref}


def _models(n_features: int, seed: int):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(n_features) * 0.05).astype(np.float32)
    return GBLinearModel(weight=w, bias=0.2, base_score=2.0), JaxGBLinearModel(weight=w, bias=0.2, base_score=2.0)


def _features_df() -> pd.DataFrame:
    reps = -(-N_TRACKS // len(ASSAYS))
    return pd.DataFrame({"Cell type": [f"C{i % 5}" for i in range(N_TRACKS)], "Assay": (ASSAYS * reps)[:N_TRACKS],
                         "Assay type": (KINDS * reps)[:N_TRACKS]})


def _membership(marks: int, seed: int) -> np.ndarray:
    """A seeded binary (marks, 6) membership, some marks in several clusters."""
    return (np.random.default_rng(seed).random((marks, 6)) < 0.3).astype(np.float64)


def _assert_frames_close(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns) and got.shape == want.shape
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=str(col), equal_nan=True)
        else:
            assert (g.astype(str) == w.astype(str)).all(), col


# ---- attribution ---------------------------------------------------------------

def test_attribution_functions_match_jax():
    rng = np.random.default_rng(4)
    port, jax_model = _models(10 * 50, 5)
    ref = rng.random((7, 500)).astype(np.float32)
    alt = ref + rng.normal(0, 0.1, ref.shape).astype(np.float32)
    w, b = tinterp.model_coefficients(port)
    wj, bj = jinterp.model_coefficients(jax_model)
    np.testing.assert_array_equal(w, wj)
    assert b == bj and w.dtype == np.float64
    got = tinterp.interpret_model(port, ref, alt)
    np.testing.assert_allclose(got, jinterp.interpret_model(jax_model, ref, alt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-9)
    for labels in (rng.integers(0, 6, 50), np.array([f"c{k}" for k in rng.integers(0, 4, 50)])):
        got = tinterp.interpret_model_with_clusters(port, ref, alt, pd.Series(labels))
        want = jinterp.interpret_model_with_clusters(jax_model, ref, alt, pd.Series(labels))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert got.shape == (7, len(set(labels)))
    member = _membership(50, 6)
    got = tinterp.interpret_model_multi_membership(port, ref, alt, member)
    np.testing.assert_allclose(got, jinterp.interpret_model_multi_membership(jax_model, ref, alt, member),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(AssertionError, match="cluster labels and output preds df should match shape"):
        tinterp.interpret_model_with_clusters(port, ref, alt, pd.Series(np.zeros(49)))


# ---- score_sed_with_clusters ---------------------------------------------------

@pytest.mark.parametrize("case", ["labels", "keep_mask", "membership", "membership_keep_mask"])
def test_score_sed_with_clusters_matches_jax(tmp_path, inputs, case):
    vcf, gene, effects = inputs
    rng = np.random.default_rng(7)
    keep = rng.random(N_TRACKS) < 0.6 if "keep_mask" in case else None
    marks = int(keep.sum()) if keep is not None else N_TRACKS
    port, jax_model = _models(10 * marks, 8)
    if case.startswith("membership"):
        clusters, member = [f"clu{j}" for j in range(6)], _membership(marks, 9)
    else:
        clusters, member = rng.integers(0, 20, marks), None
    kw = {"maxshift": MAXSHIFT, "keep_mask": keep, "membership": member}
    got = tsed.score_sed_with_clusters(effects, vcf, gene, port, clusters, out_dir=tmp_path / "port", **kw)
    want = jsed.score_sed_with_clusters(effects, vcf, gene, jax_model, clusters, out_dir=tmp_path / "jax", **kw)
    _assert_frames_close(got, want)
    _assert_frames_close(pd.read_csv(tmp_path / "port" / "sed.tsv", sep="\t"),
                         pd.read_csv(tmp_path / "jax" / "sed.tsv", sep="\t"))
    names = clusters if member is not None else [f"cluster_{c}" for c in sorted(set(clusters))]
    assert list(got.columns[-len(names):]) == list(names) and len(got) == len(gene)
    np.testing.assert_allclose(got[names].sum(axis=1), 1.0, rtol=1e-6)
    # REF and ALT are score_sed's on the same rows
    plain = tsed.score_sed(effects, vcf, gene, port, maxshift=MAXSHIFT, keep_mask=keep).table
    for col in ("REF", "ALT", "SED"):
        np.testing.assert_array_equal(got[col], plain[col])


def test_score_sed_with_clusters_needs_ref_and_alt(inputs):
    vcf, gene, effects = inputs
    port, jax_model = _models(10 * N_TRACKS, 8)
    messages = []
    for fn, model in ((tsed.score_sed_with_clusters, port), (jsed.score_sed_with_clusters, jax_model)):
        with pytest.raises(ValueError) as info:
            fn({"diff": effects["diff"]}, vcf, gene, model, np.zeros(N_TRACKS, int), maxshift=MAXSHIFT)
        messages.append(str(info.value))
    assert messages[0] == messages[1] == "cluster attribution requires ref/alt datasets (fork h5 schema)"


# ---- the CLI on h5 files ---------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory, inputs):
    """The CLI's inputs on disk: the per-shift fork-schema h5 files written by
    the port's writer ([fwd; rc] rows, so the reader's average is the
    effects), the VCF, the gene table, a 20,020-feature model, the feature
    metadata, a clusters table with two basis rows a mark (coeff_idx 0 and
    1) and an RSAT table."""
    pytest.importorskip("h5py")
    from expecto_tpu_torch.io.h5 import write_shift_h5

    d = tmp_path_factory.mktemp("pbc")
    vcf, gene, effects = inputs
    for si, shift in enumerate(variant_shifts(MAXSHIFT)):
        rows = {k: np.concatenate([effects[k][si], effects[k][si]]) for k in ("diff", "ref", "alt")}
        write_shift_h5(d / f"snps.shift_{shift}.diff.h5", rows["diff"], rows["ref"], rows["alt"])
    vcf.to_csv(d / "snps_hg19.vcf", sep="\t", header=False, index=False)
    gene.to_csv(d / "genes.tsv", sep="\t", header=False, index=False)
    save_xgb07_binary(_models(10 * N_TRACKS, 12)[0], d / "m.save")
    _features_df().to_csv(d / "features.tsv", sep="\t")
    rng = np.random.default_rng(13)
    labels = rng.integers(0, 20, N_TRACKS)
    pd.DataFrame({"coeff_idx": np.repeat([0, 1], N_TRACKS), "cluster": np.concatenate([labels, labels + 100])},
                 index=pd.Index([f"f{i}" for i in range(2 * N_TRACKS)])).to_csv(d / "clusters.tsv", sep="\t")
    (d / "rsat.tab").write_text("ctcf_like\tCTCF,ZFP1\npol\tPOL2,POLR2A\ngata\tGATA1\nmixed\tMULTI,CTCF,GATA1\n")
    (d / "lambert.csv").write_text(",Approved symbol\n0,CTCF\n1,GATA1\n")
    (d / "hgnc.csv").write_text("Input,Match type,Approved symbol\nCTCF,Approved symbol,CTCF\nGATA1,Approved symbol,GATA1\n")
    return d


def _common(d, out) -> list[str]:
    return ["--model_save_file", str(d / "m.save"), "--coorFile", str(d / "snps_hg19.vcf"), "--geneFile",
            str(d / "genes.tsv"), "--snpEffectFilePattern", str(d / "snps.shift_SHIFT.diff.h5"), "--maxshift",
            str(MAXSHIFT), "-o", str(out)]


@pytest.mark.parametrize("extra", [
    ["--feature_clusters_df", "{d}/clusters.tsv"],
    ["--feature_clusters_df", "{d}/clusters.tsv", "--belugaFeatures", "{d}/features.tsv", "--no_dnase_features",
     "--no_pol2"],
    ["--rsat_clusters_tab", "{d}/rsat.tab", "--belugaFeatures", "{d}/features.tsv"],
    ["--rsat_clusters_tab", "{d}/rsat.tab", "--belugaFeatures", "{d}/features.tsv", "--intersect_with_lambert",
     "--lambert_hgnc", "{d}/lambert.csv", "--hgnc_mapping", "{d}/hgnc.csv"],
], ids=["labels", "labels_keep_mask", "rsat", "rsat_lambert"])
def test_predict_by_cluster_cli_matches_jax(tmp_path, cli_files, extra, inputs):
    d = cli_files
    args = [a.format(d=d) for a in extra]
    keep_mask = "--no_pol2" in args or "--intersect_with_lambert" in args
    if keep_mask:  # the model is trained on the kept marks
        from expecto_tpu_torch.io.tables import load_beluga_features
        from expecto_tpu_torch.utils.keep_mask import get_keep_mask

        flags = [f in args for f in ("--no_tf_features", "--no_dnase_features", "--no_histone_features",
                                     "--intersect_with_lambert", "--no_pol2")]
        kept = int(get_keep_mask(load_beluga_features(d / "features.tsv"), *flags, lambert_hgnc_path=str(d / "lambert.csv"),
                                 hgnc_mapping_path=str(d / "hgnc.csv")).sum())
        save_xgb07_binary(_models(10 * kept, 14)[0], tmp_path / "m.save")
    for main, tag in ((pbc_main, "port"), (jax_pbc_main, "jax")):
        argv = _common(d, tmp_path / tag) + args
        if keep_mask:
            argv[1] = str(tmp_path / "m.save")
        assert main(argv) == 0
    got = pd.read_csv(tmp_path / "port" / "sed.tsv", sep="\t")
    _assert_frames_close(got, pd.read_csv(tmp_path / "jax" / "sed.tsv", sep="\t"))
    assert len(got) == len(inputs[1])
    tail = [c for c in got.columns if c.startswith("cluster_")] if "--feature_clusters_df" in args else \
        ["ctcf_like", "pol", "gata", "mixed"]
    assert tail and list(got.columns[-len(tail):]) == tail
    if "--feature_clusters_df" in args:  # coeff_idx 0's labels (0-19), not coeff_idx 1's (100-119)
        assert all(int(c.split("_")[1]) < 100 for c in tail)


@pytest.mark.parametrize("extra,message", [
    ([], "one of --feature_clusters_df / --rsat_clusters_tab is required"),
    (["--rsat_clusters_tab", "{d}/rsat.tab"], "--rsat_clusters_tab requires --belugaFeatures"),
    (["--feature_clusters_df", "{d}/clusters.tsv", "--belugaFeatures", "{d}/features.tsv", "--intersect_with_lambert"],
     "--intersect_with_lambert requires --lambert_hgnc and --hgnc_mapping"),
], ids=["no_clusters", "rsat_without_features", "lambert_without_tables"])
def test_predict_by_cluster_cli_exit_2_matches_jax(tmp_path, cli_files, capsys, extra, message):
    args = [a.format(d=cli_files) for a in extra]
    errs = []
    for main, tag in ((pbc_main, "port"), (jax_pbc_main, "jax")):
        assert main(_common(cli_files, tmp_path / tag) + args) == 2
        errs.append(capsys.readouterr().err.strip())
        assert not (tmp_path / tag / "sed.tsv").exists()
    assert errs[0] == errs[1] == message
