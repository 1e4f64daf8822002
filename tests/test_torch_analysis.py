"""The port's analysis modules (expecto_tpu_torch/analysis/{rank_int,pwm,
fimo,bootstrap,cluster,extract}.py, pipeline/profiles.py, the extended
utils/keep_mask.py and utils/plotting.py) vs the JAX package's, on the CPU:
the same seeded inputs through both, the outputs equal. Tables and arrays
are compared exactly (host numpy, pandas, scipy and scikit-learn on both
sides, the same operations in the same order); plots by file name and
non-zero size. The port's random draws come from explicit generators: each
is held to the JAX function's draws from numpy's global state, and no port
module calls numpy's global-state functions."""

import importlib
import inspect
import re
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.analysis import bootstrap as jboot
from expecto_tpu.analysis import cluster as jcluster
from expecto_tpu.analysis import extract as jextract
from expecto_tpu.analysis import fimo as jfimo
from expecto_tpu.analysis import pwm as jpwm
from expecto_tpu.analysis import rank_int as jrank
from expecto_tpu.genome.fasta import FastaIndex as JaxFastaIndex
from expecto_tpu.pipeline import profiles as jprof
from expecto_tpu.utils import keep_mask as jkeep
from expecto_tpu_torch.analysis import bootstrap as tboot
from expecto_tpu_torch.analysis import cluster as tcluster
from expecto_tpu_torch.analysis import extract as textract
from expecto_tpu_torch.analysis import fimo as tfimo
from expecto_tpu_torch.analysis import pwm as tpwm
from expecto_tpu_torch.analysis import rank_int as trank
from expecto_tpu_torch.genome.fasta import FastaIndex, write_fasta
from expecto_tpu_torch.io.xgb import save_expression_model
from expecto_tpu_torch.models.gblinear import GBLinearModel
from expecto_tpu_torch.pipeline import profiles as tprof
from expecto_tpu_torch.utils import keep_mask as tkeep
from expecto_tpu_torch.utils import plotting as tplot
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]

#: (JAX module, port module) of every module this slice ported or extended
MODULE_PAIRS = [
    ("analysis", "analysis"), ("analysis.rank_int", "analysis.rank_int"), ("analysis.pwm", "analysis.pwm"),
    ("analysis.motif_scan", "analysis.motif_scan"), ("analysis.fimo", "analysis.fimo"),
    ("analysis.bootstrap", "analysis.bootstrap"), ("analysis.cluster", "analysis.cluster"),
    ("analysis.extract", "analysis.extract"), ("pipeline.profiles", "pipeline.profiles"),
    ("cli.analysis", "cli.analysis"), ("utils.keep_mask", "utils.keep_mask"),
]


def _public(module) -> set:
    """Names a module defines or exports: ``__all__`` where it has one, else
    its public functions and classes defined in it."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n, v in vars(module).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == module.__name__}


@pytest.mark.parametrize("jax_mod,port_mod", MODULE_PAIRS, ids=[p[1] for p in MODULE_PAIRS])
def test_port_module_has_the_jax_modules_public_names(jax_mod, port_mod):
    j = importlib.import_module(f"expecto_tpu.{jax_mod}")
    t = importlib.import_module(f"expecto_tpu_torch.{port_mod}")
    assert _public(j) == _public(t)


def test_plotting_has_the_jax_modules_public_names():
    j = importlib.import_module("expecto_tpu.utils.plotting")
    # the port's r2_score stands in for scikit-learn's; every JAX name is there
    assert _public(j) == _public(tplot) - {"r2_score"}


def test_no_port_module_draws_from_numpys_global_state():
    """Explicit generators only: no call of numpy's global-state random
    functions in any port source."""
    pattern = re.compile(r"np\.random\.(seed|rand|randn|randint|random|choice|permutation|shuffle|normal|uniform)\(")
    hits = [f"{p}:{i}" for p in (REPO / "expecto_tpu_torch").rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.search(line.split("#")[0])]
    assert not hits, hits


# ---------------------------------------------------------------- keep mask

ASSAYS = ["CTCF", "Znf1", "MULTI", "Pol2", "POLR2A", "H3K4me3", "DNase", "gata1", "RENAMED", "Pol3"]
KINDS = ["TF", "TF", "TF", "TF", "TF", "Histone", "DNase", "TF", "TF", "TF"]


@pytest.fixture(scope="module")
def hgnc_files(tmp_path_factory):
    """A features table, a Lambert list and an HGNC mapping with a
    multi-mapped assay (an approved row among aliases), a renamed TF mapped
    through alias rows only, and an unmapped assay."""
    d = tmp_path_factory.mktemp("hgnc")
    feats = pd.DataFrame({"Cell type": [f"c{i}" for i in range(len(ASSAYS))], "Assay": ASSAYS,
                          "Treatment": "None", "Assay type": KINDS, "Source": "ENCODE"})
    pd.DataFrame({"Approved symbol": ["CTCF", "ZNF1", "MULTI1", "GATA1", "NEWNAME", "POLR2A"]}).to_csv(
        d / "lambert.csv")
    pd.DataFrame({"assay": ["CTCF", "Znf1", "MULTI", "MULTI", "gata1", "RENAMED", "RENAMED", "Pol2"],
                  "Match type": ["Approved symbol", "Approved symbol", "Alias", "Approved symbol", "Approved symbol",
                                 "Alias", "Previous symbol", "Alias"],
                  "Approved symbol": ["CTCF", "Znf1", "OTHER", "multi1", "Gata1", "NewName", "NEWNAME", None]}
                 ).set_index("assay").to_csv(d / "mapping.csv")
    return feats, str(d / "lambert.csv"), str(d / "mapping.csv")


KEEP_CASES = [
    dict(intersect_with_lambert=True),
    dict(intersect_with_lambert=True, no_dnase_features=True, no_histone_features=True, no_pol2=True),
    dict(no_tf_features=True, no_pol2=True),
]


@pytest.mark.parametrize("flags", KEEP_CASES, ids=["lambert", "lambert_tf_only", "no_lambert"])
def test_keep_mask_return_hgnc_df(hgnc_files, flags):
    feats, lambert, mapping = hgnc_files
    kw = dict(lambert_hgnc_path=lambert, hgnc_mapping_path=mapping, return_hgnc_df=True, **flags)
    jmask, jdf = jkeep.get_keep_mask(feats, **kw)
    tmask, tdf = tkeep.get_keep_mask(feats, **kw)
    np.testing.assert_array_equal(tmask, jmask)
    if flags.get("intersect_with_lambert"):
        pd.testing.assert_frame_equal(tdf, jdf)
        assert list(tdf["Assay"])[:3] == ["CTCF", "ZNF1", "MULTI1"] and list(feats["Assay"]) == ASSAYS
    else:
        assert tdf is None and jdf is None
    # the flag off: the mask alone, as before
    plain = tkeep.get_keep_mask(feats, **{**kw, "return_hgnc_df": False})
    assert isinstance(plain, np.ndarray)
    np.testing.assert_array_equal(plain, jmask)


# ----------------------------------------------------------------- rank-INT

RINT_SERIES = {
    "ties_nan": pd.Series([1.0, np.nan, 1.0, 2.0, 5.0, 2.0, np.nan, 0.5]),
    "dup_index": pd.Series([3.0, 1.0, 2.0, np.nan, 3.0], index=["g1", "g1", "g2", "g2", "g3"]),
    "seeded": pd.Series(np.round(np.random.default_rng(0).normal(size=200), 1)),
}


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "deterministic"])
@pytest.mark.parametrize("name", list(RINT_SERIES))
def test_rank_int_equals_jax(name, stochastic):
    s = RINT_SERIES[name]
    want = jrank.rank_INT(s, c=0.5 if name == "seeded" else 3.0 / 8, stochastic=stochastic)
    got = trank.rank_INT(s, c=0.5 if name == "seeded" else 3.0 / 8, stochastic=stochastic)
    pd.testing.assert_series_equal(got, want)
    np.testing.assert_array_equal(trank.rank_to_normal(np.arange(1, 5.0), 3.0 / 8, 4),
                                  jrank.rank_to_normal(np.arange(1, 5.0), 3.0 / 8, 4))


def test_rank_int_leaves_the_generator_where_the_reference_leaves_numpys_state():
    """The reseed-then-permute of every call: a generator passed in ends in
    the global state's position after the JAX call, and numpy's global
    state is not touched by the port."""
    s = RINT_SERIES["seeded"]
    rng = np.random.RandomState(1)
    np.random.seed(7)
    before = np.random.get_state()[1].copy()
    trank.rank_INT(s, rng=rng)
    assert np.array_equal(np.random.get_state()[1], before)
    jrank.rank_INT(s)
    want, got = np.random.get_state(), rng.get_state()
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
    assert rng.rand() == np.random.rand()


# ----------------------------------------------------------------- profiles

@pytest.fixture(scope="module")
def profile_tables():
    rng = np.random.default_rng(2)
    n = 40
    geneanno = pd.DataFrame({"symbol": [f"S{i}" for i in range(n)]}, index=[f"E{i}" for i in range(n)])
    keep = rng.permutation(n)[: n - 6]
    counts = pd.DataFrame({"t1": rng.gamma(2.0, 3.0, len(keep)), "t2": rng.integers(0, 50, len(keep)),
                           "t3": np.log2(rng.gamma(2.0, 3.0, len(keep)) + 0.5)}, index=[f"E{i}" for i in keep])
    return geneanno, counts


@pytest.mark.parametrize("on,columns,offset", [("index", None, None), ("index", ["t3", "t1"], 0.5),
                                                ("symbol", ["t2"], None)])
def test_profiles_join_and_rank_match_equal_jax(profile_tables, on, columns, offset):
    geneanno, counts = profile_tables
    if on == "symbol":
        counts = counts.set_axis([f"S{e[1:]}" for e in counts.index])
    want = jprof.join_counts_to_geneanno(geneanno, counts, columns, on=on, log2_offset=offset)
    got = tprof.join_counts_to_geneanno(geneanno, counts, columns, on=on, log2_offset=offset)
    pd.testing.assert_frame_equal(got, want)
    ref = want.iloc[:, 0].copy()
    ref.iloc[3] = np.nan  # a NaN in the reference profile lands on the top-ranked gene, as in the reference
    pd.testing.assert_frame_equal(tprof.rank_match_to_profile(got, ref), jprof.rank_match_to_profile(want, ref))


def test_profiles_duplicate_keys_warn_and_bad_key_raises(profile_tables):
    geneanno, counts = profile_tables
    dup = pd.concat([counts, counts.iloc[:2]])
    with pytest.warns(UserWarning, match="row-aligns"):
        want = jprof.join_counts_to_geneanno(geneanno, dup)
    with pytest.warns(UserWarning, match="row-aligns"):
        got = tprof.join_counts_to_geneanno(geneanno, dup)
    pd.testing.assert_frame_equal(got, want)
    with pytest.raises(ValueError, match="on must be"):
        tprof.join_counts_to_geneanno(geneanno, counts, on="gene")
    ints = pd.DataFrame({"t": np.array([10, 1, 5, 7], dtype=np.int64)})
    ref = pd.Series([100.75, 5.5, 50.25, 8.0])
    pd.testing.assert_frame_equal(tprof.rank_match_to_profile(ints, ref), jprof.rank_match_to_profile(ints, ref))


# --------------------------------------------------------------------- PWMs

def test_pwm_parse_write_and_collect_equal_jax(tmp_path):
    rng = np.random.default_rng(3)

    def block(mid, name, w):
        rows = [f"{b} [ " + " ".join(str(int(v)) for v in rng.integers(0, 30, w)) + " ]" for b in "ACGT"]
        return f">{mid} {name}\n" + "\n".join(rows) + "\n"

    jdir = tmp_path / "jaspar"
    jdir.mkdir()
    for i, name in enumerate(["CTCF", "Gata1", "FOS::JUN", "Unused", "ZNF1"]):
        (jdir / f"MA{i:04d}.1.jaspar").write_text(block(f"MA{i:04d}.1", name, 6 + i))
    hoco = "".join(block(f"H{i}", f"{n}_HUMAN.H11MO.0.A", 5 + i) for i, n in enumerate(["CTCF", "GATA1", "MYC"]))
    hoco += "\n>BAD lacks_rows\nA [ 1 2 ]\n"  # a motif without all four rows is dropped
    (tmp_path / "hoco.jaspar").write_text(hoco)
    j_parsed, t_parsed = jpwm.parse_jaspar(hoco), tpwm.parse_jaspar(hoco)
    assert [(m.matrix_id, m.name, m.counts) for m in t_parsed] == [(m.matrix_id, m.name, m.counts) for m in j_parsed]
    assert tpwm.write_jaspar(t_parsed) == jpwm.write_jaspar(j_parsed)
    np.testing.assert_array_equal(t_parsed[1].pwm(), j_parsed[1].pwm())
    args = ({"CTCF", "GATA1", "ZNF1", "MYC"}, str(jdir), str(tmp_path / "hoco.jaspar"))
    (jm, jfound), (tm, tfound) = jpwm.collect_cluster_motifs(*args), tpwm.collect_cluster_motifs(*args)
    assert tfound == jfound == {"CTCF", "GATA1", "ZNF1", "MYC"}
    assert tpwm.write_jaspar(tm) == jpwm.write_jaspar(jm)
    (jdir / "two.jaspar").write_text(block("X1", "A", 3) + block("X2", "B", 3))
    for mod in (jpwm, tpwm):
        with pytest.raises(AssertionError, match="more than one motif"):
            mod.collect_cluster_motifs({"A"}, str(jdir))


# ---------------------------------------------------------------- bootstrap

N_MARKS, N_BASIS = 7, 10


@pytest.fixture(scope="module")
def boot_dir(tmp_path_factory):
    """12 bootstrap models (natural sort order differs from lexical) and a
    main model, written with the port's .save writer."""
    d = tmp_path_factory.mktemp("boot")
    rng = np.random.default_rng(4)
    true_w = rng.normal(size=N_MARKS * N_BASIS).astype(np.float32)
    for seed in range(12):
        (d / f"seed_{seed}").mkdir()
        w = (true_w + rng.normal(scale=0.2, size=true_w.size)).astype(np.float32)
        save_expression_model(GBLinearModel(weight=w, bias=0.01 * seed), d / f"seed_{seed}" / "model.save")
    save_expression_model(GBLinearModel(weight=true_w, bias=0.1), d / "main.save")
    return d


@pytest.mark.parametrize("limit", [800, 5])
def test_bootstrap_stats_and_zscore_table_equal_jax(boot_dir, limit):
    jmodels = jboot.load_bootstrap_models(str(boot_dir), limit=limit)
    tmodels = tboot.load_bootstrap_models(str(boot_dir), limit=limit)
    assert len(tmodels) == min(limit, 12)
    for a, b in zip(tmodels, jmodels):
        np.testing.assert_array_equal(a.weight, b.weight)
    main_t = tboot.load_expression_model(str(boot_dir / "main.save"))
    main_j = jboot.load_expression_model(str(boot_dir / "main.save"))
    st, sj = tboot.bootstrap_coefficient_stats(tmodels, main_t), jboot.bootstrap_coefficient_stats(jmodels, main_j)
    for f in ("se_weight", "z_score", "coeff_of_var", "all_weights"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    assert st.se_bias == sj.se_bias
    # mark-major all_feature_clusters rows (the reorder applies) and another row count (it does not)
    table = pd.DataFrame({"Assay": np.repeat([f"m{i}" for i in range(N_MARKS)], N_BASIS),
                          "coeff_idx": np.tile(np.arange(N_BASIS), N_MARKS)})
    for df in (table, table.iloc[:N_MARKS * N_BASIS - 3]):
        if len(df) != N_MARKS * N_BASIS:
            sj_cut = jboot.BootstrapStats(sj.se_weight, sj.se_bias, sj.z_score[: len(df)], sj.coeff_of_var,
                                          sj.all_weights)
            st_cut = tboot.BootstrapStats(st.se_weight, st.se_bias, st.z_score[: len(df)], st.coeff_of_var,
                                          st.all_weights)
            pd.testing.assert_frame_equal(tboot.features_sorted_by_zscore(df, st_cut),
                                          jboot.features_sorted_by_zscore(df, sj_cut))
        else:
            pd.testing.assert_frame_equal(tboot.features_sorted_by_zscore(df, st),
                                          jboot.features_sorted_by_zscore(df, sj))


def test_bootstrap_zscore_rows_are_their_own_features(boot_dir):
    """Each sorted row's z-score is the weight index coeff_idx * marks +
    mark's; the reference's positional assignment fails that check."""
    models = tboot.load_bootstrap_models(str(boot_dir))
    stats = tboot.bootstrap_coefficient_stats(models, tboot.load_expression_model(str(boot_dir / "main.save")))
    table = pd.DataFrame({"mark": np.repeat(np.arange(N_MARKS), N_BASIS), "coeff_idx": np.tile(np.arange(N_BASIS),
                                                                                              N_MARKS)})
    out = tboot.features_sorted_by_zscore(table, stats)
    np.testing.assert_array_equal(out["z_score"], stats.z_score[out["coeff_idx"] * N_MARKS + out["mark"]])
    positional = table.assign(z_score=stats.z_score)
    assert not np.array_equal(positional["z_score"],
                              stats.z_score[positional["coeff_idx"] * N_MARKS + positional["mark"]])


# --------------------------------------------------------------- clustering

@pytest.fixture(scope="module")
def cluster_X():
    return np.random.default_rng(5).normal(size=(30, N_BASIS * 6))


@pytest.mark.parametrize("with_distances", [False, True])
def test_hierarchical_fit_cut_and_tables_equal_jax(cluster_X, tmp_path, with_distances):
    X = cluster_X
    np.testing.assert_array_equal(tcluster.hierarchical_feature_clusters(X, 3),
                                  jcluster.hierarchical_feature_clusters(X, 3))
    np.testing.assert_array_equal(tcluster.hierarchical_mark_clusters(X, 2), jcluster.hierarchical_mark_clusters(X, 2))
    np.testing.assert_array_equal(tcluster._grouped_mark_matrix(X), jcluster._grouped_mark_matrix(X))
    kw = dict(with_distances=with_distances)
    tf = tcluster.fit_feature_clustering(X, cache_dir=str(tmp_path / "t"), **kw)
    jf = jcluster.fit_feature_clustering(X, cache_dir=str(tmp_path / "j"), **kw)
    np.testing.assert_array_equal(tf.children_, jf.children_)
    labels = tcluster.cut_feature_clustering(tf, X, 4)
    np.testing.assert_array_equal(labels, jcluster.cut_feature_clustering(jf, X, 4))
    tm, jm = tcluster.fit_mark_clustering(X, **kw), jcluster.fit_mark_clustering(X, **kw)
    mark_labels = tcluster.cut_mark_clustering(tm, X, 3)
    np.testing.assert_array_equal(mark_labels, jcluster.cut_mark_clustering(jm, X, 3))
    meta = pd.DataFrame({"Assay": [f"a{i}" for i in range(6)], "Assay type": "TF"})
    pd.testing.assert_frame_equal(tcluster.feature_clusters_table(meta, labels),
                                  jcluster.feature_clusters_table(meta, labels))
    table = tcluster.mark_clusters_table(meta, mark_labels)
    pd.testing.assert_frame_equal(table, jcluster.mark_clusters_table(meta, mark_labels))
    pd.testing.assert_frame_equal(tcluster.cluster_sizes(table), jcluster.cluster_sizes(table))


def test_tfidf_svd_equal_jax():
    tracks = np.random.default_rng(6).random((30, 80)) + 0.01
    np.testing.assert_array_equal(tcluster.tfidf_transform(tracks), jcluster.tfidf_transform(tracks))
    t, j = tcluster.tfidf_svd(tracks, n_components=5), jcluster.tfidf_svd(tracks, n_components=5)
    np.testing.assert_array_equal(t.components_, j.components_)
    np.testing.assert_array_equal(t.transform(tcluster.tfidf_transform(tracks)),
                                  j.transform(jcluster.tfidf_transform(tracks)))


@pytest.mark.parametrize("with_tsne", [False, True])
def test_kmeans_equal_jax(with_tsne):
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(0, 0.3, (12, 4)), rng.normal(4, 0.3, (12, 4)), rng.normal(-4, 0.3, (12, 4))])
    t = tcluster.kmeans_clusters(X, k=3, with_tsne=with_tsne)
    j = jcluster.kmeans_clusters(X, k=3, with_tsne=with_tsne)
    if with_tsne:
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
    else:
        np.testing.assert_array_equal(t, j)


LOUVAIN_CASES = {
    "blobs": lambda rng: np.concatenate([rng.normal(c, 0.05, (15, 3)) for c in (0.0, 10.0, -10.0)]),
    "one_blob": lambda rng: rng.normal(0, 1.0, (25, 5)),
    "two_points": lambda rng: np.array([[0.0, 0.0], [100.0, 0.0]]),
}


@pytest.mark.parametrize("case", list(LOUVAIN_CASES))
def test_louvain_and_knn_graph_equal_jax(case):
    X = LOUVAIN_CASES[case](np.random.default_rng(8))
    assert tcluster._knn_graph(X, 5) == jcluster._knn_graph(X, 5)
    for seed in (0, 3):
        np.testing.assert_array_equal(tcluster.louvain_clusters(X, k_neighbors=5, seed=seed),
                                      jcluster.louvain_clusters(X, k_neighbors=5, seed=seed))
    if case == "blobs":
        labels = tcluster.louvain_clusters(X, k_neighbors=5)
        assert [len(set(labels[i:i + 15])) for i in (0, 15, 30)] == [1, 1, 1] and len(set(labels)) == 3


# ------------------------------------------------------------------ extract

SNP_CASES = [(80000, 100000, "+"), (100000, 100000, "+"), (120000, 100000, "-"), (99123, 100000, "-"),
             (100999, 100000, "+"), (79000, 100000, "+")]


@pytest.mark.parametrize("model", ["expecto", "basenji"])
def test_get_snp_bin_and_extract_bins_equal_jax(model):
    for snp, tss, strand in SNP_CASES + [(5000 + 70000, 5000, "+"), (5000, 5000, "-")]:
        try:
            want = jextract.get_snp_bin(snp, tss, strand, model)
        except AssertionError as e:
            with pytest.raises(AssertionError, match=re.escape(str(e))):
                textract.get_snp_bin(snp, tss, strand, model)
            continue
        assert textract.get_snp_bin(snp, tss, strand, model) == want
    with pytest.raises(AssertionError, match="not recognized"):
        textract.get_snp_bin(1, 1, "+", "enformer")
    preds = np.arange(3 * 200 * 4, dtype=np.float32).reshape(3, 200, 4)
    for center, flank in ((0, 50), (120, 10), (199, 50)):
        np.testing.assert_array_equal(textract.extract_bins(preds, center, flank),
                                      jextract.extract_bins(preds, center, flank))


def test_extract_consensus_track_bins_h5_round_trip_equal_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    preds = np.random.default_rng(9).normal(size=(3, 200, 10)).astype(np.float32)
    with h5py.File(tmp_path / "g_chromatin.h5", "w") as f:
        f.create_dataset("chromatin_preds", data=preds)
        f.create_dataset("record_ids", data=np.array([b"a|s1|-|h", b"a|s2|-|h", b"a|s3|-|h"]))
    args = (str(tmp_path / "g_chromatin.h5"), 100000 - 300, 100000, "-", [0, 3, 7])
    t = textract.extract_consensus_track_bins(*args, out_h5_path=str(tmp_path / "t.h5"), flank=20)
    j = jextract.extract_consensus_track_bins(*args, out_h5_path=str(tmp_path / "j.h5"), flank=20)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    with h5py.File(tmp_path / "t.h5") as ft, h5py.File(tmp_path / "j.h5") as fj:
        assert dict(ft.attrs) == dict(fj.attrs) and set(ft) == set(fj)
        for k in ft:
            np.testing.assert_array_equal(ft[k][()], fj[k][()])


# --------------------------------------------------------------------- FIMO

def test_variant_query_and_fimo_input_equal_jax(tmp_path):
    rng = np.random.default_rng(13)
    contigs = {c: "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)]) for c, n in (("chr1", 60000), ("chr2", 900))}
    write_fasta(tmp_path / "g.fa", contigs)
    tfa, jfa = FastaIndex(tmp_path / "g.fa"), JaxFastaIndex(tmp_path / "g.fa")
    rows = []
    for i, pos in enumerate((1000, 2500, 40000, 59990)):
        ref = contigs["chr1"][pos - 1]
        rows.append(["chr1", pos, f"rs{i}", ref, "N" if i % 2 else ref + "A"])
    rows.append(["chr2", 31, "rs9", contigs["chr2"][30:33], contigs["chr2"][30]])  # a deletion near the start
    vcf = pd.DataFrame(rows)
    tfimo.write_fimo_input(vcf, tfa, str(tmp_path / "t.fa"), bp_pad=12)
    jfimo.write_fimo_input(vcf, jfa, str(tmp_path / "j.fa"), bp_pad=12)
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    for mod, fa in ((jfimo, jfa), (tfimo, tfa)):
        with pytest.raises(AssertionError, match="does not match"):
            mod.variant_query_seq(fa, "chr1", 1000, "NN", "NN")


FIMO_ROWS = [["M1", "TF1", "rs1", 25, 35, "+", 10.0, 1e-5, 0.1, "AAA"], ["M1", "TF1", "rs1", 25, 33, "-", 12.0, 1e-6,
                                                                        0.1, "AAT"],
             ["M2", "TF2", "rs1", 1, 10, "+", 5.0, 1e-3, 0.5, "CCC"], ["M2", "TF2", "rs2", 30, 31, "+", 5.5, 2e-3, "",
                                                                       "CG"],
             ["M3", "TF3", "rs2", 31, 40, "-", 7.25, 3e-4, "", "GGTA"]]


@pytest.mark.parametrize("header", ["meme4", "meme5"])
def test_filter_fimo_results_equal_jax(tmp_path, header):
    lines = ["\t".join(map(str, r)) for r in FIMO_ROWS]
    if header == "meme5":
        lines.insert(0, "\t".join(tfimo.FIMO_COLUMNS))
    else:
        lines.insert(0, "#pattern name\tsequence name\tstart")
    (tmp_path / "f.txt").write_text("\n".join(lines) + "\n")
    for pad in (30, 9):
        pd.testing.assert_frame_equal(tfimo.filter_fimo_results(str(tmp_path / "f.txt"), bp_pad=pad),
                                      jfimo.filter_fimo_results(str(tmp_path / "f.txt"), bp_pad=pad))


def _enrich_tables(n_rows=24, n_clusters=8, seed=10):
    rng = np.random.default_rng(seed)
    names = [f"c{j}" for j in range(n_clusters)]
    rsat = pd.DataFrame({1: [",".join(f"m{k}" for k in rng.choice(12, int(rng.integers(1, 4)), replace=False))
                             for _ in names]}, index=names)
    lead = pd.DataFrame({str(i): 0 for i in range(15)}, index=range(n_rows))
    lead["2"] = [f"rs{i % 20}" for i in range(n_rows)]
    contribs = pd.concat([lead, pd.DataFrame(rng.normal(size=(n_rows, n_clusters)), columns=names)], axis=1)
    fimo = pd.DataFrame({"sequence_name": [f"rs{i}" for i in rng.integers(0, 20, 60)],
                         "motif_alt_id": [f"m{k}" for k in rng.integers(0, 12, 60)]})
    return contribs, fimo, rsat


@pytest.mark.parametrize("n_neg", [1, 3])
def test_cluster_contribs_hypergeom_equal_jax(n_neg):
    contribs, fimo, rsat = _enrich_tables()
    tdf, tuniq = tfimo.cluster_contribs_hypergeom(contribs, fimo, rsat, n_neg, return_unique_clusters=True)
    jdf, juniq = jfimo.cluster_contribs_hypergeom(contribs, fimo, rsat, n_neg, return_unique_clusters=True)
    pd.testing.assert_frame_equal(tdf, jdf)
    assert dict(tuniq) == dict(juniq) and len(tdf) == len(rsat) - n_neg
    pd.testing.assert_frame_equal(tfimo.cluster_contribs_hypergeom(contribs, fimo, rsat, n_neg),
                                  jfimo.cluster_contribs_hypergeom(contribs, fimo, rsat, n_neg))


@pytest.mark.parametrize("axis", [0, 1])
def test_shuffle_along_axis_draws_the_jax_stream(axis):
    a = np.arange(48.0).reshape(6, 8)
    np.random.seed(11)
    want = jfimo.shuffle_along_axis(a, axis=axis)
    got = tfimo.shuffle_along_axis(a, axis, np.random.RandomState(11))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, a)


def test_enriched_motif_set_equal_jax(tmp_path):
    (tmp_path / "h.tsv").write_text("motif\thypergeom_qval\nM1\t0.001\nM2\t0.5\nM3\t0.009\n")
    meme = ("MEME version 4\n\nALPHABET= ACGT\n\nMOTIF M1 TF1\nletter-probability matrix\n0.25 0.25 0.25 0.25\n\n"
            "MOTIF M2 TF2\nletter-probability matrix\n0.1 0.4 0.4 0.1\n\nMOTIF M3\nletter-probability matrix\n"
            "0.7 0.1 0.1 0.1\n")
    (tmp_path / "db.meme").write_text(meme)
    args = (str(tmp_path / "h.tsv"), str(tmp_path / "db.meme"))
    assert tfimo.extract_enriched_motif_set(*args, str(tmp_path / "t" / "o.meme")) == {"M1", "M3"}
    jfimo.extract_enriched_motif_set(*args, str(tmp_path / "j" / "o.meme"))
    assert (tmp_path / "t" / "o.meme").read_bytes() == (tmp_path / "j" / "o.meme").read_bytes()
    (tmp_path / "db.meme").write_text(meme.replace("MOTIF M3", "MOTIF M4"))
    for mod in (jfimo, tfimo):
        with pytest.raises(AssertionError, match="Did not find all motifs"):
            mod.extract_enriched_motif_set(*args, str(tmp_path / "x.meme"))


MEME = """MEME version 4

ALPHABET= ACGT

Background letter frequencies
A 0.3 C 0.2 G 0.2 T 0.3

MOTIF M1 TFA
letter-probability matrix: alength= 4 w= 3 nsites= 20 E= 0
 0.90 0.05 0.03 0.02
 0.02 0.03 0.05 0.90
 0.05 0.85 0.05 0.05
"""


def test_run_fimo_engine_rule_equal_jax(tmp_path, monkeypatch):
    """'meme' raises without the binary, 'auto' warns and takes the built-in
    scanner, 'builtin' always scans, anything else raises; the same text as
    the JAX package's."""
    import shutil

    (tmp_path / "m.meme").write_text(MEME)
    (tmp_path / "s.fa").write_text(">r1\nACGTATCGGATCNNATCG\n>r2\nttatcaag\n")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    args = (str(tmp_path / "m.meme"), str(tmp_path / "s.fa"))
    for mod in (jfimo, tfimo):
        with pytest.raises(RuntimeError, match="not found"):
            mod.run_fimo(*args, str(tmp_path / "x.txt"), engine="meme")
        with pytest.raises(ValueError, match="unknown fimo engine"):
            mod.run_fimo(*args, str(tmp_path / "x.txt"), engine="streme")
    with pytest.warns(UserWarning, match="built-in scanner"):
        assert tfimo.run_fimo(*args, str(tmp_path / "t_auto.txt")) == "builtin"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tfimo.run_fimo(*args, str(tmp_path / "t.txt"), engine="builtin") == "builtin"
        jfimo.run_fimo(*args, str(tmp_path / "j.txt"), engine="builtin")
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == want == (tmp_path / "t_auto.txt").read_bytes()


# ----------------------------------------------------------------- plotting

@pytest.mark.parametrize("plot", ["scatter_hist", "scatter_hist_one_point", "metric_hist", "distributions"])
def test_plotting_functions_write_their_files(tmp_path, plot):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(12)
    out = tmp_path / f"{plot}.png"
    if plot == "scatter_hist":
        tplot.plot_scatter_hist(rng.random(20), rng.random(20), out, xlabel="train", ylabel="valid")
    elif plot == "scatter_hist_one_point":
        tplot.plot_scatter_hist([0.5], [0.5], out, xlabel="train", ylabel="valid", highlight_last=False)
    elif plot == "metric_hist":
        tplot.plot_metric_hist(rng.random(30), out, xlabel="r2", title="r2")
    else:
        tplot.plot_expression_distributions(pd.DataFrame({"a": rng.gamma(2, 2, 30), "b": rng.gamma(1, 1, 30)}), out)
    assert out.exists() and out.stat().st_size > 0
