"""``python -m expecto_tpu_torch.cli.analysis`` vs ``expecto_tpu.cli.analysis``
on the CPU: both parsers hold the same 15 subcommands with the same option
strings, defaults, choices and required flags; each subcommand runs through
both CLIs on the same seeded inputs, and every file the two write is the
same: tables, text and FASTA byte for byte, npy arrays exactly, h5 files by
their datasets and attributes, joblib estimators by their fitted labels and
components, plots by name and non-zero size. The exit-2 cases return 2 in
both. ``fimo-enrich``'s shuffled tables are equal with and without
``--rank_int``, whose per-gene reseeding the port's explicit generator
reproduces; the basenji ``extract-dataset`` branch runs through its spawn
pool."""

import argparse
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.cli.analysis import main as jax_main
from expecto_tpu_torch.cli.analysis import main as port_main
from expecto_tpu_torch.genome.fasta import write_fasta
from expecto_tpu_torch.io.xgb import save_expression_model
from expecto_tpu_torch.models.gblinear import GBLinearModel
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

SUBCOMMANDS = ["interpret-features", "svd", "svd-transform", "cluster-viz", "collect-pwms", "fimo-query",
               "fimo-enrich", "enriched-motifs", "bootstrap-coefficients", "extract-consensus", "extract-dataset",
               "make-profile", "rank-int", "plot-metrics", "plot-distributions"]


class _Parsed(Exception):
    pass


def _parser(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its parse_args."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            main(["rank-int"])
    return seen["parser"]


def _spec(parser: argparse.ArgumentParser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: sorted((tuple(a.option_strings), a.dest, repr(a.default), a.required, repr(a.choices),
                          getattr(a.type, "__name__", repr(a.type)), type(a).__name__, a.nargs)
                         for a in sp._actions)
            for name, sp in sub.choices.items()}


def test_parsers_have_the_same_subcommands_flags_and_defaults(monkeypatch):
    jspec, tspec = _spec(_parser(jax_main, monkeypatch)), _spec(_parser(port_main, monkeypatch))
    assert list(tspec) == SUBCOMMANDS == list(jspec)
    for name in SUBCOMMANDS:
        assert tspec[name] == jspec[name], name
    assert not any("--device" in a[0] for spec in tspec.values() for a in spec)


def test_help_lists_the_fifteen_subcommands(capsys):
    with pytest.raises(SystemExit) as e:
        port_main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(name in out for name in SUBCOMMANDS)


def _h5_equal(a: Path, b: Path) -> None:
    import h5py

    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert dict(fa.attrs) == dict(fb.attrs) and set(fa) == set(fb)
        for k in fa:
            x, y = fa[k][()], fb[k][()]
            assert x.dtype == y.dtype and np.array_equal(x, y), (a, k)


def _joblib_equal(a: Path, b: Path) -> None:
    import joblib

    x, y = joblib.load(a), joblib.load(b)
    assert type(x).__name__ == type(y).__name__
    for attr in ("labels_", "children_", "components_", "singular_values_"):
        if hasattr(x, attr):
            assert np.array_equal(getattr(x, attr), getattr(y, attr)), (a, attr)


def assert_same_outputs(t: Path, j: Path, skip=("cache",)) -> list:
    """Every file under ``t`` and ``j`` (the port's and the JAX CLI's output
    directories) has its twin, with the same contents; returns the relative
    paths compared."""
    def files(root):
        return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file()
                      and not any(part in skip for part in p.relative_to(root).parts))

    names = files(t)
    assert names == files(j) and names, (names, files(j))
    for rel in names:
        a, b = t / rel, j / rel
        if rel.suffix == ".npy":
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        elif rel.suffix == ".h5":
            _h5_equal(a, b)
        elif rel.suffix == ".joblib":
            _joblib_equal(a, b)
        elif rel.suffix in (".png", ".pdf"):
            assert a.stat().st_size > 0 and b.stat().st_size > 0, rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    return names


def run_both(tmp_path, argv, *, out_flag="-o", out_name="out", expect=0) -> tuple[Path, Path]:
    """``argv`` through both CLIs, each with its own output path (``None``
    for ``out_flag``: the output path is argv's last item, rewritten);
    returns (port output, JAX output)."""
    outs = []
    for tag, main in (("t", port_main), ("j", jax_main)):
        out = tmp_path / tag / out_name
        out.parent.mkdir(parents=True, exist_ok=True)
        full = [*argv, out_flag, str(out)] if out_flag else [*argv, str(out)]
        assert main(full) == expect, (tag, full)
        outs.append(out)
    return outs[0], outs[1]


def _beluga_tsv(path, assays, kinds, cells=None):
    rows = ["\t".join(["i", "Cell type", "Assay", "Treatment", "Assay type", "Source"])]
    for i, (assay, kind) in enumerate(zip(assays, kinds)):
        rows.append("\t".join([str(i), cells[i] if cells else f"cell{i}", assay, "None", kind, "ENCODE"]))
    path.write_text("\n".join(rows) + "\n")


# ------------------------------------------------ clustering (scikit-learn)

@pytest.fixture(scope="module")
def interpret_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("interp")
    rng = np.random.default_rng(0)
    n_genes, n_marks = 40, 4
    np.save(d / "X.npy", rng.normal(size=(n_genes, 10 * n_marks)).astype(np.float32))
    pd.DataFrame({"id": [f"G{i}" for i in range(n_genes)], "symbol": "s",
                  "seqnames": ["chr1"] * 30 + ["chr8"] * 5 + ["chrX"] * 5, "strand": "+",
                  "TSS": np.arange(n_genes), "CAGE_representative_TSS": np.arange(n_genes),
                  "type": ["protein_coding"] * 35 + ["lincRNA"] * 5}).to_csv(d / "anno.csv", index=False)
    exp = np.exp(rng.normal(size=n_genes))
    exp[0] = -1.0
    pd.DataFrame({"gene": [f"G{i}" for i in range(n_genes)], "t1": exp}).to_csv(d / "exp.csv", index=False)
    _beluga_tsv(d / "beluga.tsv", [f"TF{i}" for i in range(n_marks)], ["TF"] * n_marks)
    return d


@pytest.mark.parametrize("extra", [[], ["--grouped", "--n_clusters", "2"], ["--clustering_with_distances"],
                                   ["--filterStr", "pc"]], ids=["features", "grouped", "distances", "pc"])
def test_interpret_features_equal(tmp_path, interpret_inputs, extra):
    pytest.importorskip("sklearn")
    d = interpret_inputs
    argv = ["interpret-features", "--inputFile", str(d / "X.npy"), "--annoFile", str(d / "anno.csv"),
            "--belugaFeatures", str(d / "beluga.tsv"), "--expFile", str(d / "exp.csv"), "--targetIndex", "1",
            "--n_clusters", "3", *extra]
    t, j = run_both(tmp_path, argv, out_flag="--out_dir")
    names = assert_same_outputs(t, j)
    assert Path("all_feature_clusters.tsv") in names
    if not extra:  # a fitted clustering reloaded: the same table again
        joblib_file = t / "clustering_cached.joblib"
        t2, j2 = run_both(tmp_path / "again", [*argv, "--clustering_joblib", str(joblib_file)], out_flag="--out_dir")
        assert_same_outputs(t2, j2)
        assert (t2 / "all_feature_clusters.tsv").read_bytes() == (t / "all_feature_clusters.tsv").read_bytes()


@pytest.fixture(scope="module")
def replicate_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rep")
    rng = np.random.default_rng(1)
    (d / "rep").mkdir()
    (d / "empty").mkdir()
    for g in range(6):
        np.save(d / "rep" / f"gene{g}.npy", np.abs(rng.normal(size=(20, 8))).astype(np.float32))
    _beluga_tsv(d / "beluga.tsv", [f"TF{i}" for i in range(8)], ["TF"] * 5 + ["DNase", "Histone", "TF"])
    return d


@pytest.mark.parametrize("method", ["kmeans", "louvain"])
def test_svd_transform_and_cluster_viz_equal(tmp_path, replicate_inputs, method):
    pytest.importorskip("sklearn")
    d = replicate_inputs
    mask = ["--belugaFeatures", str(d / "beluga.tsv"), "--no_dnase_features", "--no_histone_features"]
    t, j = run_both(tmp_path / "svd", ["svd", str(d / "rep"), "--n_components", "3", *mask], out_flag="--out_dir")
    assert_same_outputs(t, j)
    tt, jt = run_both(tmp_path / "svdt", ["svd-transform", str(d / "rep"), str(t / "svd_3.joblib"), *mask])
    assert_same_outputs(tt, jt)
    assert np.load(tt / "tf_idf_reduced_3.npy").shape == (6, 3)
    viz = ["--method", "louvain"] if method == "louvain" else ["--k", "2"]
    tc, jc = run_both(tmp_path / "cv", ["cluster-viz", str(tt), "--n_pcs", "3", *viz, *mask], out_flag="--out_dir")
    assert_same_outputs(tc, jc)


@pytest.mark.parametrize("method", [["--method", "louvain"], ["--k", "2", "--tsne"]], ids=["louvain", "kmeans_tsne"])
def test_cluster_viz_mark_tables_and_exit_2(tmp_path, replicate_inputs, method):
    if "--tsne" in method:
        pytest.importorskip("sklearn")
        pytest.importorskip("matplotlib")
    d = replicate_inputs
    rng = np.random.default_rng(2)
    emb = np.concatenate([rng.normal(c, 0.05, (20, 4)) for c in (0.0, 8.0)])
    np.save(tmp_path / "emb.npy", emb)
    feats = tmp_path / "feats.tsv"
    _beluga_tsv(feats, [f"TF{i}" for i in range(40)], ["TF"] * 40)
    t, j = run_both(tmp_path / "ok", ["cluster-viz", str(tmp_path / "emb.npy"), *method,
                                      "--belugaFeatures", str(feats)], out_flag="--out_dir")
    assert_same_outputs(t, j)
    labels = pd.read_csv(t / "clusters.tsv", sep="\t", index_col=0)["cluster"].to_numpy()
    assert len(set(labels[:20])) == len(set(labels[20:])) == 1 and labels[0] != labels[-1]
    # mask rows != embedding rows; a directory without an embedding; svd on a directory without npy files
    if "--tsne" in method:
        return
    run_both(tmp_path / "bad", ["cluster-viz", str(tmp_path / "emb.npy"), "--method", "louvain", "--belugaFeatures",
                                str(d / "beluga.tsv")], out_flag="--out_dir", expect=2)
    run_both(tmp_path / "bad2", ["cluster-viz", str(d / "empty"), "--method", "louvain"], out_flag="--out_dir",
             expect=2)
    run_both(tmp_path / "bad3", ["svd", str(d / "empty"), "--belugaFeatures", str(d / "beluga.tsv")],
             out_flag="--out_dir", expect=2)


# ------------------------------------------------------------------- motifs

@pytest.mark.parametrize("lambert", [False, True], ids=["tf_assays", "lambert_hgnc"])
def test_collect_pwms_equal(tmp_path, lambert):
    assays = ["CTCF", "Gata1", "DNase", "MYC", "Pol2", "RENAMED"]
    _beluga_tsv(tmp_path / "beluga.tsv", assays, ["TF", "TF", "DNase", "TF", "TF", "TF"])
    db = tmp_path / "jaspar_db"
    db.mkdir()
    for i, name in enumerate(["CTCF", "GATA1", "Gata1::Tal1", "MYC", "NEWNAME"]):
        (db / f"MA{i:04d}.1.jaspar").write_text(f">MA{i:04d}.1 {name}\nA [ 1 2 3 ]\nC [ 4 5 6 ]\nG [ 7 8 9 ]\n"
                                                f"T [ {i} 1 1 ]\n")
    (tmp_path / "hoco.jaspar").write_text(">H1 CTCF_HUMAN.H11MO.0.A\nA [ 1 1 ]\nC [ 1 1 ]\nG [ 1 1 ]\nT [ 1 1 ]\n"
                                          ">H2 MYC_HUMAN.H11MO.0.B\nA [ 2 2 ]\nC [ 1 1 ]\nG [ 1 1 ]\nT [ 1 1 ]\n")
    argv = ["collect-pwms", "--belugaFeatures", str(tmp_path / "beluga.tsv"), "--jaspar_motif_db", str(db),
            "--hocomoco_jaspar_motif_file", str(tmp_path / "hoco.jaspar")]
    if lambert:
        pd.DataFrame({"Approved symbol": ["CTCF", "NEWNAME", "GATA1"]}).to_csv(tmp_path / "lambert.csv")
        pd.DataFrame({"assay": ["CTCF", "Gata1", "RENAMED", "MYC"],
                      "Match type": ["Approved symbol", "Approved symbol", "Previous symbol", "Approved symbol"],
                      "Approved symbol": ["CTCF", "GATA1", "NEWNAME", "MYC"]}).set_index("assay").to_csv(
            tmp_path / "mapping.csv")
        argv += ["--lambert_hgnc", str(tmp_path / "lambert.csv"), "--hgnc_mapping", str(tmp_path / "mapping.csv")]
    t, j = run_both(tmp_path, argv, out_flag="--out_dir")
    assert_same_outputs(t, j)
    text = (t / "cluster_motifs.jaspar").read_text()
    assert ("NEWNAME" in text) == lambert and ("MYC" in text) != lambert and "Tal1" not in text


def _meme(rng, n_motifs=6) -> str:
    out = ["MEME version 4", "", "ALPHABET= ACGT", "", "Background letter frequencies",
           "A 0.3 C 0.2 G 0.2 T 0.3", ""]
    for m in range(n_motifs):
        w = int(rng.integers(3, 8))
        out += [f"MOTIF M{m} m{m}", f"letter-probability matrix: alength= 4 w= {w} nsites= 20 E= 0"]
        out += [" " + " ".join(f"{p:.4f}" for p in row) for row in rng.dirichlet([0.3] * 4, size=w)] + [""]
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def fimo_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fimo")
    rng = np.random.default_rng(3)
    seq = np.array(list("ACGT"))[rng.integers(0, 4, 6000)]
    seq[3000:3005] = "N"
    seq = "".join(seq)
    write_fasta(d / "g.fa", {"chr1": seq})
    rows = [f"chr1\t{pos}\trs{i}\t{seq[pos - 1]}\t{'ACGT'[i % 4]}\t.\t.\t." for i, pos in
            enumerate(range(200, 5800, 400))]
    (d / "in.vcf").write_text("##fileformat=VCFv4.2\n" + "\n".join(rows) + "\n")
    (d / "m.meme").write_text(_meme(rng))
    return d


@pytest.mark.parametrize("chunk", [None, 1], ids=["all", "chunk_1"])
def test_fimo_query_builtin_byte_for_byte(tmp_path, fimo_inputs, chunk):
    d = fimo_inputs
    argv = ["fimo-query", "--vcf_file", str(d / "in.vcf"), "--motif_file", str(d / "m.meme"),
            "--hg19_fasta", str(d / "g.fa"), "--fimo_engine", "builtin", "--bp_pad", "20"]
    if chunk is not None:
        argv += ["--chunk_size", "5", "--chunk_i", str(chunk)]
    t, j = run_both(tmp_path, argv)
    names = assert_same_outputs(t, j)
    assert [str(n) for n in names] == ["fimo_filtered.tsv", "fimo_in.fasta", "fimo_out.txt"]
    assert (t / "fimo_in.fasta").read_text().count(">") == (14 if chunk is None else 5)
    run_both(tmp_path / "bad", [*argv[:9], "--chunk_i", "1"], expect=2)


@pytest.fixture(scope="module")
def enrich_inputs(tmp_path_factory):
    """A predict_by_cluster RSAT table (the port's score_sed_with_clusters
    layout: index, five VCF columns, dist, gene, strand, REF, ALT, SED,
    SED_PROPORTION, then the cluster columns) of 60 variants over 7 genes
    (ties in SED), an RSAT cluster -> motif table and a FIMO text table."""
    d = tmp_path_factory.mktemp("enrich")
    rng = np.random.default_rng(4)
    n, clusters = 60, [f"rsat_{k}" for k in range(9)]
    ref = rng.normal(2.0, 0.5, n)
    sed = np.round(rng.normal(0, 0.1, n), 2)
    df = pd.DataFrame({"index": range(n), "0": "chr1", "1": rng.integers(1, 10**6, n),
                       "2": [f"rs{i}" for i in range(n)], "3": "A", "4": "C", "dist": rng.integers(-9000, 9000, n),
                       "gene": [f"ENSG{i % 7}" for i in range(n)], "strand": "+", "REF": ref, "ALT": ref + sed,
                       "SED": sed, "SED_PROPORTION": np.abs(sed / (ref + sed / 2))})
    props = rng.dirichlet([1.0] * len(clusters), size=n)
    df = pd.concat([df, pd.DataFrame(props, columns=clusters)], axis=1)
    df.to_csv(d / "sed.tsv", sep="\t", index=False)
    (d / "rsat.tsv").write_text("".join(f"{c}\t{','.join(f'm{k}' for k in rng.choice(10, 3, replace=False))}\n"
                                        for c in clusters))
    rows = []
    for i in range(n):
        for k in rng.choice(10, int(rng.integers(0, 5)), replace=False):
            start = int(rng.integers(20, 32))
            rows.append([f"M{k}", f"m{k}", f"rs{i}", start, start + 6, "+-"[int(k) % 2], 8.5,
                         float(10.0 ** -rng.uniform(3, 7)), "", "ACGTAC"])
    (d / "fimo_out.txt").write_text("\n".join("\t".join(map(str, r)) for r in rows) + "\n")
    return d


@pytest.mark.parametrize("rank_int", [False, True], ids=["sed_proportion", "rank_int"])
def test_fimo_enrich_tables_equal(tmp_path, enrich_inputs, rank_int):
    d = enrich_inputs
    argv = ["fimo-enrich", "--cluster_contribs_file", str(d / "sed.tsv"), "--rsat_clusters_file",
            str(d / "rsat.tsv"), "--fimo_out_file", str(d / "fimo_out.txt"), "--n_neg_clusters", "3", "--no_plots",
            *(["--rank_int"] if rank_int else [])]
    t, j = run_both(tmp_path, argv)
    names = {str(n) for n in assert_same_outputs(t, j)}
    assert {"hypergeom.tsv", "hypergeom_shuffled_clusters.tsv", "hypergeom_shuffled_variants.tsv",
            "num_unique_clusters.tsv"} | {f"hypergeom_percentile_{p}_{p + 25}.tsv" for p in (0, 25, 50, 75)} == names
    for name in names - {"num_unique_clusters.tsv"}:
        p = pd.read_csv(t / name, sep="\t")["hypergeom_pval"]
        assert len(p) == 6 and np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()


def test_fimo_enrich_rank_int_shuffles_follow_the_last_genes_reseed(tmp_path, enrich_inputs):
    """With --rank_int the null shuffles draw from the state the last
    gene's reseed-and-permute left, not from seed 1: drawing them from a
    fresh seed-1 generator gives another table (so the equality above
    reproduces the quirk, not a coincidence)."""
    from expecto_tpu_torch.analysis.fimo import FIMO_COLUMNS, cluster_contribs_hypergeom, shuffle_along_axis

    d = enrich_inputs
    t, _ = run_both(tmp_path, ["fimo-enrich", "--cluster_contribs_file", str(d / "sed.tsv"), "--rsat_clusters_file",
                               str(d / "rsat.tsv"), "--fimo_out_file", str(d / "fimo_out.txt"), "--n_neg_clusters",
                               "3", "--no_plots", "--rank_int"])
    contribs = pd.read_csv(d / "sed.tsv", sep="\t", index_col=0).reset_index(drop=True)
    rsat = pd.read_csv(d / "rsat.tsv", sep="\t", header=None, index_col=0)
    fimo = pd.read_table(d / "fimo_out.txt", sep="\t", names=FIMO_COLUMNS, comment="#")
    fimo = fimo[(fimo["start"] <= 31) & (fimo["stop"] >= 31)].sort_values(by="p-value").drop_duplicates(
        subset=["motif_id", "motif_alt_id", "sequence_name"], keep="first")
    fimo = fimo[fimo["p-value"] < 1e-4]
    contribs = contribs.drop("SED", axis=1)
    start = contribs.columns.tolist().index("rsat_0")
    shuf = contribs.copy()
    shuf.iloc[:, start:] = shuffle_along_axis(shuf.iloc[:, start:].values, 1, np.random.RandomState(1))
    fresh = cluster_contribs_hypergeom(shuf, fimo, rsat, 3, id_col=2, contrib_start_col=start)
    written = pd.read_csv(t / "hypergeom_shuffled_clusters.tsv", sep="\t")
    assert not fresh.equals(written)


def test_enriched_motifs_equal(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "db.meme").write_text(_meme(rng, n_motifs=8))
    q = rng.random(8) / 20
    pd.DataFrame({"hypergeom_qval": q}, index=pd.Index([f"M{k}" for k in range(8)], name="motif")).to_csv(
        tmp_path / "h.tsv", sep="\t")
    t, j = run_both(tmp_path, ["enriched-motifs", "--hypergeom_enrichment_tsv", str(tmp_path / "h.tsv"),
                               "--motif_db_file", str(tmp_path / "db.meme"), "--qval_thresh", "0.02"])
    assert_same_outputs(t, j)
    text = (t / "enriched_motifs.meme").read_text()
    assert {ln.split()[1] for ln in text.splitlines() if ln.startswith("MOTIF")} == {f"M{k}" for k in
                                                                                     np.flatnonzero(q < 0.02)}


# ------------------------------------------------------ bootstrap, profiles

@pytest.mark.parametrize("plots", [False, True], ids=["no_plots", "plots"])
def test_bootstrap_coefficients_equal(tmp_path, plots):
    if plots:
        pytest.importorskip("matplotlib")
    rng = np.random.default_rng(6)
    n_marks = 5
    true_w = rng.normal(size=10 * n_marks).astype(np.float32)
    for seed in range(11):
        d = tmp_path / "boot" / f"seed_{seed}"
        d.mkdir(parents=True)
        save_expression_model(GBLinearModel(weight=(true_w + rng.normal(scale=0.2, size=true_w.size)).astype(
            np.float32), bias=0.01 * seed), d / "model.save")
    save_expression_model(GBLinearModel(weight=true_w, bias=0.1), tmp_path / "main.save")
    pd.DataFrame({"Assay": np.repeat([f"m{i}" for i in range(n_marks)], 10), "coeff_idx": np.tile(np.arange(10),
                                                                                                  n_marks)}).to_csv(
        tmp_path / "feats.tsv", sep="\t")
    argv = ["bootstrap-coefficients", "--bootstrap_model_dir", str(tmp_path / "boot"), "--main_model",
            str(tmp_path / "main.save"), "--input_features_file", str(tmp_path / "feats.tsv"), "--limit", "9",
            "--top_k_cv_hists", "3", *([] if plots else ["--no_plots"])]
    t, j = run_both(tmp_path / "run", argv)
    names = assert_same_outputs(t, j)
    assert len(names) == (5 if plots else 2)
    run_both(tmp_path / "none", ["bootstrap-coefficients", "--bootstrap_model_dir", str(tmp_path / "boot"),
                                 "--pattern", "*.nothing", *argv[3:]], expect=2)


@pytest.mark.parametrize("extra", [["--rank_match_col", "t1"], ["--on", "symbol", "--columns", "t2,t1"],
                                   ["--log2_offset", "0.5", "--rank_match_col", "t2"]],
                         ids=["rank_match", "symbol_columns", "log2"])
def test_make_profile_equal(tmp_path, extra):
    rng = np.random.default_rng(7)
    n = 30
    pd.DataFrame({"id": [f"E{i}" for i in range(n)], "symbol": [f"S{i}" for i in range(n)]}).set_index("id").to_csv(
        tmp_path / "anno.csv")
    keep = rng.permutation(n)[:24]
    index = [f"S{i}" for i in keep] if "symbol" in extra else [f"E{i}" for i in keep]
    counts = pd.DataFrame({"t1": rng.gamma(2, 3, 24), "t2": rng.gamma(1, 2, 24), "t3": rng.integers(0, 9, 24)},
                          index=index)
    counts.to_csv(tmp_path / "counts.tsv", sep="\t")
    t, j = run_both(tmp_path, ["make-profile", "--annoFile", str(tmp_path / "anno.csv"), "--countsFile",
                               str(tmp_path / "counts.tsv"), *extra], out_name="exp.csv")
    assert t.read_bytes() == j.read_bytes()


@pytest.fixture(scope="module")
def sed_table(tmp_path_factory):
    d = tmp_path_factory.mktemp("rint")
    rng = np.random.default_rng(8)
    sed = np.round(rng.normal(size=80), 1)
    sed[[3, 40]] = np.nan
    pd.DataFrame({"gene": [f"g{i % 6}" for i in range(80)], "SED": sed, "other": 1}).to_csv(d / "sed.tsv", sep="\t",
                                                                                          index=False)
    return d / "sed.tsv"


@pytest.mark.parametrize("extra", [[], ["--deterministic"], ["--group_by", "gene"],
                                   ["--group_by", "gene", "--deterministic", "--blom_c", "0.5"]],
                         ids=["stochastic", "deterministic", "grouped", "grouped_deterministic"])
def test_rank_int_equal(tmp_path, sed_table, extra):
    t, j = run_both(tmp_path, ["rank-int", str(sed_table), "--column", "SED", *extra], out_name="out.tsv")
    assert t.read_bytes() == j.read_bytes()
    run_both(tmp_path / "bad", ["rank-int", str(sed_table), "--column", "SED", "--group_by", "tissue"],
             out_name="x.tsv", expect=2)


# ------------------------------------------------------- h5 and plot paths

def _chromatin_h5(path, seed=9):
    import h5py

    preds = np.random.default_rng(seed).normal(size=(3, 200, 10)).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("chromatin_preds", data=preds)
        f.create_dataset("record_ids", data=np.array([b"a|NA0|-|h", b"a|NA1|-|h", b"a|NA2|-|h"]))


@pytest.mark.parametrize("tracks", ["0,3,7", "GM12878", "HeLa"], ids=["indices", "cell_type", "no_match"])
def test_extract_consensus_equal(tmp_path, tracks):
    pytest.importorskip("h5py")
    _chromatin_h5(tmp_path / "g_chromatin.h5")
    _beluga_tsv(tmp_path / "beluga.tsv", [f"TF{i}" for i in range(10)], ["TF"] * 10,
                cells=["GM12878" if i in (2, 5) else "K562" for i in range(10)])
    argv = ["extract-consensus", "--chromatin_h5", str(tmp_path / "g_chromatin.h5"), "--snp_pos", "99700",
            "--tss_pos", "100000", "--strand", "-", "--tracks", tracks, "--belugaFeatures",
            str(tmp_path / "beluga.tsv"), "--flank", "7"]
    t, j = run_both(tmp_path, argv, out_name="out.h5", expect=2 if tracks == "HeLa" else 0)
    if tracks != "HeLa":
        _h5_equal(t, j)
    else:  # name-based selection without the features table
        run_both(tmp_path / "nofeat", argv[:-4] + ["--flank", "7"], out_name="x.h5", expect=2)


def _gene_tables(d, gene="hla-b", tss=100000):
    pd.DataFrame({"name": [gene.upper(), gene.upper()], "SNP_ID": ["rs1", "rs2"], "SNPpos": [tss + 100, tss - 5000],
                  "TSSpos_x": [tss, tss]}).to_csv(d / "eqtls.csv")
    pd.DataFrame([["ENSG1", "chr6", tss, gene.upper(), "+"]]).to_csv(d / "genes.csv", header=False, index=False)
    _beluga_tsv(d / "beluga.tsv", [f"TF{i}" for i in range(10)], ["TF"] * 10,
                cells=["GM12878" if i in (2, 5) else "K562" for i in range(10)])


@pytest.mark.parametrize("mode", ["snp", "tss", "50_bins"])
def test_extract_dataset_expecto_equal(tmp_path, mode):
    import h5py  # noqa: F401 (the per-gene h5 inputs)

    (tmp_path / "expecto" / "hla-b").mkdir(parents=True)
    _chromatin_h5(tmp_path / "expecto" / "hla-b" / "hla-b_chromatin.h5")
    _gene_tables(tmp_path)
    argv = ["extract-dataset", "--model", "expecto", "--extract_mode", mode, "--eqtls_csv", str(tmp_path / "eqtls.csv"),
            "--genes_csv", str(tmp_path / "genes.csv"), "--expecto_preds_dir", str(tmp_path / "expecto"),
            "--beluga_features_tsv", str(tmp_path / "beluga.tsv")]
    t, j = run_both(tmp_path, argv, out_flag="--out_dir")
    assert_same_outputs(t, j)
    run_both(tmp_path / "bad", argv[:9], out_flag="--out_dir", expect=2)


def _basenji_tree(d):
    import h5py

    rng = np.random.default_rng(10)
    sd = d / "basenji" / "hla-b" / "all_bins_per_sample"
    sd.mkdir(parents=True)
    for s in ("NA0", "NA1", "NA2"):
        with h5py.File(sd / f"{s}.h5", "w") as f:
            f.create_dataset("all_preds", data=rng.normal(size=(896, 8)).astype(np.float32))
    rows = ["\t".join(["index", "identifier", "description"])]
    rows += ["\t".join([str(i), f"CNhs{i}", "CAGE:GM12878" if i in (1, 6) else "CAGE:K562"]) for i in range(8)]
    (d / "targets.tsv").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("mode", ["snp", "tss", "50_bins"])
def test_extract_dataset_basenji_equal(tmp_path, mode):
    pytest.importorskip("h5py")
    _basenji_tree(tmp_path)
    _gene_tables(tmp_path)
    argv = ["extract-dataset", "--model", "basenji", "--extract_mode", mode, "--eqtls_csv", str(tmp_path / "eqtls.csv"),
            "--genes_csv", str(tmp_path / "genes.csv"), "--basenji_preds_dir", str(tmp_path / "basenji"),
            "--targets_file", str(tmp_path / "targets.tsv")]
    t, j = run_both(tmp_path, argv, out_flag="--out_dir")
    assert_same_outputs(t, j)
    run_both(tmp_path / "bad", argv[:9], out_flag="--out_dir", expect=2)


def test_extract_dataset_basenji_pool_equals_the_sequential_jax_run(tmp_path):
    """The port's spawn pool (--processes 2) writes what the JAX CLI writes
    in one process."""
    pytest.importorskip("h5py")
    _basenji_tree(tmp_path)
    _gene_tables(tmp_path)
    argv = ["extract-dataset", "--model", "basenji", "--extract_mode", "snp", "--eqtls_csv",
            str(tmp_path / "eqtls.csv"), "--genes_csv", str(tmp_path / "genes.csv"), "--basenji_preds_dir",
            str(tmp_path / "basenji"), "--targets_file", str(tmp_path / "targets.tsv"), "--out_dir"]
    assert port_main([*argv, str(tmp_path / "t"), "--processes", "2"]) == 0
    assert jax_main([*argv, str(tmp_path / "j")]) == 0
    assert len(assert_same_outputs(tmp_path / "t", tmp_path / "j")) == 2


def test_plot_metrics_equal(tmp_path):
    h5py = pytest.importorskip("h5py")
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(11)
    with h5py.File(tmp_path / "metrics.h5", "w") as f:
        for m in ("pearsonr", "r2"):
            f.create_dataset(f"{m}_trains", data=rng.random(12))
            f.create_dataset(f"{m}_valids", data=rng.random(12))
        f.create_dataset("tissues", data=np.array([f"t{i}".encode() for i in range(12)]))
    t, j = run_both(tmp_path, ["plot-metrics", str(tmp_path / "metrics.h5")])
    assert {str(n) for n in assert_same_outputs(t, j)} == {"pearsonr_trains_hist.png", "pearsonr_valids_hist.png",
                                                           "r2_trains_hist.png", "r2_valids_hist.png",
                                                           "pearsonr.png", "r2.png"}


@pytest.mark.parametrize("kidney", [None, "all_genes", "kidney_genes_only"])
def test_plot_distributions_equal(tmp_path, kidney):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(12)
    n = 30
    pd.DataFrame({"symbol": [f"s{i}" for i in range(n)], "t1": np.exp(rng.normal(size=n)),
                  "t2": np.exp(rng.normal(size=n))}).to_csv(tmp_path / "exp.csv", index=False)
    kid = pd.DataFrame({"PT": np.exp(rng.normal(size=n)), "LOH": np.exp(rng.normal(size=n))},
                       index=[f"G{i}" for i in range(n)])
    kid.iloc[3, 0] = np.nan
    kid.to_csv(tmp_path / "kidney.csv")
    argv = ["plot-distributions", "--expFile", str(tmp_path / "exp.csv")]
    if kidney:
        argv += ["--kidney_exp_file", str(tmp_path / "kidney.csv"), "--expecto_column", "t2"]
        argv += ["--kidney_genes_only"] if kidney == "kidney_genes_only" else []
    t, j = run_both(tmp_path, argv)
    names = {str(n) for n in assert_same_outputs(t, j)}
    assert "expression_distributions.png" in names and ("scatter_PT_vs_t2.png" in names) == bool(kidney)
    if kidney is None:
        run_both(tmp_path / "bad", [*argv, "--kidney_genes_only"], expect=2)
