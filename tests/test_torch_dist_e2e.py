"""The port's serving-side CLIs across a real 2-process ``torch.distributed``
group on the CPU (torchrun, gloo), each against its own 1-process run on
the same arguments: rows shard per rank, shard files are merged by rank 0
or per-row scalars exchanged, and no shard or exchange file is left behind
(the JAX package's tests/test_dist_e2e.py, at narrow Beluga widths; the
training CLI's groups are in tests/test_torch_dist.py).

Equality. The merges and exchanges move rows bit for bit, but a rank's
device chunks hold other rows than one process's, and torch's CPU GEMM
(fc1, the host model products) may sum a row in another order for another
row count. Where that shows, the test states its tolerance:
- byte for byte: the features ``.npy`` and ``--replicate_raw`` files,
  ``sed.tsv`` and its sorted tables, the bf16 ``output.csv``;
- chromatin h5 track probabilities: 1e-6 absolute (measured 6e-8, one or
  two fp32 ulps; the JAX test asserts bit equality);
- fp32 ``output.csv``: REF/ALT rtol 1e-5 (measured 2.8e-6), SED 1e-5 of
  max|REF| (the port's fp32 SED limit); the ``--modelList`` effects 1e-6
  absolute;
- consensus predictions: the JAX e2e's own atol 1e-4, rtol 1e-5.
Row order and every non-float column are exact everywhere."""

import gzip
import json
import os

import h5py
import numpy as np
import pandas as pd
import pytest

from expecto_tpu_torch.genome.fasta import write_fasta
from expecto_tpu_torch.io.xgb import save_xgb07_binary
from expecto_tpu_torch.models.convert import save_params_npz
from expecto_tpu_torch.models.gblinear import GBLinearModel
from expecto_tpu_torch.pipeline.consensus import ENFORMER_SEQ_LENGTH
from torch_port_common import (  # noqa: F401 (autouse fixture)
    DIST_WORKER,
    N_TRACKS,
    narrow_params,
    sed_atol,
    serving_tables,
    single_torch_thread,
    torchrun,
    write_models,
)

MAXSHIFT = 400


def no_leftovers(d) -> None:
    left = [f for f in os.listdir(d) if "shard" in f or "exchange" in f]
    assert not left, f"shard or exchange files left in {d}: {left}"


@pytest.fixture(scope="module")
def inputs(tiny_genome, tmp_path_factory):
    """Genome, narrow weights, serving VCF and genes, two models."""
    fa, contigs = tiny_genome
    d = tmp_path_factory.mktemp("dist_e2e")
    write_fasta(d / "g.fa", contigs)
    save_params_npz(narrow_params(3), d / "beluga.npz")
    rows, gene_rows = serving_tables(contigs["chr1"])
    pd.DataFrame(rows).to_csv(d / "in.vcf", sep="\t", header=False, index=False)
    pd.DataFrame(gene_rows).to_csv(d / "genes.tsv", sep="\t", header=False, index=False)
    models = write_models(d, save_xgb07_binary, GBLinearModel)
    (d / "modellist").write_text("ModelName\tTissue\n" + "".join(f"{p}\tT{j}\n" for j, p in enumerate(models)))
    return d, models


def assert_csv_close(got_path, want_path, rtol: float, atol) -> None:
    """Same columns and rows; non-float columns exact; each float column
    within rtol and ``atol(column name, want table)``."""
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns) and got.shape == want.shape
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=rtol, atol=atol(col, want), err_msg=col)
        else:
            assert list(got[col]) == list(want[col]), col


def _both(main, args: list[str], single_dir, group_dir, module: str) -> None:
    """``args`` + the output flags once in this process and once as a
    2-rank group."""
    assert main(args(single_dir)) == 0
    torchrun(["-m", module, *args(group_dir)])


@pytest.fixture(scope="module")
def chromatin_runs(inputs, tmp_path_factory):
    """The chromatin CLI in one process and as a 2-rank group."""
    from expecto_tpu_torch.cli.chromatin import main

    d, _models = inputs
    tmp_path = tmp_path_factory.mktemp("chromatin")
    single, group = tmp_path / "single", tmp_path / "group"
    _both(main, lambda o: [str(d / "in.vcf"), "--genome", str(d / "g.fa"), "--beluga_weights", str(d / "beluga.npz"),
                           "--maxshift", str(MAXSHIFT), "--batchsize", "48", "--legacy_h5", "--output_dir", str(o),
                           "--device", "cpu"],
          single, group, "expecto_tpu_torch.cli.chromatin")
    return single, group


def test_chromatin_cli(chromatin_runs):
    """Shard h5s merged with fold 2 hold the 1-process rows in the [fwd; rc]
    layout; the side VCF is written once."""
    single, group = chromatin_runs
    names = sorted(os.listdir(single))
    assert sorted(os.listdir(group)) == names and len(names) == 1 + 2 * (2 * MAXSHIFT // 200 + 1)
    no_leftovers(group)
    assert (single / "snps_hg19.vcf").read_text() == (group / "snps_hg19.vcf").read_text()
    for name in names:
        if name.endswith(".h5"):
            with h5py.File(single / name) as f1, h5py.File(group / name) as f2:
                assert sorted(f1) == sorted(f2)
                for key in f1:
                    assert f1[key].shape == f2[key].shape == (2 * 6, N_TRACKS)
                    np.testing.assert_allclose(f2[key][...], f1[key][...], rtol=0, atol=1e-6,
                                               err_msg=f"{name}/{key}")


@pytest.mark.parametrize("flags", [["--fp32"], []], ids=["fp32", "bf16"])
def test_score_cli(inputs, tmp_path, flags):
    """Per-row REF/ALT/SED exchanged exactly; rank 0 writes output.csv with
    the 1-process rows in their order (bf16: byte for byte)."""
    from expecto_tpu_torch.cli.score import main

    d, _models = inputs
    single, group = tmp_path / "single", tmp_path / "group"
    single.mkdir()
    group.mkdir()
    _both(main, lambda o: [str(d / "in.vcf"), "--geneFile", str(d / "genes.tsv"), "--modelList", str(d / "modellist"),
                           "--genome", str(d / "g.fa"), "--beluga_weights", str(d / "beluga.npz"), "--maxshift",
                           str(MAXSHIFT), "--batchsize", "64", "--device", "cpu", "--output", str(o / "output.csv"),
                           *flags],
          single, group, "expecto_tpu_torch.cli.score")
    a, b = (single / "output.csv").read_text(), (group / "output.csv").read_text()
    assert len(a.splitlines()) == len(b.splitlines()) == 1 + 10  # every (variant, gene) row, every route
    if flags:
        assert_csv_close(group / "output.csv", single / "output.csv", 1e-5, lambda col, want: (
            sed_atol(want[f"REF_{col}"]) if f"REF_{col}" in want else 1e-6))
    else:
        assert a == b
    no_leftovers(group)


def test_predict_cli(inputs, chromatin_runs, tmp_path):
    """sed.tsv and its sorted tables byte for byte the 1-process files; the
    --modelList effects within 1e-6."""
    from expecto_tpu_torch.cli.predict import main

    d, models = inputs
    h5 = chromatin_runs[0]
    common = ["--coorFile", str(h5 / "snps_hg19.vcf"), "--geneFile", str(d / "genes.tsv"), "--snpEffectFilePattern",
              str(h5 / "snps.shift_SHIFT.diff.h5"), "--maxshift", str(MAXSHIFT)]
    for o in ("single", "group"):
        (tmp_path / o).mkdir()
    _both(main, lambda o: [*common, "--model_save_file", models[0], "-o", str(o)],
          tmp_path / "single", tmp_path / "group", "expecto_tpu_torch.cli.predict")
    _both(main, lambda o: [*common, "--modelList", str(d / "modellist"), "--output", str(o / "multi.csv")],
          tmp_path / "single", tmp_path / "group", "expecto_tpu_torch.cli.predict")
    for name in ("sed.tsv", "sed_sorted_by_magnitude.tsv", "sed_sorted_by_proportion.tsv"):
        assert (tmp_path / "single" / name).read_text() == (tmp_path / "group" / name).read_text(), name
    assert_csv_close(tmp_path / "group" / "multi.csv", tmp_path / "single" / "multi.csv", 0, lambda col, want: 1e-6)
    no_leftovers(tmp_path / "group")


def test_compute_features_cli(inputs, tiny_genome, tmp_path):
    """Shard npy files merged in gene order equal the 1-process matrix; with
    --replicate_raw each rank writes its own genes' files."""
    from expecto_tpu_torch.cli.compute_features import main

    d, _models = inputs
    anno = pd.DataFrame({"id": [f"G{i}" for i in range(3)], "seqnames": ["chr1", "chr1", "chr2"],
                         "strand": ["+", "-", "-"], "CAGE_representative_TSS": [21000, 30000, 22000]})
    anno.to_csv(tmp_path / "anno.csv", index=False)
    for flags, files in (([], ["Xreducedall.2002.representative_tss_top.npy"]),
                         (["--replicate_raw"], [f"G{i}.npy" for i in range(3)])):
        tag = "raw" if flags else "feat"
        single, group = tmp_path / f"{tag}_single", tmp_path / f"{tag}_group"
        _both(main, lambda o: [str(tmp_path / "anno.csv"), "--genome", str(d / "g.fa"), "--beluga_weights",
                               str(d / "beluga.npz"), "--batchsize", "400", "-o", str(o), "--device", "cpu", *flags],
              single, group, "expecto_tpu_torch.cli.compute_features")
        assert sorted(os.listdir(group)) == sorted(os.listdir(single)) == sorted(files)
        for name in files:
            a, b = np.load(single / name), np.load(group / name)
            assert a.shape == b.shape and a.shape[-1] == (20020 if tag == "feat" else N_TRACKS)
            np.testing.assert_array_equal(b, a, err_msg=name)


def _seq(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes().decode()


@pytest.fixture(scope="module")
def consensus_inputs(inputs, tmp_path_factory):
    """A consensus_dir of three genes (ref.fa, two samples each), its genes
    csv, a 20,030-feature model, and the top-eQTL layout of two genes."""
    d, _models = inputs
    rng = np.random.default_rng(21)
    root = tmp_path_factory.mktemp("consensus")
    rows = []
    for gi, (gene, strand) in enumerate([("genea", "+"), ("geneb", "-"), ("genec", "+")]):
        start = 1000 + gi * 500000
        rec_id = f"chr1:{start}-{start + ENFORMER_SEQ_LENGTH - 1}"
        os.makedirs(root / "c" / gene / "samples")
        for sample in ("NA1", "NA2"):
            (root / "c" / gene / "samples" / f"{sample}|-|1pIu.fa").write_text(
                f">{rec_id}\n{_seq(rng, ENFORMER_SEQ_LENGTH)}\n")
        (root / "c" / gene / "ref.fa").write_text(f">{rec_id}\n{_seq(rng, ENFORMER_SEQ_LENGTH)}\n")
        rows.append([f"ENSG{gi:011d}", "chr1", start + ENFORMER_SEQ_LENGTH // 2, gene.upper(), strand])
    pd.DataFrame(rows).to_csv(root / "genes.csv", header=False, index=False)
    w = (np.random.default_rng(1).normal(size=10 * (N_TRACKS + 1)) * 0.001).astype(np.float32)
    save_xgb07_binary(GBLinearModel(weight=w, bias=0.1, base_score=2.0), root / "m.save")
    for gi, gene in enumerate(("hla-b", "hla-c")):
        os.makedirs(root / "t" / gene)
        rec_base = f"chr6:{5000 + gi * 100000}-{5000 + gi * 100000 + ENFORMER_SEQ_LENGTH - 1}"
        with gzip.open(root / "t" / gene / f"{gene}.fa.gz", "wt") as f:
            for sample, strand in (("NA1", "+"), ("NA2", "-")):
                f.write(f">{rec_base}|{sample}|{strand}|1pIu\n{_seq(rng, ENFORMER_SEQ_LENGTH)}\n")
    pd.DataFrame({"name": ["HLA-B", "HLA-C"], "geneID": ["ENSG1", "ENSG2"], "CHR_SNP": [6, 6],
                  "SNPpos": [31324000, 31238000]}).to_csv(root / "eqtls.csv", index=False)
    pd.DataFrame({0: ["chr6", "chr6"], 1: [31324000, 31238000], 2: ["rs1", "rs2"], 3: ["A", "C"],
                  4: ["G", "T"]}).to_csv(root / "snps.vcf", sep="\t", header=False, index=False)
    return root, ["--beluga_weights", str(d / "beluga.npz"), "--batch_size", "400", "--device", "cpu"]


@pytest.mark.parametrize("cmd", ["ref", "samples", "top-eqtls"])
def test_consensus_cli(consensus_inputs, tmp_path, cmd):
    """ref: CSV shards merged by rank 0 into the 1-process rows; samples and
    top-eqtls: genes shard per rank into per-gene directories, the same
    files and datasets as one process."""
    from expecto_tpu_torch.cli.consensus import main

    root, common = consensus_inputs
    model = str(root / "m.save")
    pos = {"ref": [model, str(root / "c"), str(root / "genes.csv")],
           "samples": [model, str(root / "c"), str(root / "genes.csv"), "--features_only"],
           "top-eqtls": [model, str(root / "t"), str(root / "eqtls.csv"), str(root / "snps.vcf"), "--genes",
                         "HLA-B,HLA-C"]}[cmd]
    single, group = tmp_path / "single", tmp_path / "group"
    _both(main, lambda o: [cmd, *pos, *common, "-o", str(o)], single, group, "expecto_tpu_torch.cli.consensus")
    if cmd == "ref":
        assert_csv_close(group / "ref_preds.csv", single / "ref_preds.csv", 1e-5, lambda col, want: 1e-4)
        assert len(pd.read_csv(group / "ref_preds.csv")) == 3
        no_leftovers(group)
        return
    genes = sorted(os.listdir(single))
    assert sorted(os.listdir(group)) == genes and len(genes) == (3 if cmd == "samples" else 2)
    for g in genes:
        files = sorted(os.listdir(single / g))
        assert sorted(os.listdir(group / g)) == files
        for name in files:
            with h5py.File(single / g / name) as f1, h5py.File(group / g / name) as f2:
                assert sorted(f1) == sorted(f2)
                for key in f1:
                    if f1[key].dtype.kind == "f":
                        np.testing.assert_allclose(f2[key][...], f1[key][...], rtol=1e-5, atol=1e-4,
                                                   err_msg=f"{g}/{name}/{key}")
                    else:  # record ids, sequences
                        assert list(f2[key][...]) == list(f1[key][...]), f"{g}/{name}/{key}"


def test_exchange_tag_reuse(tmp_path):
    """Two exchanges with the same tag in one run: the sequence-stamped
    shard names keep them apart, and nothing is left behind."""
    out = tmp_path / "ex.npz"
    torchrun([DIST_WORKER, "exchange2", json.dumps({"n": 101, "dir": str(tmp_path), "out": str(out)})])
    got = np.load(out)
    rows = np.arange(101, dtype=np.float64)
    np.testing.assert_array_equal(got["x1"], rows * 2.0)
    np.testing.assert_array_equal(got["x2"], rows * 3.0)
    no_leftovers(tmp_path)
