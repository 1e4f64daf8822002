"""The port's gene-feature slice vs the JAX package, fp32 on the CPU: the
runner's predict_spans_project and predict_and_project (both strands, both
wire routes), pipeline/features.py (compute_gene_features with every one of
the 200 shifts, the ATAC-masked and replicate variants), analysis/atac.py,
the host helpers the slice copied (gene window math and window codes)
and the expecto_tpu_torch.cli.compute_features CLI.

Tolerance: features are sums of up to 200 weighted fp32 track probabilities,
about 10^1-10^2 at these widths; both packages sum in fp32 in different
orders, so features agree within 1e-5 * max|feature| (feat_tol), raw track
probabilities within 1e-5."""

import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.analysis import atac as jatac
from expecto_tpu.genome import windows as jwin
from expecto_tpu.ops.decay import gene_pos_weights
from expecto_tpu.parallel.runner import BelugaRunner as JaxBelugaRunner
from expecto_tpu.pipeline import features as jfeat
from expecto_tpu_torch.analysis import atac as tatac
from expecto_tpu_torch.genome import windows as twin
from expecto_tpu_torch.genome.fasta import FastaIndex
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline import features as tfeat
from torch_port_common import single_torch_thread, narrow_params  # noqa: F401 (autouse fixture)

SHIFTS = jwin.gene_shifts()
POS_WEIGHTS = gene_pos_weights(SHIFTS)
# batch 400 at 200 shifts: 2 gene spans a device chunk, so chunk loops turn
BATCH = 400
# (id, chrom, tss, strand) on the tiny_genome contigs (chr1 60 kb, chr2 45
# kb): a gene of each strand inside chr1, and a contig-edge gene of each
# strand on chr2 whose 41.8-kb span is N-padded (16,000 N before chr2's
# start; 19,000 past its end, over the 2-bit wire's N budget, so that
# chunk ships 4 bits a base)
GENES = [("G1", "chr1", 30000, 1), ("G2", "chr1", 26000, -1), ("G3", "chr2", 5000, 1), ("G4", "chr2", 43000, -1)]


def feat_tol(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def assert_features_close(got, want, msg=""):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=feat_tol(want), err_msg=msg)


@pytest.fixture(scope="module")
def params():
    return narrow_params(seed=21)


@pytest.fixture(scope="module")
def runners(params):
    """One JAX runner for the module: its jitted functions are built per
    runner, so sharing it compiles each 41.8-kb span shape once."""
    return JaxBelugaRunner(params, batch_size=BATCH), BelugaRunner(params, batch_size=BATCH, device="cpu")


@pytest.fixture(scope="module")
def port_fa(tiny_genome):
    fa, _ = tiny_genome
    genome = FastaIndex(fa.path)
    yield genome
    genome.close()


def _records(mod, names=None):
    return [mod.GeneRecord(g, c, t, s) for g, c, t, s in GENES if names is None or g in names]


def _span(fa, gene_id):
    _g, chrom, tss, strand = next(g for g in GENES if g[0] == gene_id)
    return jfeat.gene_span_and_offsets(fa, chrom, tss, strand)


# ---- host helpers -------------------------------------------------------------

def test_gene_window_math_matches_jax():
    assert twin.gene_shifts() == jwin.gene_shifts() and len(twin.gene_shifts()) == 200
    assert twin.gene_shifts(1000, 100) == jwin.gene_shifts(1000, 100)
    for tss, strand, shift, w in [(10000, 1, 200, 2000), (10000, -1, 200, 2000), (5, -1, -20000, 2000), (77, 1, 0, 1000)]:
        assert twin.gene_shift_window_bounds(tss, strand, shift, w) == jwin.gene_shift_window_bounds(tss, strand, shift, w)


@pytest.mark.parametrize("windowsize", [1000, 400])
def test_gene_window_codes_other_window_sizes_match_jax(tiny_genome, port_fa, windowsize):
    """The window size reaches the window math: windows of 1,000 and 400 bp
    around a gene whose first windows start before chr2's first base."""
    fa, _ = tiny_genome
    got = tfeat.gene_window_codes(port_fa, "chr2", 5000, 1, windowsize=windowsize)
    assert got.shape == (200, windowsize) and (got[0] == 4).any()
    np.testing.assert_array_equal(got, jfeat.gene_window_codes(fa, "chr2", 5000, 1, windowsize=windowsize))


@pytest.mark.parametrize("gene_id", [g[0] for g in GENES])
def test_gene_window_codes_and_span_match_jax(tiny_genome, port_fa, gene_id):
    """Window codes and the span with its offsets, both strands and both
    contig edges (N padding); the span's windows are the window codes."""
    fa, _ = tiny_genome
    _g, chrom, tss, strand = next(g for g in GENES if g[0] == gene_id)
    codes = tfeat.gene_window_codes(port_fa, chrom, tss, strand)
    np.testing.assert_array_equal(codes, jfeat.gene_window_codes(fa, chrom, tss, strand))
    span, offsets = tfeat.gene_span_and_offsets(port_fa, chrom, tss, strand)
    want_span, want_offsets = jfeat.gene_span_and_offsets(fa, chrom, tss, strand)
    np.testing.assert_array_equal(span, want_span)
    assert offsets == want_offsets and span.shape == (41800,)
    assert offsets[0] == (0 if strand == 1 else 39800)  # minus-strand offsets run downward
    np.testing.assert_array_equal(np.stack([span[o : o + 2000] for o in offsets]), codes)


def test_records_from_geneanno_matches_jax():
    anno = pd.DataFrame({"id": ["A", "B"], "seqnames": ["chr1", "chr2"], "strand": ["+", "-"],
                         "TSS": [10, 20], "CAGE_representative_TSS": [15, 25]})
    for col in ("CAGE_representative_TSS", "TSS"):
        got = [vars(r) for r in tfeat.records_from_geneanno(anno, col)]
        assert got == [vars(r) for r in jfeat.records_from_geneanno(anno, col)]


# ---- runner ----------------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
def test_predict_spans_project_matches_jax(tiny_genome, runners, budget, monkeypatch):
    """Three spans of one strand (two device chunks) at every shift; budget 0
    sends the port's chunks down the 4-bit route, held against the same JAX
    call (its 2-bit route), so both wire routes give the JAX features."""
    fa, _ = tiny_genome
    jr, tr = runners
    if budget is not None:
        monkeypatch.setattr(tr, "PACK2_SIDE_BUDGET", budget)
    for strand_genes in (("G1", "G3"), ("G2",)):
        spans, offsets = zip(*(_span(fa, g) for g in strand_genes))
        spans = np.stack(spans + spans[:1])
        got = tr.predict_spans_project(spans, offsets[0], POS_WEIGHTS)
        assert_features_close(got, jr.predict_spans_project(spans, offsets[0], POS_WEIGHTS), str(strand_genes))


def test_wire_routes_give_the_same_features(tiny_genome, runners, monkeypatch):
    """The N-dense edge gene G4 (19,000 N) ships 4 bits a base by itself;
    with the budget raised it ships 2 bits and an N sideband. Same device
    codes, so the same features."""
    fa, _ = tiny_genome
    _jr, tr = runners
    span, offsets = _span(fa, "G4")
    assert tr._pack2_plan(span[None], tr._span_rows(200)) is None
    dense = tr.predict_spans_project(span[None], offsets, POS_WEIGHTS)
    monkeypatch.setattr(tr, "PACK2_SIDE_BUDGET", 10**6)
    np.testing.assert_array_equal(tr.predict_spans_project(span[None], offsets, POS_WEIGHTS), dense)


def test_predict_and_project_matches_jax_and_the_span_path(tiny_genome, port_fa, runners):
    """The per-window version on one gene of each strand (G1, G2: 400 window
    rows, one device chunk at batch 400) against the JAX function, and
    against predict_spans_project: the span path's windows are the same
    windows, so the same features."""
    fa, _ = tiny_genome
    jr, tr = runners
    genes = _records(tfeat, ("G1", "G2"))
    codes = np.concatenate([tfeat.gene_window_codes(port_fa, g.chrom, g.tss, g.strand) for g in genes])
    got = tr.predict_and_project(codes, POS_WEIGHTS, len(SHIFTS))
    assert_features_close(got, jr.predict_and_project(codes, POS_WEIGHTS, len(SHIFTS)))
    for i, g in enumerate(genes):
        span, offsets = tfeat.gene_span_and_offsets(port_fa, g.chrom, g.tss, g.strand)
        assert_features_close(tr.predict_spans_project(span[None], offsets, POS_WEIGHTS), got[i : i + 1], g.gene_id)
    with pytest.raises(ValueError, match="multiple of n_shifts"):
        tr.predict_and_project(codes[:-1], POS_WEIGHTS, len(SHIFTS))


def test_fp16_wire_rounds_the_features(tiny_genome, params):
    """An fp16 wire carries the fp32 features, contracted in fp32 on the
    device, rounded once to fp16 and stored fp32 on the host."""
    fa, _ = tiny_genome
    span, offsets = _span(fa, "G1")
    r32 = BelugaRunner(params, batch_size=BATCH, device="cpu")
    r16 = BelugaRunner(params, batch_size=BATCH, device="cpu", out_dtype=np.float16)
    f32 = r32.predict_spans_project(span[None], offsets, POS_WEIGHTS)
    f16 = r16.predict_spans_project(span[None], offsets, POS_WEIGHTS)
    assert f16.dtype == np.float32
    np.testing.assert_array_equal(f16, f32.astype(np.float16).astype(np.float32))


# ---- pipeline/features.py ------------------------------------------------------------

def test_compute_gene_features_matches_jax(tiny_genome, port_fa, runners, tmp_path):
    """Four genes (both strands, both contig edges) at all 200 shifts,
    written to ``out_path``; blocks of one gene give the same features."""
    fa, _ = tiny_genome
    jr, tr = runners
    got = tfeat.compute_gene_features(_records(tfeat), port_fa, tr, out_path=tmp_path / "port")
    want = jfeat.compute_gene_features(_records(jfeat), fa, jr, distribute=False)
    assert got.shape == (4, 20020)
    assert_features_close(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    one = tfeat.compute_gene_features(_records(tfeat), port_fa, tr, genes_per_chunk=1)
    np.testing.assert_allclose(one, got, rtol=0, atol=1e-6 * float(np.abs(got).max()))


def test_compute_gene_features_atac_matches_jax(tiny_genome, port_fa, runners):
    """Peaks that cover some bins of each gene's receptive field, and a
    contig without peaks: the masked features against the JAX function, and
    unmasked tracks equal to the plain features."""
    fa, _ = tiny_genome
    jr, tr = runners
    peaks = {"chr1": np.array([[12000, 12500], [29950, 30180], [40000, 48000]]),
             "chr2": np.array([[30000, 30150]])}
    chip_idx = np.arange(0, 2002, 3)
    names = ("G1", "G2", "G4")
    got = tfeat.compute_gene_features_atac(_records(tfeat, names), port_fa, tr, peaks, chip_idx)
    want = jfeat.compute_gene_features_atac(_records(jfeat, names), fa, jr, peaks, chip_idx, distribute=False)
    assert_features_close(got, want)
    plain = tfeat.compute_gene_features(_records(tfeat, names), port_fa, tr).reshape(3, 10, 2002)
    other = np.setdiff1d(np.arange(2002), chip_idx)
    masked = got.reshape(3, 10, 2002)
    np.testing.assert_allclose(masked[:, :, other], plain[:, :, other], rtol=0, atol=feat_tol(plain))
    assert not np.allclose(masked[:, :, chip_idx], plain[:, :, chip_idx], rtol=0, atol=feat_tol(plain))


def test_replicate_gene_features_matches_jax(tiny_genome, port_fa, runners, tmp_path):
    """Raw (200, 2002) fp32 matrices per gene (one at a contig edge) against
    the JAX function, written as {gene_id}.npy; projected on the host with
    the gene decay weights they give compute_gene_features' features."""
    from expecto_tpu_torch.ops.decay import project_features

    fa, _ = tiny_genome
    jr, tr = runners
    names = ("G1", "G3")
    got = tfeat.replicate_gene_features(_records(tfeat, names), port_fa, tr, out_dir=tmp_path)
    want = jfeat.replicate_gene_features(_records(jfeat, names), fa, jr, distribute=False)
    assert sorted(got) == sorted(want) == list(names)
    feats = tfeat.compute_gene_features(_records(tfeat, names), port_fa, tr)
    for i, g in enumerate(names):
        assert got[g].shape == (200, 2002) and got[g].dtype == np.float32
        np.testing.assert_allclose(got[g], want[g], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(np.load(tmp_path / f"{g}.npy"), got[g])
        assert_features_close(project_features(POS_WEIGHTS, got[g][:, None, :]), feats[i : i + 1], g)


# ---- analysis/atac.py ----------------------------------------------------------------

def test_atac_helpers_match_jax(tmp_path):
    bed = tmp_path / "peaks.bed"
    bed.write_text("# comment\nchr1\t100\t250\tp1\nchr2\t5\t9\tp2\nchr1\t900\t1200\tp3\n")
    got, want = tatac.load_peaks_bed(str(bed)), jatac.load_peaks_bed(str(bed))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])

    iv = np.array([[0, 50], [40, 120], [200, 400], [500, 600]])
    for window in [(45, 300), (0, 10**6), (700, 800)]:
        np.testing.assert_array_equal(tatac.intersect_intervals(window, iv), jatac.intersect_intervals(window, iv))
    assert tatac.intersect_intervals((0, 1), np.empty((0, 2))).shape == (0, 2)

    rng = np.random.default_rng(3)
    peaks = {"chr1": np.sort(rng.integers(0, 60000, (12, 1)), axis=0) + np.array([[0, 150]]),
             "chr2": np.array([[0, 10**6]])}
    for chrom, tss, strand in [("chr1", 30000, 1), ("chr1", 30000, -1), ("chr2", 100, 1), ("chr3", 5, -1)]:
        bins = tatac.get_atac_peak_bins(chrom, tss, strand, peaks)
        np.testing.assert_array_equal(bins, jatac.get_atac_peak_bins(chrom, tss, strand, peaks))
        assert bins.shape == (200,)
    # a 100-bp half-open peak covers 101 bases of a bin (end_pos + 1, as the
    # reference): the bin passes the > 100 rule
    rf0 = 30000 - 20899 - 100
    one = {"chr1": np.array([[rf0 + 400, rf0 + 500]])}
    assert tatac.get_atac_peak_bins("chr1", 30000, 1, one)[2] == 1.0

    preds = rng.random((200, 2002)).astype(np.float32)
    mask = (rng.random(200) < 0.5).astype(float)
    idx = np.array([0, 7, 2001])
    np.testing.assert_array_equal(tatac.apply_peak_mask(preds, mask, idx), jatac.apply_peak_mask(preds, mask, idx))


# ---- cli.compute_features --------------------------------------------------------------

def _cli_inputs(tmp_path, tiny_genome, params):
    """geneanno (three genes: both strands, a contig edge), weights, an hg38
    TSS override table and a chain file that maps hg38 chr1 onto chr1 500 bp
    on, an ATAC peak BED and a 2,002-mark feature table."""
    from expecto_tpu_torch.models.convert import save_params_npz

    fa, _ = tiny_genome
    anno = pd.DataFrame({"id": ["G1", "G2", "G3"], "symbol": ["a", "b", "c"], "seqnames": ["chr1", "chr1", "chr2"],
                         "strand": ["+", "-", "+"], "TSS": [30000, 26000, 5000],
                         "CAGE_representative_TSS": [30000, 26000, 5000], "type": ["protein_coding"] * 3})
    anno.to_csv(tmp_path / "anno.csv", index=False)
    save_params_npz(params, tmp_path / "beluga.npz")
    # G1: a default row (kept); G2: lifted 28000 -> 28500; G3: unmapped (kept)
    pd.DataFrame({"ens_id": ["G1", "G2", "G3"], "chrom": ["chr1", "chr1", "chr9"], "pos": [31000, 28000, 100],
                  "is_default": [True, False, False]}).to_csv(tmp_path / "tss.tsv", sep="\t")
    (tmp_path / "hg38.chain").write_text("chain 1000 chr1 70000 + 1000 51000 chr1 60000 + 1500 51500 1\n50000\n\n")
    (tmp_path / "peaks.bed").write_text("chr1\t12000\t12500\nchr1\t29950\t30180\nchr2\t3000\t9000\n")
    pd.DataFrame({"Cell type": ["C"] * 2002, "Assay": ["CTCF", "H3K4me3"] * 1001,
                  "Assay type": ["TF", "Histone"] * 1001}).to_csv(tmp_path / "beluga.tsv", sep="\t")
    return [str(tmp_path / "anno.csv"), "--genome", str(fa.path), "--beluga_weights", str(tmp_path / "beluga.npz"),
            "--batchsize", str(BATCH)]


def test_compute_features_cli_matches_jax(tmp_path, tiny_genome, params):
    """The default run with an hg38 TSS override table lifted through a
    local chain file, then the ATAC-masked (TF only) and --replicate_raw
    runs, each against the JAX CLI on the same arguments."""
    from expecto_tpu.cli.compute_features import main as jax_cf
    from expecto_tpu_torch.cli.compute_features import main as torch_cf

    common = _cli_inputs(tmp_path, tiny_genome, params)
    runs = {
        "tss": (["--tss_file", str(tmp_path / "tss.tsv"), "--chain_file", str(tmp_path / "hg38.chain")],
                ["Xreducedall.2002.representative_tss_top.npy"]),
        "atac": (["--atac_peaks", str(tmp_path / "peaks.bed"), "--belugaFeatures", str(tmp_path / "beluga.tsv"),
                  "--atac_tf_only"], ["Xreducedall.2002.atac_x_chip.npy"]),
        "raw": (["--replicate_raw"], ["G1.npy", "G2.npy", "G3.npy"]),
    }
    for run, (extra, files) in runs.items():
        assert torch_cf(common + extra + ["-o", str(tmp_path / f"{run}_port"), "--device", "cpu"]) == 0
        assert jax_cf(common + extra + ["-o", str(tmp_path / f"{run}_jax")]) == 0
        assert sorted(p.name for p in (tmp_path / f"{run}_port").iterdir()) == sorted(files)
        for name in files:
            got, want = np.load(tmp_path / f"{run}_port" / name), np.load(tmp_path / f"{run}_jax" / name)
            assert got.dtype == np.float32
            if run == "raw":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
            else:
                assert_features_close(got, want, f"{run} {name}")
    # the override moved G2 (its features differ from the annotated TSS's)
    port = BelugaRunner(params, batch_size=BATCH, device="cpu")
    fa, _ = tiny_genome
    genome = FastaIndex(fa.path)
    try:
        plain = tfeat.compute_gene_features(_records(tfeat, ("G1", "G2", "G3")), genome, port)
    finally:
        genome.close()
    lifted = np.load(tmp_path / "tss_port" / "Xreducedall.2002.representative_tss_top.npy")
    np.testing.assert_allclose(lifted[[0, 2]], plain[[0, 2]], rtol=0, atol=feat_tol(plain))
    assert np.abs(lifted[1] - plain[1]).max() > 100 * feat_tol(plain)


def test_compute_features_cli_needs_its_companion_flags_and_a_gpu(tmp_path, tiny_genome, params, capsys):
    from expecto_tpu_torch.cli.compute_features import main as torch_cf

    common = _cli_inputs(tmp_path, tiny_genome, params)
    assert torch_cf(common + ["--tss_file", str(tmp_path / "tss.tsv"), "-o", str(tmp_path / "a")]) == 2
    assert "--chain_file" in capsys.readouterr().err
    assert torch_cf(common + ["--atac_peaks", str(tmp_path / "peaks.bed"), "-o", str(tmp_path / "b")]) == 2
    assert "--belugaFeatures" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        torch_cf(common + ["-o", str(tmp_path / "c")])
    assert not list(tmp_path.glob("c/*.npy"))
