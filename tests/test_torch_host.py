"""The port's own copies of the host modules vs the JAX package's originals on
the same inputs (decay basis, encoding, FASTA, VCF, windows, tables, the
xgboost-0.7 codec and gblinear prediction). They run numpy and pandas on both
sides, so results must be equal; the float projections allow fp32 rounding."""

import numpy as np
import pandas as pd
import pytest

import expecto_tpu.genome.encode as j_encode
import expecto_tpu.genome.fasta as j_fasta
import expecto_tpu.genome.vcf as j_vcf
import expecto_tpu.genome.windows as j_windows
import expecto_tpu.io.tables as j_tables
import expecto_tpu.io.xgb as j_xgb
import expecto_tpu.models.gblinear as j_gbl
import expecto_tpu.ops.decay as j_decay
import expecto_tpu_torch.genome.encode as t_encode
import expecto_tpu_torch.genome.fasta as t_fasta
import expecto_tpu_torch.genome.native as t_native
import expecto_tpu_torch.genome.vcf as t_vcf
import expecto_tpu_torch.genome.windows as t_windows
import expecto_tpu_torch.io.tables as t_tables
import expecto_tpu_torch.io.xgb as t_xgb
import expecto_tpu_torch.models.gblinear as t_gbl
import expecto_tpu_torch.ops.decay as t_decay


def _eq(a, b):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, (tuple, list)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def case_decay(tmp_path, genome):
    rng = np.random.default_rng(0)
    dists = rng.integers(-30000, 30000, 12)
    strands = np.where(rng.random(12) < 0.5, "+", "-")
    shifts = j_windows.variant_shifts(800)
    basis = t_decay.variant_basis(dists, strands, shifts)
    _eq(basis, j_decay.variant_basis(dists, strands, shifts))
    _eq(t_decay.gene_pos_weights(shifts), j_decay.gene_pos_weights(shifts))
    preds = rng.random((len(shifts), 12, 2002)).astype(np.float32)
    np.testing.assert_allclose(t_decay.project_features(basis, preds), j_decay.project_features(basis, preds),
                               rtol=1e-6, atol=1e-6)
    pw = t_decay.gene_pos_weights(shifts)
    np.testing.assert_allclose(t_decay.project_features(pw, preds), j_decay.project_features(pw, preds),
                               rtol=1e-6, atol=1e-6)
    feats = rng.random((3, 10 * 2002)).astype(np.float32)
    _eq(t_decay.pad_legacy_20030(feats), j_decay.pad_legacy_20030(feats))
    assert t_decay.N_BASIS == j_decay.N_BASIS == 10


def case_encode(tmp_path, genome):
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list("ACGTNacgtnH-"), n)) for n in (1990, 2000, 2101, 2102)]
    _eq(t_encode.seqs_to_codes(seqs, 2000), j_encode.seqs_to_codes(seqs, 2000))
    alleles = ["A", "TTG", "c", "NAC", ""]
    _eq(t_encode.alleles_to_flat_codes(alleles), j_encode.alleles_to_flat_codes(alleles))
    codes = rng.integers(0, 5, (3, 17)).astype(np.int8)
    _eq(t_encode.reverse_complement_codes(codes), j_encode.reverse_complement_codes(codes))
    for length in (2000, 2100, 2101, 2150):
        assert t_encode.center_crop_slice(length, 2000) == j_encode.center_crop_slice(length, 2000)


def _fasta_checks(fa_t, fa_j, contigs):
    starts = np.array([-50, 1, 1000, len(contigs["chr2"]) - 100])
    for chrom in contigs:
        assert fa_t.contig_length(chrom) == fa_j.contig_length(chrom)
        _eq(fa_t.window_codes(chrom, starts, 300), fa_j.window_codes(chrom, starts, 300))
        assert fa_t.sequence(chrom, 990, 1010) == fa_j.sequence(chrom, 990, 1010)
        assert fa_t.sequence(chrom, -5, 10) == fa_j.sequence(chrom, -5, 10)


def case_fasta_native(tmp_path, genome):
    fa_j, contigs = genome
    path = tmp_path / "g.fa"
    t_fasta.write_fasta(path, contigs)
    j_fasta.write_fasta(tmp_path / "g_ref.fa", contigs)
    assert path.read_bytes() == (tmp_path / "g_ref.fa").read_bytes()
    fa_t = t_fasta.FastaIndex(path)
    try:
        _fasta_checks(fa_t, fa_j, contigs)
    finally:
        fa_t.close()


def case_fasta_numpy_fallback(tmp_path, genome, monkeypatch=None):
    fa_j, contigs = genome
    path = tmp_path / "g.fa"
    t_fasta.write_fasta(path, contigs)
    monkeypatch.setattr(t_native, "available", lambda: False)
    fa_t = t_fasta.FastaIndex(path)
    try:
        _fasta_checks(fa_t, fa_j, contigs)
    finally:
        fa_t.close()


def case_fasta_contigs_and_sequence_dict(tmp_path, genome):
    """``contigs`` and the pyfasta-style ``sequence_dict`` on a seeded FASTA
    with a lower-case run and an N run, fetched across both contig edges."""
    rng = np.random.default_rng(7)
    contigs = {}
    for name, n in (("chrB", 1500), ("chr10", 700), ("chrA", 900)):
        seq = "".join(rng.choice(list("ACGT"), n))
        contigs[name] = seq[:200] + seq[200:260].lower() + "N" * 40 + seq[300:]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t_fasta.write_fasta(tmp_path / "t" / "g.fa", contigs)
    j_fasta.write_fasta(tmp_path / "j" / "g.fa", contigs)
    fa_t, fa_j = t_fasta.FastaIndex(tmp_path / "t" / "g.fa"), j_fasta.FastaIndex(tmp_path / "j" / "g.fa")
    try:
        assert fa_t.contigs == fa_j.contigs == ["chrB", "chr10", "chrA"]
        for chrom, seq in contigs.items():
            for start, stop in ((-20, 30), (1, 1), (190, 320), (250, 250), (len(seq) - 10, len(seq) + 50),
                                (len(seq) + 5, len(seq) + 9), (40, 20)):
                query = {"chr": chrom, "start": start, "stop": stop}
                got = fa_t.sequence_dict(query)
                assert got == fa_j.sequence_dict(query) == seq[max(start - 1, 0) : max(stop, 0)], (chrom, start, stop)
    finally:
        fa_t.close()
        fa_j.close()


def case_vcf(tmp_path, genome):
    path = tmp_path / "in.vcf"
    path.write_text("##fileformat=VCFv4.3\n#CHROM\tPOS\n1\t100\t.\tA\tT\nchr2\t200\trs1\tAC\tA\n"
                    "chrUn\t5\t.\tG\tC\nX\t7\t.\tG\tGA\n")
    _eq(t_vcf.read_vcf(path), j_vcf.read_vcf(path))
    _eq(t_vcf.standardize_chroms(t_vcf.read_vcf(path)), j_vcf.standardize_chroms(j_vcf.read_vcf(path)))


def case_windows(tmp_path, genome):
    fa, contigs = genome
    for maxshift in (200, 400, 800):
        assert t_windows.variant_shifts(maxshift) == j_windows.variant_shifts(maxshift)
    for pos, ref, alt, shift in [(5000, "A", "T", 0), (5000, "AC", "A", -400), (900, "G", "GTT", 800),
                                 (44990, "C", "A", 200)]:
        ref = contigs["chr2"][pos - 1 : pos - 1 + len(ref)]
        got = t_windows.fetch_variant_window(fa, "chr2", pos, ref, alt, shift=shift)
        want = j_windows.fetch_variant_window(fa, "chr2", pos, ref, alt, shift=shift)
        assert got.__dict__ == want.__dict__


def case_tables(tmp_path, genome):
    genes = tmp_path / "genes.tsv"
    genes.write_text("1\t99\t100\tA\tT\t1\t899\t900\t+\tG1\t800\n1\t99\t100\tA\tT\t1\t50\t51\t-\tG2\t-49\n")
    _eq(t_tables.load_closest_genes(genes), j_tables.load_closest_genes(genes))
    ml = tmp_path / "modellist"
    ml.write_text("ModelName\tTissue\na.save\tLiver\nb.save \tBrain\n")
    _eq(t_tables.load_modellist(ml), j_tables.load_modellist(ml))


def _model(seed, n=10 * 2002):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(np.float32), float(rng.standard_normal()), 2.0


def case_xgb_port_writes_jax_reads(tmp_path, genome):
    w, b, base = _model(2)
    t_xgb.save_xgb07_binary(t_gbl.GBLinearModel(weight=w, bias=b, base_score=base), tmp_path / "m.save")
    m = j_xgb.load_xgb07_binary(tmp_path / "m.save")
    _eq(m.weight, w)
    assert (m.bias, m.base_score) == (np.float32(b), base)


def case_xgb_jax_writes_port_reads(tmp_path, genome):
    w, b, base = _model(3)
    j_xgb.save_xgb07_binary(j_gbl.GBLinearModel(weight=w, bias=b, base_score=base), tmp_path / "m.save")
    for path in (tmp_path / "m.save", str(tmp_path / "m.save") + "  "):  # trailing spaces are stripped
        got, want = t_xgb.load_expression_model(path), j_xgb.load_expression_model(path)
        _eq(got.weight, want.weight)
        assert (got.bias, got.base_score) == (want.bias, want.base_score)
    assert t_xgb.load_xgb07_binary(tmp_path / "m.save").n_features == 10 * 2002


def case_xgb_dump_and_npz(tmp_path, genome):
    w, b, base = _model(4, n=50)
    j_model = j_gbl.GBLinearModel(weight=w, bias=b, base_score=base)
    (tmp_path / "m.dump").write_text(j_xgb.dump_text(j_model))
    j_xgb.save_expression_model(j_model, tmp_path / "m.npz")
    for name in ("m.dump", "m.npz"):
        got, want = t_xgb.load_expression_model(tmp_path / name), j_xgb.load_expression_model(tmp_path / name)
        _eq(got.weight, want.weight)
        assert (got.bias, got.base_score) == (want.bias, want.base_score)


def case_gblinear_predict(tmp_path, genome):
    w, b, base = _model(5)
    X = np.random.default_rng(6).random((7, w.size)).astype(np.float32)
    got = t_gbl.GBLinearModel(weight=w, bias=b, base_score=base).predict(X)
    want = j_gbl.GBLinearModel(weight=w, bias=b, base_score=base).predict(X)
    _eq(got, want)
    assert got.dtype == np.float32


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_host_module_matches_jax_package(case, tmp_path, tiny_genome, monkeypatch):
    fn = CASES[case]
    if case == "fasta_numpy_fallback":
        fn(tmp_path, tiny_genome, monkeypatch)
    else:
        fn(tmp_path, tiny_genome)


def test_native_library_is_used_where_present():
    """The repo-level native/libetseq.so loads through the port's own loader
    (the numpy fallback case above covers its absence)."""
    from pathlib import Path

    lib = Path(t_native.__file__).resolve().parents[2] / "native" / "libetseq.so"
    assert t_native.available() == lib.exists()
