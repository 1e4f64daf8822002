"""The port's h5-contract chromatin half vs the JAX package, fp32 on the CPU:
the runner's pair-diff span forwards, compute_variant_chromatin_effects
(span, per-window and streaming paths, both h5 schemas), the diagnostics,
the h5 files each package writes read by the other, and the host helpers
the slice copied (FastaIndex.window_bytes, read_vcf chunks,
write_vcf_hg19, load_beluga_features)."""

import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.genome.windows import variant_shifts
from expecto_tpu.io import h5 as jh5
from expecto_tpu.parallel.runner import BelugaRunner as JaxBelugaRunner
from expecto_tpu.pipeline import chromatin as jchrom
from expecto_tpu_torch.genome.fasta import FastaIndex
from expecto_tpu_torch.io import h5 as th5
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline import chromatin as tchrom
from torch_port_common import single_torch_thread, narrow_params, random_codes, serving_tables  # noqa: F401 (autouse fixture)

# fp32 on both sides, summed in different orders: track probabilities and
# their differences within 1e-5
TOL = 1e-5
MAXSHIFT = 400
SPAN_LEN = 2 * MAXSHIFT + 2000
MUTPOS = MAXSHIFT + 999
OFFSETS = tuple(s + MAXSHIFT for s in variant_shifts(MAXSHIFT))


@pytest.fixture(scope="module")
def params():
    return narrow_params(seed=11)


@pytest.fixture(scope="module")
def runners(params):
    """batch_size 16 at 5 shifts: 3 spans a chunk, one pair a pair chunk,
    so every chunk loop takes several turns."""
    return JaxBelugaRunner(params, batch_size=16), BelugaRunner(params, batch_size=16, device="cpu")


@pytest.fixture(scope="module")
def port_fa(tiny_genome):
    fa, _ = tiny_genome
    genome = FastaIndex(fa.path)
    yield genome
    genome.close()


@pytest.fixture(scope="module")
def vcf(tiny_genome):
    """Substitutions, a multi-base substitution, an insertion, a deletion
    and a contig-edge row (per-window fallback)."""
    _fa, contigs = tiny_genome
    rows, _genes = serving_tables(contigs["chr1"])
    return pd.DataFrame(rows)


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    ref = random_codes(rng, n, SPAN_LEN)
    alt = ref.copy()
    alt[:, MUTPOS:] = np.roll(ref[:, MUTPOS:], 3, axis=1)  # an insertion-like shifted tail
    alt[:, MUTPOS : MUTPOS + 3] = rng.integers(0, 4, (n, 3))
    return ref, alt


def _budget(monkeypatch, runners, budget):
    """budget 0 sends every chunk down the N-dense route."""
    if budget is not None:
        for r in runners:
            monkeypatch.setattr(r, "PACK2_SIDE_BUDGET", budget)


# ---- runner --------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
@pytest.mark.parametrize("rc_mode", ["none", "average", "concat"])
def test_predict_span_codes_matches_jax(runners, rc_mode, budget, monkeypatch):
    _budget(monkeypatch, runners, budget)
    jr, tr = runners
    spans = random_codes(np.random.default_rng(1), 4, SPAN_LEN)
    got = tr.predict_span_codes(spans, OFFSETS, rc_mode=rc_mode)
    want = jr.predict_span_codes(spans, OFFSETS, rc_mode=rc_mode)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_predict_span_codes_rejects_an_unknown_rc_mode(runners):
    with pytest.raises(ValueError):
        runners[1].predict_span_codes(random_codes(np.random.default_rng(0), 1, SPAN_LEN), OFFSETS, rc_mode="x")


@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
def test_predict_span_pairs_diff_matches_jax(runners, budget, monkeypatch):
    _budget(monkeypatch, runners, budget)
    jr, tr = runners
    ref, alt = _pairs(3, seed=2)
    got = tr.predict_span_pairs_diff(ref, alt, OFFSETS)
    want = jr.predict_span_pairs_diff(ref, alt, OFFSETS)
    for name, g, w in zip(("ref", "alt", "diff"), got, want):
        assert g.shape == w.shape == (6, len(OFFSETS), 2002) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got[1], got[0] + got[2])
    # row layout [fwd; rc]: the forward rows are predict_span_codes' fwd half
    concat = tr.predict_span_codes(ref, OFFSETS, rc_mode="concat")
    np.testing.assert_allclose(got[0][:3], concat[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0][3:], concat[:, 1], rtol=0, atol=1e-6)


class _Sink:
    """Collects sink calls, which the runner's fetch workers make in any
    order, and rebuilds the [fwd; rc] row layout in row order."""

    def __init__(self, n):
        self.n, self.calls, self.parts = n, [], {}

    def __call__(self, start, real, *arrays):
        for a in arrays:
            assert a.dtype == np.float32 and a.shape[:2] == (real, 2)
        self.calls.append((start, real))
        self.parts[start] = arrays

    def rows(self, k):
        a = np.concatenate([self.parts[s][k] for s in sorted(self.parts)], axis=0)  # (n, 2, S, M)
        return np.concatenate([a[:, 0], a[:, 1]], axis=0)


@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
def test_predict_span_pairs_diff_sink_streams_the_same_rows(runners, budget, monkeypatch):
    _budget(monkeypatch, runners, budget)
    _jr, tr = runners
    ref, alt = _pairs(3, seed=3)
    sink = _Sink(3)
    assert tr.predict_span_pairs_diff(ref, alt, OFFSETS, sink=sink) is None
    assert sorted(sink.calls) == [(0, 1), (1, 1), (2, 1)]  # each chunk once, one pair a chunk
    for k, arr in enumerate(tr.predict_span_pairs_diff(ref, alt, OFFSETS)):
        np.testing.assert_array_equal(sink.rows(k), arr)


@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
def test_predict_span_pair_diffs_only_matches_jax_and_pair_diff(runners, budget, monkeypatch):
    _budget(monkeypatch, runners, budget)
    jr, tr = runners
    ref, alt = _pairs(3, seed=4)
    got = tr.predict_span_pair_diffs_only(ref, alt, OFFSETS)
    assert got.shape == (6, len(OFFSETS), 2002) and got.dtype == np.float32
    np.testing.assert_allclose(got, jr.predict_span_pair_diffs_only(ref, alt, OFFSETS), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got, tr.predict_span_pairs_diff(ref, alt, OFFSETS)[2])
    sink = _Sink(3)
    assert tr.predict_span_pair_diffs_only(ref, alt, OFFSETS, sink=sink) is None
    np.testing.assert_array_equal(sink.rows(0), got)


def test_fp16_wire_keeps_diff_from_the_device(params):
    """bf16 compute and an fp16 wire: the host rebuilds alt = ref + diff in
    fp32 from the wire, and diff is the device's fp32 difference rounded
    once, not the difference of two fp16-rounded sides."""
    ref, alt = _pairs(2, seed=5)
    prod = BelugaRunner(params, batch_size=16, device="cpu", compute_dtype=torch.bfloat16, out_dtype=np.float16)
    R, A, D = prod.predict_span_pairs_diff(ref, alt, OFFSETS)
    assert R.dtype == A.dtype == D.dtype == np.float32
    np.testing.assert_array_equal(A, R + D)
    np.testing.assert_array_equal(R, R.astype(np.float16))  # the wire is fp16
    np.testing.assert_array_equal(D, D.astype(np.float16))
    np.testing.assert_array_equal(D, prod.predict_span_pair_diffs_only(ref, alt, OFFSETS))
    R32, _A32, D32 = BelugaRunner(params, batch_size=16, device="cpu").predict_span_pairs_diff(ref, alt, OFFSETS)
    # bf16 activations: about 3 significant digits
    np.testing.assert_allclose(R, R32, rtol=0, atol=3e-2)
    np.testing.assert_allclose(D, D32, rtol=0, atol=3e-2)


# ---- compute_variant_chromatin_effects -----------------------------------

def _effects(tr_or_jr, chrom_mod, vcf, fa, **kw):
    kw.setdefault("verbose", False)
    return chrom_mod.compute_variant_chromatin_effects(vcf, fa, tr_or_jr, None, maxshift=MAXSHIFT, keep_arrays=True,
                                                       **kw)


def _assert_arrays_close(got, want):
    assert got.shifts == want.shifts
    assert (got.n_variants, got.ref_matched, got.alt_matched) == (want.n_variants, want.ref_matched, want.alt_matched)
    for s in want.shifts:
        for name, g, w in zip(("diff", "ref", "alt"), got.arrays[s], want.arrays[s]):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=f"shift {s} {name}")


@pytest.mark.parametrize("use_spans", ["auto", "never"])
def test_chromatin_effects_match_jax(runners, tiny_genome, port_fa, vcf, use_spans):
    """Mixed rows: the span path for the eligible rows and the per-window
    path for the contig-edge row ('auto'), or every row per window."""
    jr, tr = runners
    fa, _ = tiny_genome
    got = _effects(tr, tchrom, vcf, port_fa, use_spans=use_spans)
    _assert_arrays_close(got, _effects(jr, jchrom, vcf, fa, use_spans=use_spans))
    assert got.arrays[0][0].shape == (2 * len(vcf), 2002)


def test_chromatin_arrays_are_diff_ref_alt(runners, port_fa, vcf):
    """ChromatinResult.arrays[shift] is (diff, ref, alt), as the JAX
    package orders it, with diff = alt - ref."""
    res = _effects(runners[1], tchrom, vcf, port_fa)
    for s in res.shifts:
        diff, ref, alt = res.arrays[s]
        np.testing.assert_allclose(diff, alt - ref, rtol=0, atol=1e-6)
        assert np.abs(diff).max() > 0 and np.abs(ref - alt).max() > 0


def test_use_spans_always(runners, tiny_genome, port_fa, vcf):
    jr, tr = runners
    fa, _ = tiny_genome
    eligible = vcf.iloc[:-1]  # without the contig-edge row
    _assert_arrays_close(_effects(tr, tchrom, eligible, port_fa, use_spans="always"),
                         _effects(jr, jchrom, eligible, fa, use_spans="always"))
    with pytest.raises(ValueError) as got:
        _effects(tr, tchrom, vcf, port_fa, use_spans="always")
    with pytest.raises(ValueError) as want:
        _effects(jr, jchrom, vcf, fa, use_spans="always")
    assert str(got.value) == str(want.value)


def test_no_variants(runners, port_fa, tiny_genome, tmp_path):
    jr, tr = runners
    fa, _ = tiny_genome
    empty = pd.DataFrame(columns=range(5))
    got = _effects(tr, tchrom, empty, port_fa)
    want = _effects(jr, jchrom, empty, fa)
    assert (got.n_variants, got.ref_matched, got.alt_matched) == (want.n_variants, want.ref_matched, want.alt_matched)
    for s in want.shifts:
        assert [a.shape for a in got.arrays[s]] == [a.shape for a in want.arrays[s]] == [(0, 2002)] * 3
    tchrom.compute_variant_chromatin_effects(empty, port_fa, tr, tmp_path, maxshift=MAXSHIFT, verbose=False)
    assert th5.read_shift_h5(tmp_path / "snps.shift_0.diff.h5")["ref"].shape == (0, 2002)


def _read_dir(path, shifts, suffix="diff.h5"):
    return {s: th5.read_shift_h5(path / f"snps.shift_{s}.{suffix}") for s in shifts}


def test_streaming_h5_equals_keep_arrays_bit_for_bit(runners, port_fa, vcf, tmp_path):
    """The streaming path (span rows through the sink, the contig-edge row
    written at its global position after them) writes exactly the arrays
    the in-memory path returns."""
    tr = runners[1]
    mem = _effects(tr, tchrom, vcf, port_fa)
    tchrom.compute_variant_chromatin_effects(vcf, port_fa, tr, tmp_path, maxshift=MAXSHIFT, verbose=False)
    files = _read_dir(tmp_path, mem.shifts)
    for s in mem.shifts:
        assert sorted(files[s]) == ["alt", "diff", "ref"]
        for name, arr in zip(("diff", "ref", "alt"), mem.arrays[s]):
            np.testing.assert_array_equal(files[s][name], arr, err_msg=f"shift {s} {name}")


def test_port_h5_files_match_jax_files(runners, tiny_genome, port_fa, vcf, tmp_path):
    """Same file names, datasets, shapes, float32 and [fwd; rc] row layout;
    values within 1e-5. Each package's reader reads the other's files."""
    jr, tr = runners
    fa, _ = tiny_genome
    tchrom.compute_variant_chromatin_effects(vcf, port_fa, tr, tmp_path / "port", maxshift=MAXSHIFT, verbose=False)
    jchrom.compute_variant_chromatin_effects(vcf, fa, jr, tmp_path / "jax", maxshift=MAXSHIFT, verbose=False)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for s in variant_shifts(MAXSHIFT):
        name = f"snps.shift_{s}.diff.h5"
        by_jax = jh5.read_shift_h5(tmp_path / "port" / name)
        by_port = th5.read_shift_h5(tmp_path / "jax" / name)
        assert sorted(by_jax) == sorted(by_port) == ["alt", "diff", "ref"]
        for k in by_jax:
            assert by_jax[k].dtype == by_port[k].dtype == np.float32
            assert by_jax[k].shape == by_port[k].shape == (2 * len(vcf), 2002)
            np.testing.assert_allclose(by_jax[k], by_port[k], rtol=0, atol=TOL, err_msg=f"{name} {k}")
        for k, v in th5.read_shift_h5_averaged(tmp_path / "port" / name).items():
            np.testing.assert_allclose(v, jh5.read_shift_h5_averaged(tmp_path / "jax" / name)[k], rtol=0, atol=TOL)


def test_stream_span_rows_into_arrays_equals_keep_arrays(runners, port_fa, vcf):
    """The streaming writer fills any row-writable targets, numpy arrays as
    well as h5 datasets, with exactly the in-memory path's arrays: the span
    rows chunk by chunk through the sink, the contig-edge row after them."""
    tr = runners[1]
    mem = _effects(tr, tchrom, vcf, port_fa)
    n = len(vcf)
    chroms, pos = vcf.iloc[:, 0].astype(str).values, vcf.iloc[:, 1].astype(int).values
    refs, alts = vcf.iloc[:, 3].astype(str).values, vcf.iloc[:, 4].astype(str).values
    span_ok = tchrom._span_eligible(port_fa, chroms, pos, refs, alts, MAXSHIFT, 2000)
    assert span_ok.any() and not span_ok.all()
    dsets = [{k: np.full((2 * n, 2002), np.nan, np.float32) for k in ("diff", "ref", "alt")} for _ in mem.shifts]
    tchrom.stream_span_rows(port_fa, tr, chroms, pos, refs, alts, mem.shifts, MAXSHIFT, 2000, span_ok, dsets)
    for si, s in enumerate(mem.shifts):
        for name, arr in zip(("diff", "ref", "alt"), mem.arrays[s]):
            np.testing.assert_array_equal(dsets[si][name], arr, err_msg=f"shift {s} {name}")


@pytest.mark.parametrize("keep_arrays", [False, True], ids=["streaming", "in_memory"])
def test_legacy_h5_and_legacy_only(runners, tiny_genome, port_fa, vcf, tmp_path, keep_arrays):
    """legacy_h5 adds the single-'pred' files beside the fork schema;
    legacy_only writes only them (on the diff-only wire when streaming), and
    pred is the diff either way."""
    jr, tr = runners
    fa, _ = tiny_genome
    shifts = variant_shifts(MAXSHIFT)
    kw = {"maxshift": MAXSHIFT, "verbose": False, "keep_arrays": keep_arrays}
    tchrom.compute_variant_chromatin_effects(vcf, port_fa, tr, tmp_path / "both", legacy_h5=True, **kw)
    tchrom.compute_variant_chromatin_effects(vcf, port_fa, tr, tmp_path / "only", legacy_only=True, **kw)
    jchrom.compute_variant_chromatin_effects(vcf, fa, jr, tmp_path / "jax", legacy_only=True, **kw)
    assert len(list((tmp_path / "both").iterdir())) == 2 * len(shifts)
    assert sorted(p.name for p in (tmp_path / "only").iterdir()) == sorted(
        f"snps.shift_{s}.legacy.diff.h5" for s in shifts)
    fork = _read_dir(tmp_path / "both", shifts)
    for s in shifts:
        name = f"snps.shift_{s}.legacy.diff.h5"
        legacy = th5.read_shift_h5(tmp_path / "both" / name)
        assert list(legacy) == ["diff"]
        np.testing.assert_array_equal(legacy["diff"], fork[s]["diff"])
        only = th5.read_shift_h5(tmp_path / "only" / name)["diff"]
        np.testing.assert_allclose(only, fork[s]["diff"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(only, jh5.read_shift_h5(tmp_path / "jax" / name)["diff"], rtol=0, atol=TOL)


def test_streaming_legacy_only_takes_the_diff_only_wire(runners, port_fa, vcf, tmp_path, monkeypatch):
    tr = runners[1]
    calls = []
    for name in ("predict_span_pairs_diff", "predict_span_pair_diffs_only"):
        orig = getattr(tr, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append((_name, kw.get("sink") is not None))
            return _orig(*a, **kw)

        monkeypatch.setattr(tr, name, spy)
    tchrom.compute_variant_chromatin_effects(vcf, port_fa, tr, tmp_path / "a", maxshift=MAXSHIFT, verbose=False)
    tchrom.compute_variant_chromatin_effects(vcf, port_fa, tr, tmp_path / "b", maxshift=MAXSHIFT, verbose=False,
                                             legacy_only=True)
    assert calls == [("predict_span_pairs_diff", True), ("predict_span_pair_diffs_only", True)]


# ---- diagnostics and host helpers -----------------------------------------

def test_diagnostics_counts_equal_jax(tiny_genome, port_fa, capsys):
    """Matching and mismatching ref alleles, lowercase alleles, a matching
    alt (ref mislabelled), indels, a site past the contig end, and rows near
    the contig start where the reference reads a clamp-shifted site."""
    fa, contigs = tiny_genome
    c1, c2 = contigs["chr1"], contigs["chr2"]
    rows = [
        ("chr1", 5000, c1[4999], "A"),
        ("chr1", 6000, "A" if c1[5999] != "A" else "C", c1[5999]),   # alt matches the genome
        ("chr1", 7000, c1[6999:7002].lower(), "g"),                  # lowercase multi-base ref
        ("chr1", 8000, c1[7999], c1[7999] + "TT"),                   # insertion
        ("chr2", 9000, c2[8999:9004], c2[8999]),                     # deletion
        ("chr1", 20, c1[19], "A"),                                   # contig start: clamped site
        ("chr1", 1000, c1[1049], "C"),                               # ... the quirk reads pos 1050
        ("chr2", len(c2), c2[-1] + "A", "C"),                        # truncated at the contig end
    ]
    chroms, pos, refs, alts = (np.array(col) for col in zip(*rows))
    pos = pos.astype(np.int64)
    got = tchrom._diagnostics(port_fa, chroms, pos, refs, alts, 2000, True)
    out = capsys.readouterr().out
    want = jchrom._diagnostics(fa, chroms, pos, refs, alts, 2000, True)
    assert got == want
    assert out == capsys.readouterr().out
    assert tchrom._diagnostics(port_fa, [], [], [], [], 2000, False) == (0, 0)


def test_window_bytes_matches_jax(tiny_genome, port_fa):
    fa, contigs = tiny_genome
    starts = np.array([-5, 1, 100, len(contigs["chr2"]) - 3, len(contigs["chr2"]) + 10])
    np.testing.assert_array_equal(port_fa.window_bytes("chr2", starts, 12), fa.window_bytes("chr2", starts, 12))
    assert port_fa.window_bytes("chr2", np.array([], np.int64), 4).shape == (0, 4)


def test_read_vcf_chunks_and_write_vcf_hg19_match_jax(tmp_path, vcf):
    from expecto_tpu.genome import vcf as jvcf
    from expecto_tpu_torch.genome import vcf as tvcf

    path = tmp_path / "in.vcf"
    vcf.to_csv(path, sep="\t", header=False, index=False)
    for kw in ({}, {"chunk_size": 4, "chunk_i": 0}, {"chunk_size": 4, "chunk_i": 1}):
        pd.testing.assert_frame_equal(tvcf.read_vcf(path, **kw), jvcf.read_vcf(path, **kw))
    with pytest.raises(ValueError):
        tvcf.read_vcf(path, chunk_i=1)
    tvcf.write_vcf_hg19(vcf, tmp_path / "port.vcf")
    jvcf.write_vcf_hg19(vcf, tmp_path / "jax.vcf")
    assert (tmp_path / "port.vcf").read_text() == (tmp_path / "jax.vcf").read_text()


def test_table_loaders_match_jax(tmp_path):
    from expecto_tpu.io import tables as jt
    from expecto_tpu_torch.io import tables as tt

    feats = tmp_path / "features.tsv"
    feats.write_text("\tCell type\tAssay\tAssay type\n0\tK562\tCTCF\tTF\n1\tGM12878\tDNase\tDNase\n")
    pd.testing.assert_frame_equal(tt.load_beluga_features(feats), jt.load_beluga_features(feats))
    anno = tmp_path / "geneanno.csv"
    anno.write_text("id,symbol,seqnames,strand,TSS\nG1,A,chr1,+,100\nG2,B,chr2,-,200\n")
    pd.testing.assert_frame_equal(tt.load_geneanno(anno), jt.load_geneanno(anno))


def test_h5_writers_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    diff, ref, alt = (rng.random((6, 2002)).astype(np.float64) for _ in range(3))
    th5.write_shift_h5(tmp_path / "port.h5", diff, ref, alt)
    jh5.write_shift_h5(tmp_path / "jax.h5", diff, ref, alt)
    th5.write_legacy_shift_h5(tmp_path / "port_legacy.h5", diff)
    jh5.write_legacy_shift_h5(tmp_path / "jax_legacy.h5", diff)
    for a, b in (("port.h5", "jax.h5"), ("port_legacy.h5", "jax_legacy.h5")):
        got, want = jh5.read_shift_h5(tmp_path / a), th5.read_shift_h5(tmp_path / b)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(th5.avg_fwd_rc(got["diff"]), jh5._avg_fwd_rc(want["diff"]))
