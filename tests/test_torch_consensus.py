"""The port's GEUVADIS consensus slice vs the JAX package, fp32 on the CPU:
the host helpers it copied (FASTA parsing, Enformer padding, window and span
math, row dedup, natsorted), the backbone-patch planner (exactly equal), the
patch ops and the runner's project_spans_backbone_patch, the cohort engines
(the same engine chosen, spied on the runner methods), the four pipelines'
h5 and CSV outputs, and expecto_tpu_torch.cli.consensus.

Tolerances: track probabilities within 1e-5; features are sums of up to
len(shifts) weighted fp32 probabilities summed in other orders, within
1e-5 * max|feature|; an expression prediction moves by at most its model's
sum|w| times the features' error, so predictions are held within
1e-5 * (largest possible feature) * sum|w| (pred_tol)."""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from expecto_tpu.ops import spans as jspans
from expecto_tpu.ops.decay import gene_pos_weights
from expecto_tpu.parallel.runner import BelugaRunner as JaxBelugaRunner
from expecto_tpu.pipeline import consensus as jc
from expecto_tpu.pipeline import merge as jmerge
from expecto_tpu_torch.cli import consensus as tcli
from expecto_tpu_torch.io.xgb import save_xgb07_binary
from expecto_tpu_torch.models.convert import params_from_jax, save_params_npz
from expecto_tpu_torch.models.gblinear import GBLinearModel
from expecto_tpu_torch.ops import spans as tspans
from expecto_tpu_torch.parallel.runner import BelugaRunner
from expecto_tpu_torch.pipeline import consensus as tc
from expecto_tpu_torch.pipeline import merge as tmerge
from torch_port_common import N_TRACKS, single_torch_thread, narrow_params, onehot  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
SHIFTS = [-400, -200, 0, 200]
PW = gene_pos_weights(SHIFTS)
# batch 8 at 4 shifts: 2 spans a port chunk, so chunk loops turn
BATCH = 8
ENGINES = ("predict_codes", "predict_span_codes", "predict_spans_project", "project_spans_backbone_patch")


def feat_tol(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def pred_tol(model_path: str) -> float:
    """Track probabilities lie in [0, 1], so no feature exceeds the largest
    row sum of the decay weights; a feature error of 1e-5 of that moves a
    prediction by at most that times sum|w|."""
    w = tc.load_expression_model(model_path).weight
    return 1e-5 * float(PW.sum(axis=1).max()) * float(np.abs(w).sum())


@pytest.fixture(scope="module")
def params():
    return narrow_params(seed=31)


@pytest.fixture(scope="module")
def runners(params):
    """One JAX runner for the module: its jitted functions are built per
    runner, so sharing it compiles each span shape once."""
    return JaxBelugaRunner(params, batch_size=BATCH), BelugaRunner(params, batch_size=BATCH, device="cpu")


@pytest.fixture
def spies(runners, monkeypatch):
    """Record (method, rows, K) of every engine call on both runners."""
    calls = ([], [])
    for runner, log in zip(runners, calls):
        for name in ENGINES:
            orig = getattr(runner, name)

            def spy(*a, _orig=orig, _name=name, _log=log, **kw):
                spans = a[1] if _name == "project_spans_backbone_patch" else a[0]
                k = np.asarray(a[2]).shape[1] if _name == "project_spans_backbone_patch" else None
                _log.append((_name, int(np.asarray(spans).shape[0]), k))
                return _orig(*a, **kw)

            monkeypatch.setattr(runner, name, spy)
    return calls


# ---- cohorts ------------------------------------------------------------------------

_BASES = np.frombuffer(b"ACGTN", np.uint8)


def _seq(codes) -> str:
    return _BASES[codes].tobytes().decode()


def _mutate(backbone, sites):
    a = backbone.copy()
    for p in sites:
        a[p] = (a[p] + 1) % 4
    return _seq(a)


def cohort_spans():
    """tests/test_spans.py's cohort: the backbone, sparse, clustered and
    divergent records, a duplicate and a '-' strand record."""
    bb = np.random.default_rng(9).integers(0, 4, size=6000)
    return [(_mutate(bb, []), "+"), (_mutate(bb, [2100, 3500, 3990]), "+"),
            (_mutate(bb, [3000, 3003, 3010, 2500]), "+"), (_mutate(bb, list(range(2100, 4000, 13))), "+"),
            (_mutate(bb, [2100, 3500, 3990]), "+"), (_mutate(bb, [2200, 3600]), "-")]


def cohort_fuzz():
    """tests/test_spans.py's fuzz cohort: 0-30 random sites, N bases in the
    backbone and the samples, both strands."""
    rng = np.random.default_rng(53)
    bb = rng.integers(0, 4, size=6000)
    bb[rng.random(6000) < 2e-3] = 4

    def mk(n_sites, strand):
        a = bb.copy()
        sites = rng.choice(np.arange(1900, 4100), size=n_sites, replace=False)
        a[sites] = rng.integers(0, 5, size=n_sites)
        return (_seq(a), strand)

    return [mk(int(n), s) for n, s in zip(rng.integers(0, 30, size=7), "+++--++")]


def cohort_patch():
    """Patchable records with no fallback beside them, so the patch engine
    runs: '+' records with 1-3 private sites (K = 8) and one with 12
    scattered sites (K = 16), a backbone copy (trivial, rides the smallest
    bucket), a site in the span's aligned tail; '-' records with 1-2 sites."""
    rng = np.random.default_rng(61)
    bb = rng.integers(0, 4, size=6000)
    plus = [(_mutate(bb, []), "+")]
    plus += [(_mutate(bb, rng.choice(np.arange(1700, 4150), size=int(k), replace=False)), "+")
             for k in rng.integers(1, 4, size=5)]
    plus += [(_mutate(bb, np.arange(1700, 4100, 200)), "+"), (_mutate(bb, [4205]), "+")]
    minus = [(_mutate(bb, []), "-"), (_mutate(bb, [2000]), "-"), (_mutate(bb, [2600, 3300]), "-")]
    return plus + minus


def cohort_shared(n: int = 96):
    """Record-distinct samples (a private site outside every window) sharing
    two segregating sites inside the span, so few unique windows a shift:
    the window-dedup engine."""
    rng = np.random.default_rng(26)
    bb = rng.integers(0, 4, size=6000)
    out = []
    for b in range(n):
        sites = [s for j, s in enumerate((2500, 3300)) if (b >> j) & 1] + [5000 + b]
        out.append((_mutate(bb, sites), "+" if b % 3 else "-"))
    return out


def cohort_distinct():
    rng = np.random.default_rng(17)
    return [(_seq(rng.integers(0, 4, size=6000)), s) for s in "++-++-++"]


COHORTS = {"spans": cohort_spans, "fuzz": cohort_fuzz, "patch": cohort_patch, "shared": cohort_shared,
           "distinct": cohort_distinct, "homozygous": lambda: [cohort_distinct()[0]] * 9}


# ---- host helpers -------------------------------------------------------------------

def test_parse_fasta_plain_and_gz_match_jax(tmp_path):
    text = ">a desc\nACGT\nacgt\n\n>b\nTTNN\n>c x y\n"
    (tmp_path / "x.fa").write_text(text)
    with gzip.open(tmp_path / "x.fa.gz", "wt") as f:
        f.write(text)
    for name in ("x.fa", "x.fa.gz"):
        got = list(tc.parse_fasta(tmp_path / name))
        assert got == list(jc.parse_fasta(tmp_path / name)) == [("a", "ACGTacgt"), ("b", "TTNN"), ("c", "")]


L = tc.ENFORMER_SEQ_LENGTH


@pytest.mark.parametrize("rec_id,seq_len", [
    (f"chr1:-100-{L - 100 - 1}", 4000), (f"chr1:1-{L}", 40), (f"chr2:11-{L + 10}", L), (f"chr1:1-{L}", L + 3),
    (f"chr1:-5-{L - 5}", 100), (f"chr1:1-{L - 1}", 10),
], ids=["start_truncated", "end_truncated", "exact", "too_long", "bad_negative_interval", "bad_interval"])
def test_pad_enformer_seq_matches_jax(rec_id, seq_len):
    seq = "acgT" * (seq_len // 4) + "A" * (seq_len % 4)
    try:
        want = jc.pad_enformer_seq(rec_id, seq)
    except AssertionError as e:
        with pytest.raises(AssertionError, match=str(e).split(" ")[0]):
            tc.pad_enformer_seq(rec_id, seq)
        return
    assert tc.pad_enformer_seq(rec_id, seq) == want and len(want) == L


@pytest.mark.parametrize("strand", ["+", "-"])
def test_window_codes_and_span_bounds_match_jax(strand):
    seq = _seq(np.random.default_rng(2).integers(0, 5, size=50000))
    for shifts in (SHIFTS, [-600, -200, 0, 400], None):
        assert tc.consensus_span_bounds(len(seq), strand, shifts=shifts) == jc.consensus_span_bounds(
            len(seq), strand, shifts=shifts)
        if shifts is not None:
            np.testing.assert_array_equal(tc.consensus_window_codes(seq, strand, shifts=shifts),
                                          jc.consensus_window_codes(seq, strand, shifts=shifts))
    with pytest.raises(AssertionError, match="out of range"):
        tc.consensus_window_codes(seq[:2000], strand, shifts=SHIFTS)


@pytest.mark.parametrize("align", [1, 16])
@pytest.mark.parametrize("strand", ["+", "-"])
def test_span_and_offsets_match_jax(strand, align):
    rng = np.random.default_rng(5)
    for n in (60000, 6000, 2805):  # 2805: no room for the '-' span's aligned extension
        seq = _seq(rng.integers(0, 5, size=n))
        span, offsets = tc.consensus_span_and_offsets(seq, strand, shifts=SHIFTS, align=align)
        want_span, want_offsets = jc.consensus_span_and_offsets(seq, strand, shifts=SHIFTS, align=align)
        np.testing.assert_array_equal(span, want_span)
        assert span.dtype == np.int8 and offsets == want_offsets
        windows = tc.consensus_window_codes(seq, strand, shifts=SHIFTS)
        np.testing.assert_array_equal(np.stack([span[o : o + 2000] for o in offsets]), windows)


def test_unique_rows_and_natsorted_match_jax():
    rows = np.random.default_rng(3).integers(0, 3, size=(40, 6)).astype(np.int8)
    rows[10] = rows[3]
    got, inv = tc._unique_rows(rows)
    want, want_inv = jc._unique_rows(rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(inv, want_inv)
    np.testing.assert_array_equal(got[inv], rows)
    items = ["NA10|-|1.fa", "NA2|-|1.fa", "na1", "gene10", "Gene9", "x", "10", "9b"]
    assert tmerge.natsorted(items) == jmerge.natsorted(items) == tc.natsorted(items)


def test_patch_sites_plan_matches_jax_fuzz():
    """Seeded fuzz over span lengths (aligned or not), phases, site counts
    and clusters, and max_ranges, at the port's fixed PATCH_SUB_LEN: the
    plans, including the empty plan and None (too many ranges, an
    uncoverable tail), are equal."""
    rng = np.random.default_rng(7)
    seen = {"empty": 0, "none": 0, "plans": 0, "tail": 0}
    for trial in range(400):
        span_len = int(rng.choice([2608, 2600, 6000, 41808, 1500]))
        phases = [{0, 2}, {0}, {1, 3}, {0, 1, 2, 3}][trial % 4]
        n = int(rng.choice([0, 1, 3, 10, 40, 200]))
        pos = rng.integers(0, span_len, size=n)
        if trial % 5 == 0:
            pos = np.concatenate([pos, span_len - 1 - rng.integers(0, 30, size=3)])  # the span's tail
        max_ranges = int(rng.choice([8, 24, 32]))
        got = tspans.conv6_patch_sites_plan(pos, span_len, phases, max_ranges=max_ranges)
        assert got == jspans.conv6_patch_sites_plan(pos, span_len, phases, sub_len=tspans.PATCH_SUB_LEN,
                                                    max_ranges=max_ranges), (trial, span_len, max_ranges)
        seen["empty" if got == [] else "none" if got is None else "plans"] += 1
        seen["tail"] += bool(got) and trial % 5 == 0
        counts = {ph: (span_len - 4 * ph - 310) // 16 + 1 for ph in phases}
        a = int(rng.integers(0, span_len))
        b = min(span_len - 1, a + int(rng.integers(0, 64)))
        assert tspans.conv6_covering_start(a, b, span_len, phases, counts) == jspans.conv6_covering_start(
            a, b, span_len, tspans.PATCH_SUB_LEN, phases, counts)
    assert min(seen.values()) > 0, seen


# ---- patch ops ----------------------------------------------------------------------

def _patch_inputs(seed: int, codes: bool):
    """A backbone span of 2,608 bases, 4 samples (sites mid-span, at both
    ends, none), planned starts in K = 8 slots with inactive slots 0, and a
    start past L - 704 in the last sample's free slot: the gather clamps it
    to L - 704 while its frames land at start // 16, some past the end."""
    rng = np.random.default_rng(seed)
    span_len, phases = 2608, {0, 2}
    bb = rng.integers(0, 4, size=span_len).astype(np.int8)
    samples = np.stack([bb] * 4)
    for i, sites in enumerate([[1300], [5, 2600, 1800, 1810], [700, 1500, 2200], []]):
        for p in sites:
            samples[i, p] = (samples[i, p] + 1 + i) % 5
    w0 = np.zeros((4, 8), np.int64)
    d0 = np.zeros((4, 8), np.int64)
    for i in range(4):
        plan = tspans.conv6_patch_sites_plan(np.nonzero(samples[i] != bb)[0], span_len, phases)
        assert plan is not None
        for k, (w, d) in enumerate(plan):
            w0[i, k], d0[i, k] = w, d
    tail = w0.copy()
    tail[3, 2] = span_len - 608
    x = samples if codes else onehot(samples)
    xb = bb[None] if codes else onehot(bb[None])
    return phases, x, xb, samples, w0, d0, tail


def _jx(x):
    """The JAX ops take one-hot spans."""
    import jax.numpy as jnp

    return jnp.asarray(onehot(x) if x.dtype == np.int8 else x)


@pytest.mark.parametrize("codes", [True, False], ids=["codes", "onehot"])
def test_conv6_phases_patch_sites_matches_jax_and_full(params, codes):
    """Against JAX on the same starts (a clamped tail start included), and
    against the full conv6_phases of the samples on the planned starts; the
    backbone buffers are left as they were."""
    import jax
    import jax.numpy as jnp

    phases, x, xb, samples, w0, _d0, tail = _patch_inputs(1, codes)
    tp = params_from_jax(params, device="cpu", dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, params)
    base = tspans.conv6_phases(tp, torch.from_numpy(xb), phases)
    base_copy = {ph: b.clone() for ph, b in base.items()}
    jbase = jspans.conv6_phases(jp, _jx(xb), phases)
    full = tspans.conv6_phases(tp, torch.from_numpy(samples), phases)
    for starts, vs_full in ((w0, True), (tail, False)):
        got = tspans.conv6_phases_patch_sites(tp, base, torch.from_numpy(x), torch.from_numpy(starts), phases)
        want = jspans.conv6_phases_patch_sites(jp, jbase, _jx(x), jnp.asarray(starts), phases)
        for ph in phases:
            assert got[ph].shape == full[ph].shape
            np.testing.assert_allclose(got[ph].numpy(), np.asarray(want[ph]), rtol=TOL, atol=TOL)
            if vs_full:
                np.testing.assert_allclose(got[ph].numpy(), full[ph].numpy(), rtol=TOL, atol=TOL)
            torch.testing.assert_close(base[ph], base_copy[ph], rtol=0, atol=0)


def test_conv6_phases_patch_sites_c1_matches_jax_and_full(params):
    import jax
    import jax.numpy as jnp

    phases, x, xb, samples, w0, d0, _tail = _patch_inputs(2, True)
    tp = params_from_jax(params, device="cpu", dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, params)
    base = tspans.conv6_phases(tp, torch.from_numpy(xb), phases)
    base_c1 = tspans.conv1_acts(tp, torch.from_numpy(xb))
    got = tspans.conv6_phases_patch_sites_c1(tp, base_c1, base, torch.from_numpy(x), torch.from_numpy(w0),
                                             torch.from_numpy(d0), phases)
    jxb = _jx(xb)
    want = jspans.conv6_phases_patch_sites_c1(jp, jspans.conv1_acts(jp, jxb), jspans.conv6_phases(jp, jxb, phases),
                                              _jx(x), jnp.asarray(w0), jnp.asarray(d0), phases)
    full = tspans.conv6_phases(tp, torch.from_numpy(samples), phases)
    raw = tspans.conv6_phases_patch_sites(tp, base, torch.from_numpy(x), torch.from_numpy(w0), phases)
    for ph in phases:
        np.testing.assert_allclose(got[ph].numpy(), np.asarray(want[ph]), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[ph].numpy(), full[ph].numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[ph].numpy(), raw[ph].numpy(), rtol=TOL, atol=TOL)


def test_splice_drops_rows_past_the_end_and_repeats_bit_for_bit():
    """Frames at f0 + j >= F (and below 0) are dropped, never wrapped or
    raised on; overlapping slots resolve to the last slot; rows are copies."""
    base = torch.arange(10 * 3, dtype=torch.float32).reshape(1, 10, 3)
    patches = -torch.ones((2, 3, 4, 3)) * torch.arange(1, 4)[None, :, None, None]
    starts = torch.tensor([[8, 0, 2], [-2, 9, 9]])
    got = tspans._splice_rows(base, patches, starts, 2)
    want = base.expand(2, 10, 3).clone()
    for i in range(2):
        for k in range(3):
            for j in range(4):
                f = int(starts[i, k]) + j
                if 0 <= f < 10:
                    want[i, f] = patches[i, k, j]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(tspans._splice_rows(base, patches, starts, 2), got, rtol=0, atol=0)
    got[0, 0] = 99
    assert got[1, 0, 0] != 99 and base[0, 0, 0] != 99


# ---- runner ---------------------------------------------------------------------------

def _patch_plan(rows, span_len, offsets, max_ranges=24):
    """(backbone, starts_f, starts_r) as the cohort engine plans them."""
    bb = rows[0]
    phases_f = {(o // 4) % 4 for o in offsets}
    phases_r = {((span_len - 2000 - o) // 4) % 4 for o in offsets}
    plans = []
    for r in rows:
        dp = np.nonzero(r != bb)[0]
        plans.append((tspans.conv6_patch_sites_plan(dp, span_len, phases_f, max_ranges=max_ranges),
                      tspans.conv6_patch_sites_plan((span_len - 1 - dp)[::-1], span_len, phases_r,
                                                    max_ranges=max_ranges)))
    k = max(8, max(len(p) for pl in plans for p in pl))
    sf, sr = (np.zeros((len(rows), k, 2), np.int32) for _ in range(2))
    for m, (pf, pr) in enumerate(plans):
        if pf:
            sf[m, : len(pf)] = pf
        if pr:
            sr[m, : len(pr)] = pr
    return bb, sf, sr


@pytest.mark.parametrize("strand", ["+", "-"])
def test_project_spans_backbone_patch_matches_jax(runners, strand):
    """Five samples (three port chunks of two) against the JAX runner's
    method and the port's predict_spans_project on the same samples."""
    jr, tr = runners
    seqs = [s for s, _ in cohort_patch()[:6]]
    spans, offsets = zip(*(tc.consensus_span_and_offsets(s, strand, shifts=SHIFTS, align=16) for s in seqs))
    rows = np.stack(spans)
    bb, sf, sr = _patch_plan(rows, rows.shape[1], offsets[0])
    got = tr.project_spans_backbone_patch(bb, rows[1:], sf[1:], sr[1:], offsets[0], PW)
    want = jr.project_spans_backbone_patch(bb, rows[1:], sf[1:], sr[1:], offsets[0], PW)
    assert got.shape == (5, 10 * N_TRACKS) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=feat_tol(want))
    np.testing.assert_allclose(got, tr.predict_spans_project(rows[1:], offsets[0], PW), rtol=0, atol=feat_tol(want))


# ---- cohort engines ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["spans", "fuzz", "patch", "shared"])
def test_cohort_features_match_jax(runners, spies, name):
    jr, tr = runners
    seqs = COHORTS[name]()
    want = jc._predict_consensus_features_cohort(jr, seqs, SHIFTS)
    got = tc._predict_consensus_features_cohort(tr, seqs, SHIFTS)
    assert got.shape == want.shape == (len(seqs), 20030) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=feat_tol(want))
    jcalls, tcalls = spies
    assert tcalls == jcalls
    used = {c[0] for c in tcalls}
    expected = {"spans": {"predict_spans_project"}, "patch": {"project_spans_backbone_patch"},
                "shared": {"predict_codes"}}.get(name)
    assert expected is None or used == expected, tcalls
    if name == "patch":
        assert {c[2] for c in tcalls} == {8, 16}


@pytest.mark.parametrize("name", ["shared", "distinct", "homozygous", "spans"])
def test_consensus_preds_match_jax(runners, spies, name):
    jr, tr = runners
    seqs = COHORTS[name]()
    want = jc._predict_consensus_preds(jr, seqs, SHIFTS)
    got = tc._predict_consensus_preds(tr, seqs, SHIFTS)
    assert got.shape == want.shape == (len(seqs), len(SHIFTS), N_TRACKS) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jcalls, tcalls = spies
    assert tcalls == jcalls
    expected = {"distinct": [("predict_span_codes", 6, None), ("predict_span_codes", 2, None)],
                "homozygous": [("predict_span_codes", 1, None)]}.get(name)
    assert expected is None or tcalls == expected, tcalls
    if name == "shared":  # unique windows only: two sites, two strands, four shifts
        assert [c[0] for c in tcalls] == ["predict_codes"] and tcalls[0][1] <= 32


# ---- pipelines ------------------------------------------------------------------------

def _write_fasta(path, rec_id, seq, width=80):
    with open(path, "w") as f:
        f.write(f">{rec_id}\n")
        for i in range(0, len(seq), width):
            f.write(seq[i : i + width] + "\n")


@pytest.fixture(scope="module")
def consensus_tree(tmp_path_factory):
    """consensus_dir with two genes (one a strand) x two samples + ref.fa,
    the genes csv and a seeded 20,030-feature model (the JAX package's
    tests/test_consensus.py layout); the samples share most of the ref."""
    tmp_path = tmp_path_factory.mktemp("consensus")
    rng = np.random.default_rng(0)
    rows = []
    for gi, (gene, strand) in enumerate({"genea": "+", "geneb": "-"}.items()):
        start = 1000 + gi * 500000
        rec_id = f"chr1:{start}-{start + L - 1}"
        os.makedirs(tmp_path / "consensus" / gene / "samples")
        ref = rng.integers(0, 4, size=L)
        for si, sample in enumerate(["NA1", "NA2"]):
            tss = L // 2
            sites = tss + rng.integers(-1200, 1200, size=2 + si)
            _write_fasta(tmp_path / "consensus" / gene / "samples" / f"{sample}|-|1pIu.fa", rec_id,
                         _mutate(ref, sites))
        _write_fasta(tmp_path / "consensus" / gene / "ref.fa", rec_id, _seq(ref))
        rows.append([f"ENSG{gi:011d}", "chr1", start + L // 2, gene.upper(), strand])
    genes_file = tmp_path / "genes.csv"
    pd.DataFrame(rows).to_csv(genes_file, header=False, index=False)
    model_path = tmp_path / "model.save"
    w = np.random.default_rng(1).normal(size=10 * (N_TRACKS + 1)).astype(np.float32) * 0.001
    save_xgb07_binary(GBLinearModel(weight=w, bias=0.1, base_score=2.0), model_path)
    return tmp_path, str(model_path), str(tmp_path / "consensus"), str(genes_file)


def _h5(path) -> dict:
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def _assert_h5_equal(got_path, want_path, tol):
    got, want = _h5(got_path), _h5(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if want[k].dtype.kind in "SO":
            assert list(got[k]) == list(want[k]), k
        else:
            np.testing.assert_allclose(got[k].astype(np.float64), want[k], rtol=0, atol=tol(k), err_msg=k)


@pytest.mark.parametrize("mode", ["full", "fp16", "features_only"])
def test_predict_consensus_genes_matches_jax(consensus_tree, runners, mode):
    """{gene}.h5 and {gene}_chromatin.h5 of both packages, then the resume
    skip and an ``exp_only`` rerun from the cached chromatin h5."""
    tmp_path, model, cdir, gfile = consensus_tree
    jr, tr = runners
    kw = {"shifts": SHIFTS, "features_only": mode == "features_only",
          "chromatin_dtype": np.float16 if mode == "fp16" else np.float32}
    out_j, out_t = str(tmp_path / f"j_{mode}"), str(tmp_path / f"t_{mode}")
    assert jc.predict_consensus_genes(model, cdir, gfile, jr, out_j, **kw) == ["genea", "geneb"]
    assert tc.predict_consensus_genes(model, cdir, gfile, tr, out_t, **kw) == ["genea", "geneb"]
    # fp16 chromatin: both round the same fp32 values to fp16, so a track may
    # land one fp16 step (2^-11 below 1) apart
    tols = {"expecto_preds": pred_tol(model), "chromatin_preds": 2.0**-11 if mode == "fp16" else TOL}
    for gene in ("genea", "geneb"):
        _assert_h5_equal(f"{out_t}/{gene}/{gene}.h5", f"{out_j}/{gene}/{gene}.h5", tols.get)
        chrom = f"{gene}/{gene}_chromatin.h5"
        assert os.path.exists(f"{out_t}/{chrom}") == (mode != "features_only")
        if mode != "features_only":
            _assert_h5_equal(f"{out_t}/{chrom}", f"{out_j}/{chrom}", tols.get)
    assert tc.predict_consensus_genes(model, cdir, gfile, tr, out_t, **kw) == []  # resume: nothing to do
    if mode != "features_only":
        kw_exp = {**kw, "exp_only": True, "overwrite": True}
        assert tc.predict_consensus_genes(model, cdir, gfile, tr, out_t, **kw_exp) == ["genea", "geneb"]
        jc.predict_consensus_genes(model, cdir, gfile, jr, out_j, **kw_exp)
        for gene in ("genea", "geneb"):
            _assert_h5_equal(f"{out_t}/{gene}/{gene}.h5", f"{out_j}/{gene}/{gene}.h5", tols.get)


def test_predict_consensus_genes_chunks_and_errors(consensus_tree, runners):
    tmp_path, model, cdir, gfile = consensus_tree
    _jr, tr = runners
    out = str(tmp_path / "t_chunk")
    kw = {"shifts": SHIFTS, "features_only": True}
    assert tc.predict_consensus_genes(model, cdir, gfile, tr, out, num_chunks=2, chunk_i=1, **kw) == ["geneb"]
    assert tc.predict_consensus_genes(model, cdir, gfile, tr, out, genes=["genea"], **kw) == ["genea"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        tc.predict_consensus_genes(model, cdir, gfile, tr, out, shifts=SHIFTS, exp_only=True, features_only=True)
    with pytest.raises(ValueError, match="passed together"):
        tc.predict_consensus_genes(model, cdir, gfile, tr, out, num_chunks=2, **kw)
    with pytest.raises(AssertionError, match="empty list"):
        tc.predict_consensus_genes(model, cdir, gfile, tr, out, num_chunks=3, chunk_i=2, **kw)


@pytest.mark.parametrize("genes_per_call", [32, 1])
def test_ref_all_genes_matches_jax(consensus_tree, runners, genes_per_call):
    tmp_path, model, cdir, gfile = consensus_tree
    jr, tr = runners
    want = jc.predict_ref_all_genes(model, cdir, gfile, jr, str(tmp_path / "j_ref"), shifts=SHIFTS)
    got = tc.predict_ref_all_genes(model, cdir, gfile, tr, str(tmp_path / f"t_ref{genes_per_call}"), shifts=SHIFTS,
                                   genes_per_call=genes_per_call)
    csv = pd.read_csv(tmp_path / f"t_ref{genes_per_call}" / "ref_preds.csv", float_precision="round_trip")
    want_csv = pd.read_csv(tmp_path / "j_ref" / "ref_preds.csv")
    assert list(csv.columns) == ["genes", "ref_preds"] and list(csv["genes"]) == list(want_csv["genes"])
    assert list(got["genes"]) == list(want["genes"]) == ["GENEA", "GENEB"]
    np.testing.assert_allclose(csv["ref_preds"], want_csv["ref_preds"], rtol=0, atol=pred_tol(model))
    np.testing.assert_allclose(got["ref_preds"], csv["ref_preds"], rtol=0, atol=0)


def _eqtls(cdir, offsets):
    """eQTL rows on genea's ref.fa, one a SNP offset from the TSS."""
    rec_id, seq = next(tc.parse_fasta(f"{cdir}/genea/ref.fa"))
    start = int(rec_id.split(":")[1].split("-")[0])
    tss_pos = start + L // 2
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return pd.DataFrame([{"name": "genea", "CHR_SNP": 1, "TSSpos_x": tss_pos, "SNPpos": tss_pos - o,
                          "REF": seq[L // 2 - o], "ALT": comp[seq[L // 2 - o]]} for o in offsets])


def test_eqtl_sed_matches_jax_and_warns_on_shared_genes(consensus_tree, runners):
    tmp_path, model, cdir, gfile = consensus_tree
    jr, tr = runners
    _eqtls(cdir, [150, -700, 30]).to_csv(tmp_path / "eqtls.csv", index=False)
    with pytest.warns(UserWarning, match="share a gene name"):
        got = tc.sed_for_top_eqtls(model, cdir, gfile, str(tmp_path / "eqtls.csv"), tr, str(tmp_path / "t_sed"),
                                   shifts=SHIFTS, pairs_per_call=2)
    with pytest.warns(UserWarning, match="share a gene name"):
        want = jc.sed_for_top_eqtls(model, cdir, gfile, str(tmp_path / "eqtls.csv"), jr, str(tmp_path / "j_sed"),
                                    shifts=SHIFTS)
    assert list(got.columns) == ["gene", "ref_pred", "alt_pred", "sed"] and list(got["gene"]) == ["genea"] * 3
    for col, k in (("ref_pred", 1), ("alt_pred", 1), ("sed", 2)):  # SED differences two predictions
        np.testing.assert_allclose(got[col], want[col], rtol=0, atol=k * pred_tol(model), err_msg=col)
    assert (got["sed"].abs() > 0).all()
    _assert_h5_equal(tmp_path / "t_sed" / "genea" / "genea.h5", tmp_path / "j_sed" / "genea" / "genea.h5",
                     lambda k: pred_tol(model))


def test_eqtl_ref_mismatch_raises(consensus_tree, runners):
    tmp_path, model, cdir, gfile = consensus_tree
    _jr, tr = runners
    bad = _eqtls(cdir, [10])
    bad["REF"] = {"A": "C", "C": "A", "G": "T", "T": "G"}[bad["REF"].iloc[0]]
    bad.to_csv(tmp_path / "bad_eqtls.csv", index=False)
    with pytest.raises(AssertionError, match="does not match ref allele"):
        tc.sed_for_top_eqtls(model, cdir, gfile, str(tmp_path / "bad_eqtls.csv"), tr, str(tmp_path / "x"),
                             shifts=SHIFTS)
    bad = _eqtls(cdir, [10])
    bad["TSSpos_x"] += 1
    bad.to_csv(tmp_path / "bad_tss.csv", index=False)
    with pytest.raises(AssertionError, match="TSSpos"):
        tc.sed_for_top_eqtls(model, cdir, gfile, str(tmp_path / "bad_tss.csv"), tr, str(tmp_path / "x"),
                             shifts=SHIFTS)


def test_top_eqtls_matches_jax(tmp_path, consensus_tree, runners):
    """The gzipped one-FASTA-per-gene layout (strand in the record id) and
    its 'preds', 'record_ids' and 'seqs' datasets."""
    _tmp, model, _cdir, _gfile = consensus_tree
    jr, tr = runners
    rng = np.random.default_rng(7)
    gene, start = "hla-b", 5000
    os.makedirs(tmp_path / "consensus" / gene)
    bb = rng.integers(0, 4, size=L)
    recs = [(f"chr6:{start}-{start + L - 1}|NA{i}|{s}|1pIu", _mutate(bb, L // 2 + rng.integers(-900, 900, size=2)))
            for i, s in enumerate("+-+")]
    with gzip.open(tmp_path / "consensus" / gene / f"{gene}.fa.gz", "wt") as f:
        for rid, seq in recs:
            f.write(f">{rid}\n{seq}\n")
    pd.DataFrame({"name": ["HLA-B"], "geneID": ["ENSG1"], "CHR_SNP": [6], "SNPpos": [31324000]}).to_csv(
        tmp_path / "eqtls.csv", index=False)
    pd.DataFrame({0: ["chr6"], 1: [31324000], 2: ["rs1"], 3: ["A"], 4: ["G"]}).to_csv(
        tmp_path / "snps.vcf", sep="\t", header=False, index=False)
    args = (model, str(tmp_path / "consensus"), str(tmp_path / "eqtls.csv"), str(tmp_path / "snps.vcf"))
    got = tc.predict_consensus_for_top_eqtls(*args, tr, str(tmp_path / "t"), genes=["HLA-B"], shifts=SHIFTS)
    want = jc.predict_consensus_for_top_eqtls(*args, jr, str(tmp_path / "j"), genes=["HLA-B"], shifts=SHIFTS)
    pd.testing.assert_frame_equal(got, want)
    _assert_h5_equal(tmp_path / "t" / gene / f"{gene}.h5", tmp_path / "j" / gene / f"{gene}.h5",
                     lambda k: pred_tol(model))
    assert [s.decode() for s in _h5(tmp_path / "t" / gene / f"{gene}.h5")["record_ids"]] == [r for r, _ in recs]


# ---- CLI -----------------------------------------------------------------------------

def _cli_args(consensus_tree, cmd, out, *extra):
    tmp_path, model, cdir, gfile = consensus_tree
    weights = tmp_path / "beluga.npz"
    if not weights.exists():
        save_params_npz(narrow_params(seed=31), weights)
    return [cmd, model, cdir, gfile, "--beluga_weights", str(weights), "-o", str(out), *extra]


@pytest.mark.parametrize("cmd,flags", [("ref", []), ("samples", ["--features_only"]), ("samples", ["--fp16_chromatin"])],
                         ids=["ref", "samples_features_only", "samples_fp16"])
def test_cli_equals_in_process_call(consensus_tree, runners, monkeypatch, cmd, flags):
    """The CLI with --device cpu (its default batch 1,024) against the
    pipeline called with the same settings; the CLI's gene shifts are the
    full 200, so the in-process call takes them too."""
    tmp_path, model, cdir, gfile = consensus_tree
    out = tmp_path / f"cli_{cmd}_{'_'.join(flags)}"
    assert tcli.main(_cli_args(consensus_tree, cmd, out, "--device", "cpu", *flags)) == 0
    runner = BelugaRunner(narrow_params(seed=31), batch_size=1024, device="cpu",
                          out_dtype=np.float16 if "--fp16_chromatin" in flags else np.float32)
    ref_out = tmp_path / f"inproc_{cmd}_{'_'.join(flags)}"
    if cmd == "ref":
        want = tc.predict_ref_all_genes(model, cdir, gfile, runner, str(ref_out))
        pd.testing.assert_frame_equal(pd.read_csv(out / "ref_preds.csv", float_precision="round_trip"), want)
        return
    fp16 = "--fp16_chromatin" in flags
    tc.predict_consensus_genes(model, cdir, gfile, runner, str(ref_out), features_only="--features_only" in flags,
                               chromatin_dtype=np.float16 if fp16 else np.float32)
    for gene in ("genea", "geneb"):
        for name in [f"{gene}.h5"] + ([f"{gene}_chromatin.h5"] if fp16 else []):
            _assert_h5_equal(out / gene / name, ref_out / gene / name, lambda k: 0.0)


def test_cli_defaults_to_cuda_and_raises_without_gpu(consensus_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(_cli_args(consensus_tree, "ref", tmp_path / "x"))
    args = tcli.build_parser().parse_args(_cli_args(consensus_tree, "samples", tmp_path / "x"))
    assert (args.device, args.batch_size, args.bf16, args.fp16_chromatin) == ("cuda", 1024, False, False)


def test_consensus_imports_and_ref_runs_without_h5py(consensus_tree, tmp_path):
    """With h5py unimportable, pipeline/consensus.py and the CLI import and
    the ``ref`` subcommand writes its CSV on the CPU."""
    argv = _cli_args(consensus_tree, "ref", tmp_path / "ref", "--device", "cpu", "--batch_size", "64")
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"  # any `import h5py` now raises ImportError
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import expecto_tpu_torch.pipeline.consensus\n"
        "from expecto_tpu_torch.cli.consensus import main\n"
        f"assert main({argv!r}) == 0\n"
        "assert 'h5py' not in [m for m, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert len(pd.read_csv(tmp_path / "ref" / "ref_preds.csv")) == 2
