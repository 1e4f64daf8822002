"""The seeded generators: the same seed gives the same inputs, calls and
seeds differ, and every call has the same composition."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import inputs

from .conftest import TINY_BELUGA, TINY_GENOME, TINY_TRAFFIC

TRAFFIC = {**TINY_TRAFFIC["score"], "variants_per_call": 200, "indel_share": 0.1, "indel_max_len": 6,
           "edge_margin": 5000, "tss_spacing": 40000}
BIG_SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def genome():
    return inputs.make_genome(TINY_GENOME)


@pytest.fixture(scope="module")
def annotation(genome):
    return inputs.make_annotation(genome, 40000)


def _same(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in a.__dataclass_fields__)


def test_genome_is_fixed_and_has_n_runs(genome):
    again = inputs.make_genome(TINY_GENOME)
    assert all(np.array_equal(genome.contigs[c], again.contigs[c]) for c in genome.contigs)
    seq = np.concatenate(list(genome.contigs.values()))
    assert set(np.unique(seq).tobytes()) <= set(b"ACGTN")
    assert 0 < (seq == ord("N")).mean() < 0.05


def test_fasta_round_trip(genome, tmp_path):
    path = str(tmp_path / "g.fa")
    inputs.write_fasta(genome, path, width=61)
    back = inputs.read_fasta(path)
    assert list(back.contigs) == list(genome.contigs)
    assert all(np.array_equal(back.contigs[c], genome.contigs[c]) for c in genome.contigs)


def test_fasta_reads_the_same_through_the_port(genome, tmp_path):
    from expecto_tpu_torch.genome.fasta import FastaIndex

    path = str(tmp_path / "g.fa")
    inputs.write_fasta(genome, path)
    fa = FastaIndex(path)
    try:
        assert fa.sequence("chr2", 1001, 1100).encode() == genome.contigs["chr2"][1000:1100].tobytes()
    finally:
        fa.close()


def test_cached_genome_reads_back(tmp_path):
    g1, p1 = inputs.cached_genome(TINY_GENOME, str(tmp_path))
    g2, p2 = inputs.cached_genome(TINY_GENOME, str(tmp_path))
    assert p1 == p2
    assert all(np.array_equal(g1.contigs[c], g2.contigs[c]) for c in g1.contigs)


@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_vcf_is_deterministic_per_seed_and_call(genome, annotation, seed):
    a = inputs.make_vcf(seed, 3, genome, annotation, TRAFFIC)
    b = inputs.make_vcf(seed, 3, genome, annotation, TRAFFIC)
    assert _same(a, b)
    assert not np.array_equal(a.pos, inputs.make_vcf(seed, 4, genome, annotation, TRAFFIC).pos)
    assert not np.array_equal(a.pos, inputs.make_vcf(seed + 1, 3, genome, annotation, TRAFFIC).pos)


def test_vcf_composition_is_fixed(genome, annotation):
    mixes = []
    for seed, call in ((1, 0), (1, 1), (BIG_SEED, 7)):
        v = inputs.make_vcf(seed, call, genome, annotation, TRAFFIC)
        dl = sorted(len(a) - len(r) for r, a in zip(v.ref, v.alt))
        mixes.append(dl)
        assert len(v) == 200
        assert sum(len(r) != len(a) for r, a in zip(v.ref, v.alt)) == 20
        # REF matches the genome, no N in it, positions distinct and sorted
        for c, p, r in zip(v.chrom, v.pos, v.ref):
            assert genome.contigs[c][p - 1 : p - 1 + len(r)].tobytes().decode() == r
            assert "N" not in r
        keys = list(zip(v.chrom, v.pos))
        assert keys == sorted(keys) and len(set(keys)) == len(keys)
        assert all(a != r for r, a in zip(v.ref, v.alt))
    assert mixes[0] == mixes[1] == mixes[2]
    assert max(mixes[0]) == 6 and min(mixes[0]) == -6


def test_closest_tss_is_closest(genome, annotation):
    v = inputs.make_vcf(5, 0, genome, annotation, TRAFFIC)
    for c, p, t in zip(v.chrom, v.pos, v.tss):
        on = annotation.tss[annotation.chrom == c]
        assert abs(t - p) == np.abs(on - p).min()


def test_genes_half_on_each_strand_inside_margins(genome):
    tr = {**TINY_TRAFFIC["genes"], "genes_per_call": 10, "tss_margin": 21000}
    g = inputs.make_genes(3, 0, genome, tr)
    assert (g.strand == 1).sum() == 5 and (g.strand == -1).sum() == 5
    for c, t in zip(g.chrom, g.tss):
        assert 21000 <= t <= len(genome.contigs[c]) - 21000
    again = inputs.make_genes(3, 0, genome, tr)
    assert np.array_equal(g.tss, again.tss)
    assert not np.array_equal(g.tss, inputs.make_genes(3, 1, genome, tr).tss)


def test_weights_are_seeded_and_he_scaled():
    cfg = {"conv_width": 8, "conv_channels": [320, 320, 480, 480, 640, 640], "conv6_frames": 106, "fc1_out": 64,
           "tracks": 2002}
    a = inputs.make_beluga(BIG_SEED, cfg, "cpu")
    b = inputs.make_beluga(BIG_SEED, cfg, "cpu")
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in a)
    assert a["conv1"]["w"].shape == (8, 320, 320)
    assert a["fc1"]["w"].shape == (640 * 106, 64)
    std = float(a["conv3"]["w"].std())
    assert abs(std - (2.0 / (8 * 480)) ** 0.5) / std < 0.02
    c = inputs.make_beluga(BIG_SEED + 1, {**cfg, **TINY_BELUGA}, "cpu")
    assert c["conv1"]["w"].shape == (8, 8, 8)


def test_model_files_read_back_through_the_port(tmp_path):
    from expecto_tpu_torch.io.xgb import load_expression_model

    models = inputs.make_models(9, 200, 3, 2.0, "cpu")
    paths = inputs.write_models(models, str(tmp_path))
    for k, p in enumerate(paths):
        m = load_expression_model(p)
        assert np.array_equal(m.weight, models.W[:, k])
        assert m.bias == pytest.approx(float(models.bias[k]))
        assert m.base_score == 2.0


def test_training_matrices_are_seeded():
    X, Y = inputs.make_training(BIG_SEED, 50, 40, 3, "cpu")
    X2, Y2 = inputs.make_training(BIG_SEED, 50, 40, 3, "cpu")
    assert torch.equal(X, X2) and torch.equal(Y, Y2)
    assert X.shape == (50, 40) and Y.shape == (50, 3)
    assert abs(float(Y.mean()) - 2.0) < 0.5
