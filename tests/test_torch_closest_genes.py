"""The port's variant-gene association builder (expecto_tpu_torch/genome/
closest_genes.py, cli/closest_genes.py) vs the JAX package's, on the CPU:
a seeded annotation with genes on both strands and on two chromosomes, TSS
ties, variants on and just past the receptive field's edges and one outside
every field; the closest-gene and the receptive-field modes give equal
frames, and both command lines equal files."""

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.cli.closest_genes import main as jax_cg_main
from expecto_tpu.genome import closest_genes as jcg
from expecto_tpu_torch.cli.closest_genes import main as cg_main
from expecto_tpu_torch.genome import closest_genes as tcg
from expecto_tpu_torch.genome.windows import gene_shifts

#: [start, stop] of -dist in the field (windowsize 1000, shifts -20,000..19,800)
PLUS_FIELD, MINUS_FIELD = (-20499, 20300), (-20299, 20500)


@pytest.fixture(scope="module")
def geneanno():
    """40 seeded genes on chr1 and chr2, both strands, indexed by id, plus
    two genes sharing one TSS (a tie)."""
    rng = np.random.default_rng(21)
    n = 40
    tss = rng.integers(50_000, 400_000, n)
    df = pd.DataFrame({
        "symbol": [f"S{i}" for i in range(n)], "seqnames": rng.choice(["chr1", "chr2"], n),
        "strand": rng.choice(["+", "-"], n), "TSS": tss, "CAGE_representative_TSS": tss,
        "type": ["protein_coding"] * n,
    }, index=pd.Index([f"ENSG{i:05d}" for i in range(n)], name="id"))
    tie = pd.DataFrame({"symbol": ["T1", "T2"], "seqnames": ["chr1", "chr1"], "strand": ["+", "-"],
                        "TSS": [500_000, 500_000], "CAGE_representative_TSS": [500_000, 500_000],
                        "type": ["protein_coding"] * 2}, index=pd.Index(["ENSG90000", "ENSG90001"], name="id"))
    return pd.concat([df, tie])


@pytest.fixture(scope="module")
def vcf(geneanno):
    """Seeded substitutions, one at the tied TSS, four at the field's edges
    of a plus-strand gene (on, and one past, each bound), and one 100 kb
    from every gene."""
    rng = np.random.default_rng(22)
    rows = [[c, int(p), ".", "A", "G"] for c, p in zip(rng.choice(["chr1", "chr2"], 30), rng.integers(40_000, 420_000, 30))]
    rows.append(["chr1", 500_000, ".", "C", "T"])  # at the tie
    plus = geneanno[(geneanno["strand"] == "+") & (geneanno["seqnames"] == "chr2")].iloc[0]
    tss = int(plus["CAGE_representative_TSS"])
    for neg_dist in (PLUS_FIELD[0], PLUS_FIELD[0] - 1, PLUS_FIELD[1], PLUS_FIELD[1] + 1):
        rows.append(["chr2", tss + neg_dist, ".", "G", "A"])  # -dist = snp_pos - tss
    rows.append(["chr1", 620_000, "rs_far", "T", "C"])  # outside every field: the closest gene instead
    return pd.DataFrame(rows)


def test_receptive_field_bounds_match_jax():
    shifts = np.asarray(gene_shifts())
    for strand, want in (("+", PLUS_FIELD), ("-", MINUS_FIELD)):
        assert tcg._receptive_field_bounds(strand, shifts) == jcg._receptive_field_bounds(strand, shifts) == want
        assert tcg._receptive_field_bounds(strand, shifts, 2000) == jcg._receptive_field_bounds(strand, shifts, 2000)
        for dist in (-want[1] - 1, -want[1], 0, -want[0], -want[0] + 1):
            assert tcg.is_in_receptive_field(dist, strand, shifts) == jcg.is_in_receptive_field(dist, strand, shifts)
            assert tcg.is_in_receptive_field(dist, strand, shifts) == (want[0] <= -dist <= want[1])


def test_find_closest_gene_matches_jax(geneanno, vcf):
    for _, row in vcf.iterrows():
        got = tcg.find_closest_gene(row[0], int(row[1]), geneanno)
        pd.testing.assert_frame_equal(got, jcg.find_closest_gene(row[0], int(row[1]), geneanno))
        assert len(got) == 1
    assert tcg.find_closest_gene("chr1", 500_000, geneanno).index[0] == "ENSG90000"  # a tie takes the first


def test_receptive_field_genes_match_jax_and_the_per_gene_rule(geneanno, vcf):
    shifts = np.asarray(gene_shifts())
    for _, row in vcf.iterrows():
        got = tcg.get_genes_in_receptive_field(row[0], int(row[1]), geneanno)
        pd.testing.assert_frame_equal(got, jcg.get_genes_in_receptive_field(row[0], int(row[1]), geneanno))
        sub = geneanno[geneanno["seqnames"] == row[0]]
        inside = [g for g, r in sub.iterrows()
                  if tcg.is_in_receptive_field(r["CAGE_representative_TSS"] - int(row[1]), r["strand"], shifts)]
        assert list(got.index) == (inside or list(tcg.find_closest_gene(row[0], int(row[1]), geneanno).index))
    far = tcg.get_genes_in_receptive_field("chr1", 620_000, geneanno)
    assert len(far) == 1 and abs(int(far["dists"].iloc[0])) > 100_000


@pytest.mark.parametrize("all_rf", [False, True], ids=["closest", "receptive_field"])
def test_make_closest_genes_table_matches_jax(geneanno, vcf, all_rf):
    got, got_vcf = tcg.make_closest_genes_table(vcf, geneanno, all_in_receptive_field=all_rf)
    want, want_vcf = jcg.make_closest_genes_table(vcf, geneanno, all_in_receptive_field=all_rf)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(got_vcf, want_vcf)
    assert got.shape[1] == 11 and len(got_vcf) == len(got)
    assert (got["dist_to_tss"] == got["tss_pos"] - got["snp_pos"]).all()
    if all_rf:
        assert len(got) > len(vcf) and set(got.loc[got["snp_pos"] == 500_000, "ens_id"]) >= {"ENSG90000", "ENSG90001"}
    else:
        assert len(got) == len(vcf)


@pytest.mark.parametrize("extra", [[], ["--all_in_receptive_field"], ["--add_chr_prefix"]],
                         ids=["closest", "receptive_field", "add_chr_prefix"])
def test_closest_genes_cli_matches_jax(tmp_path, geneanno, vcf, extra):
    vcf.to_csv(tmp_path / "in.vcf", sep="\t", header=False, index=False)
    geneanno.to_csv(tmp_path / "geneanno.csv")
    for main, tag in ((cg_main, "port"), (jax_cg_main, "jax")):
        assert main([str(tmp_path / "in.vcf"), "--annoFile", str(tmp_path / "geneanno.csv"), "-o", str(tmp_path / tag),
                     *extra]) == 0
    for name in ("closest_genes.tsv", "snps_hg19.vcf", "snps_expanded.vcf"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    table = pd.read_csv(tmp_path / "port" / "closest_genes.tsv", sep="\t", header=None)
    assert table.shape[1] == 11 and (table.shape[0] > len(vcf)) == bool(extra and "--all" in extra[0])
    assert (tmp_path / "port" / "snps_hg19.vcf").read_text().startswith("##fileformat=VCFv4.3\n#CHROM")


def test_closest_genes_cli_takes_bare_numeric_chromosome_names(tmp_path, geneanno, vcf):
    """A VCF of bare numeric names ("1", "2") reads as an int64 column; the
    port prefixes it as it does "chr1" (the JAX package's
    ``standardize_chroms`` raises TypeError there under pandas 3, so this is
    held to the port's own run on the prefixed names)."""
    geneanno.to_csv(tmp_path / "geneanno.csv")
    bare = vcf.copy()
    bare[0] = bare[0].str.replace("chr", "")
    for table, tag in ((vcf, "prefixed"), (bare, "bare")):
        table.to_csv(tmp_path / f"{tag}.vcf", sep="\t", header=False, index=False)
        assert cg_main([str(tmp_path / f"{tag}.vcf"), "--annoFile", str(tmp_path / "geneanno.csv"), "-o",
                        str(tmp_path / tag), "--all_in_receptive_field"]) == 0
    for name in ("closest_genes.tsv", "snps_hg19.vcf", "snps_expanded.vcf"):
        assert (tmp_path / "bare" / name).read_bytes() == (tmp_path / "prefixed" / name).read_bytes(), name
