"""The port's chain-file liftover (genome/liftover.py) and the chromatin
CLI's ``--hg38`` against the JAX package on the CPU: point conversions on
both chain strands, gaps, unmapped contigs, a gzipped chain, liftover_vcf
with its multi-mapping warning and ``strict=True`` abort, and
``cli.chromatin --hg38 --chain_file`` end to end (lifted h5s at fp32 1e-5,
``not_lifted.vcf`` and ``snps_hg19.vcf`` byte for byte)."""

import gzip

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.genome import liftover as jlift
from expecto_tpu.io import h5 as jh5
from expecto_tpu.models.convert import save_params_npz as jax_save_params_npz
from expecto_tpu_torch.genome import liftover as tlift
from expecto_tpu_torch.io import h5 as th5
from torch_port_common import single_torch_thread, narrow_params  # noqa: F401 (autouse fixture)

# one chain tPos 100-210 -> chrB qPos 1000-1120 (+) with a gap of 10 on t
# and 20 on q after 50 bases; a second on the minus strand: t 300-340 ->
# chr3 reversed
CHAIN = ("chain 1000 chrA 500 + 100 210 chrB 2000 + 1000 1120 1\n50\t10\t20\n50\n\n"
         "chain 900 chrA 500 + 300 340 chr3 400 - 60 100 2\n40\n\n")
# two chains both covering tPos 100-150 (a main and an alt mapping)
OVERLAPPING = ("chain 1000 chrA 500 + 100 150 chrB 2000 + 1000 1050 1\n50\n\n"
               "chain 400 chrA 500 + 100 150 chrB_alt 900 + 200 250 2\n50\n\n")


@pytest.fixture(params=["plain", "gz"])
def chain_file(tmp_path, request):
    if request.param == "gz":
        p = tmp_path / "t.chain.gz"
        with gzip.open(p, "wt") as f:
            f.write(CHAIN)
    else:
        p = tmp_path / "t.chain"
        p.write_text(CHAIN)
    return p


@pytest.fixture()
def overlapping_chain_file(tmp_path):
    p = tmp_path / "multi.chain"
    p.write_text(OVERLAPPING)
    return p


@pytest.mark.parametrize("chrom,pos,want", [
    ("chrA", 101, [("chrB", 1001, "+")]), ("chrA", 150, [("chrB", 1050, "+")]),
    ("chrA", 155, []),  # inside the gap
    ("chrA", 161, [("chrB", 1071, "+")]), ("chrA", 210, [("chrB", 1120, "+")]), ("chrA", 211, []),
    ("chrA", 301, [("chr3", 340, "-")]), ("chrA", 340, [("chr3", 301, "-")]),
    ("A", 101, [("chrB", 1001, "+")]),  # a contig without the chr prefix
    ("chrZ", 100, []),
])
def test_convert_coordinate_matches_jax(chain_file, chrom, pos, want):
    got = tlift.ChainLiftover(chain_file).convert_coordinate(chrom, pos)
    assert got == jlift.ChainLiftover(chain_file).convert_coordinate(chrom, pos) == want


def test_liftover_vcf_matches_jax(chain_file):
    vcf = pd.DataFrame([["chrA", 101, ".", "A", "T"], ["chrA", 155, ".", "G", "C"], ["chrA", 330, ".", "C", "G"],
                        ["chrQ", 5, ".", "T", "A"]])
    got, got_failed = tlift.liftover_vcf(vcf, tlift.ChainLiftover(chain_file))
    want, want_failed = jlift.liftover_vcf(vcf, jlift.ChainLiftover(chain_file))
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_series_equal(got_failed, want_failed)
    assert list(got_failed) == [False, True, False, True]
    assert got.iloc[1, 0] == tlift.FAILED_LIFTOVER_VALUE == jlift.FAILED_LIFTOVER_VALUE


def test_multi_mapping_default_takes_the_top_chain(overlapping_chain_file):
    vcf = pd.DataFrame([["chrA", 101, ".", "A", "T"], ["chrA", 120, ".", "A", "T"]])
    with pytest.warns(UserWarning, match="multiple liftover mappings") as record:
        lifted, failed = tlift.liftover_vcf(vcf, tlift.ChainLiftover(overlapping_chain_file))
    assert len(record) == 1  # one warning for the whole table
    assert not failed.any()
    assert list(lifted.iloc[:, 0]) == ["chrB", "chrB"] and list(lifted.iloc[:, 1]) == [1001, 1020]
    with pytest.warns(UserWarning):
        want, _ = jlift.liftover_vcf(vcf, jlift.ChainLiftover(overlapping_chain_file))
    pd.testing.assert_frame_equal(lifted, want)


def test_multi_mapping_strict_reproduces_the_reference_abort(overlapping_chain_file):
    vcf = pd.DataFrame([["chrA", 101, ".", "A", "T"]])
    with pytest.raises(AssertionError, match="chrA:101.*2 mappings"):
        tlift.liftover_vcf(vcf, tlift.ChainLiftover(overlapping_chain_file), strict=True)


def test_chromatin_cli_hg38_matches_jax(tmp_path, tiny_genome):
    """hg38 rows lifted through a chain that maps hg38 chr1 onto chr1 500 bp
    on: two substitutions and an insertion lift, a row before the chain and
    a row on an unchained contig do not (``not_lifted.vcf``); both CLIs
    write the same files, the lifted h5s within fp32 1e-5."""
    from expecto_tpu.cli.chromatin import main as jax_chromatin
    from expecto_tpu_torch.cli.chromatin import main as torch_chromatin

    fa, contigs = tiny_genome
    seq = contigs["chr1"]
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rows = [["chr1", p - 500, ".", seq[p - 1], comp[seq[p - 1]]] for p in (7000, 11000)]
    rows += [["chr1", 14500, ".", seq[14999], seq[14999] + "AC"], ["chr1", 400, ".", "A", "C"],
             ["chr2", 9000, ".", "G", "T"]]
    pd.DataFrame(rows).to_csv(tmp_path / "hg38.vcf", sep="\t", header=False, index=False)
    (tmp_path / "hg38.chain").write_text("chain 1000 chr1 70000 + 1000 51000 chr1 60000 + 1500 51500 1\n50000\n\n")
    jax_save_params_npz(narrow_params(seed=23), tmp_path / "beluga.npz")
    common = [str(tmp_path / "hg38.vcf"), "--hg38", "--chain_file", str(tmp_path / "hg38.chain"), "--genome",
              str(fa.path), "--beluga_weights", str(tmp_path / "beluga.npz"), "--maxshift", "400", "--batchsize", "32"]
    out = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    assert torch_chromatin(common + ["--output_dir", str(out["port"]), "--device", "cpu"]) == 0
    assert jax_chromatin(common + ["--output_dir", str(out["jax"])]) == 0
    names = sorted(p.name for p in out["port"].iterdir())
    assert names == sorted(p.name for p in out["jax"].iterdir())
    for name in ("snps_hg19.vcf", "not_lifted.vcf"):
        assert (out["port"] / name).read_text() == (out["jax"] / name).read_text()
    assert len((out["port"] / "not_lifted.vcf").read_text().splitlines()) == 2
    lifted = [line.split("\t")[1] for line in (out["port"] / "snps_hg19.vcf").read_text().splitlines()[2:]]
    assert lifted == ["7000", "11000", "15000"]
    h5s = [n for n in names if n.endswith(".diff.h5")]
    assert len(h5s) == 5  # one per shift at maxshift 400
    for name in h5s:
        got, want = th5.read_shift_h5(out["port"] / name), jh5.read_shift_h5(out["jax"] / name)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape == (6, 2002)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=f"{name} {k}")
