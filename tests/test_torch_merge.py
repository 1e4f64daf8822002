"""The port's chunk mergers and h5 compressor (expecto_tpu_torch/pipeline/
merge.py, cli/merge.py) vs the JAX package's on the same files, on the CPU:
sed.tsv and FIMO merges byte for byte, the consensus h5 merge and the
float16 + gzip-9 recompression dataset for dataset, the same errors (chunk
counts, record ids, the same-path guard), and both command lines. The h5
cases skip where h5py is not installed."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from expecto_tpu.cli.merge import main as jax_merge_main
from expecto_tpu.pipeline import merge as jmerge
from expecto_tpu_torch.cli.merge import main as merge_main
from expecto_tpu_torch.pipeline import merge as tmerge

# chunk directories out of natural order on disk and in plain sort order
CHUNKS = ["chunk_10", "chunk_2", "chunk_1"]


def _sed_chunks(root, seed=0):
    """sed.tsv chunks as cli.predict writes them (index=False), seeded."""
    rng = np.random.default_rng(seed)
    for i, name in enumerate(CHUNKS):
        d = root / name
        d.mkdir(parents=True)
        n = 2 + i
        pd.DataFrame({"index": np.arange(n), "0": ["chr1"] * n, "1": rng.integers(1, 10**6, n), "gene": [f"G{i}"] * n,
                      "REF": rng.random(n), "ALT": rng.random(n), "SED": rng.normal(size=n)}).to_csv(
            d / "sed.tsv", sep="\t", index=False)


def _fimo_chunks(root, seed=1):
    rng = np.random.default_rng(seed)
    for i, name in enumerate(CHUNKS):
        d = root / name
        d.mkdir(parents=True)
        pd.DataFrame({"motif_id": [f"M{i}"] * 3, "sequence_name": ["s1", "s2", "s3"],
                      "p-value": rng.random(3) * 1e-4, "score": rng.normal(size=3)}).to_csv(
            d / "fimo_results.tsv", sep="\t", index=False)


def _assert_errors_match(fn_port, fn_jax, *args, exc=AssertionError):
    messages = []
    for fn in (fn_port, fn_jax):
        with pytest.raises(exc) as info:
            fn(*args)
        messages.append(str(info.value))
    assert messages[0] == messages[1], messages
    return messages[0]


def test_natsorted_matches_jax():
    items = ["g10", "G2", "g1", "a10b3", "a10b20", "a9", "x"]
    assert tmerge.natsorted(items) == jmerge.natsorted(items) == ["a9", "a10b3", "a10b20", "g1", "G2", "g10", "x"]


@pytest.mark.parametrize("kind", ["sed", "fimo"])
def test_tsv_merges_match_jax_byte_for_byte(tmp_path, kind):
    make, fname, fn = {"sed": (_sed_chunks, "sed.tsv", "merge_sed_batches"),
                       "fimo": (_fimo_chunks, "fimo_results.tsv", "merge_fimo_batches")}[kind]
    make(tmp_path / "batches")
    got = getattr(tmerge, fn)(str(tmp_path / "batches"), str(tmp_path / "port"), 3)
    want = getattr(jmerge, fn)(str(tmp_path / "batches"), str(tmp_path / "jax"), 3)
    pd.testing.assert_frame_equal(got, want)
    assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "jax" / fname).read_bytes()
    parts = [pd.read_csv(tmp_path / "batches" / c / fname, sep="\t") for c in ("chunk_1", "chunk_2", "chunk_10")]
    pd.testing.assert_frame_equal(got.reset_index(drop=True), pd.concat(parts, ignore_index=True))  # natural order
    if kind == "sed":  # the reference's index=True output: a per-chunk RangeIndex as the first column
        merged = pd.read_csv(tmp_path / "port" / fname, sep="\t", index_col=0)
        assert merged.index.tolist() == [0, 1, 2, 3, 0, 1, 2, 0, 1]  # chunk_1, chunk_2, chunk_10
    else:
        assert (tmp_path / "port" / fname).read_text().startswith("motif_id\t")
    msg = _assert_errors_match(getattr(tmerge, fn), getattr(jmerge, fn), str(tmp_path / "batches"),
                               str(tmp_path / "bad"), 4)
    assert "Expected 4 chunks but got 3" in msg


def test_merge_cli_sed_matches_jax(tmp_path):
    _sed_chunks(tmp_path / "b")
    for main, tag in ((merge_main, "port"), (jax_merge_main, "jax")):
        assert main(["sed", "--batch_dir", str(tmp_path / "b"), "--n_chunks", "3", "-o", str(tmp_path / tag)]) == 0
    assert (tmp_path / "port" / "sed.tsv").read_bytes() == (tmp_path / "jax" / "sed.tsv").read_bytes()
    for main, tag in ((merge_main, "fport"), (jax_merge_main, "fjax")):
        _fimo_chunks(tmp_path / f"{tag}_b")
        assert main(["fimo", "--batch_dir", str(tmp_path / f"{tag}_b"), "-o", str(tmp_path / tag)]) == 0
    assert (tmp_path / "fport" / "fimo_results.tsv").read_bytes() == (tmp_path / "fjax" / "fimo_results.tsv").read_bytes()


def test_parse_record_id_matches_jax():
    for rid in ["chr19:100-200|NA20828|-|1pIu", b"chr1:1-2|HG00096|+|2pIu"]:
        assert tmerge.parse_record_id(rid) == jmerge.parse_record_id(rid)
    assert tmerge.parse_record_id(b"chr1:1-2|HG00096|+|2pIu") == "HG00096|2pIu"


# ---- h5 -----------------------------------------------------------------------

def _consensus_tree(root, h5py, *, bad_gene=None):
    """Per-gene h5s under batch dirs (both layouts), each with a
    ``_chromatin.h5`` sibling the merger must skip."""
    rng = np.random.default_rng(5)
    rids = [f"chr1:{i}-{i + 10}|NA{i:05d}|-|{i % 2 + 1}pIu".encode() for i in range(6)]
    for b, genes in (("batch_1", ["ENSG2", "ENSG10"]), ("batch_0", ["ENSG1"])):
        d = root / b
        d.mkdir(parents=True)
        for g in genes:
            ids = list(rids)
            if g == bad_gene:
                ids[3] = b"chr1:3-13|NA99999|-|2pIu"
            with h5py.File(d / f"{g}.h5", "w") as f:
                f.create_dataset("record_ids", data=np.array(ids))
                f.create_dataset("preds" if g == "ENSG10" else "expecto_preds", data=rng.normal(size=6))
            with h5py.File(d / f"{g}_chromatin.h5", "w") as f:
                f.create_dataset("record_ids", data=np.array(ids))


def _h5_contents(path, h5py) -> dict:
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].compression, f[k].compression_opts, f[k][...]) for k in f}


def _assert_h5_equal(a, b, h5py):
    ca, cb = _h5_contents(a, h5py), _h5_contents(b, h5py)
    assert sorted(ca) == sorted(cb)
    for k in ca:
        assert ca[k][:3] == cb[k][:3], k
        np.testing.assert_array_equal(ca[k][3], cb[k][3], err_msg=k)


def test_merge_consensus_batches_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    _consensus_tree(tmp_path / "b", h5py)
    tmerge.merge_consensus_batches(str(tmp_path / "b"), str(tmp_path / "port"), 3)
    jmerge.merge_consensus_batches(str(tmp_path / "b"), str(tmp_path / "jax"), 3)
    _assert_h5_equal(tmp_path / "port" / "expecto_preds.h5", tmp_path / "jax" / "expecto_preds.h5", h5py)
    with h5py.File(tmp_path / "port" / "expecto_preds.h5", "r") as f:
        assert [g.decode() for g in f["genes"]] == ["ENSG1", "ENSG2", "ENSG10"]
        assert f["preds"].shape == (3, 6) and f["record_ids"][0] == b"NA00000|1pIu"
    msg = _assert_errors_match(tmerge.merge_consensus_batches, jmerge.merge_consensus_batches, str(tmp_path / "b"),
                               str(tmp_path / "bad"), 4)
    assert "Expected 4 genes but got 3 h5 files" in msg


def test_merge_consensus_record_id_mismatch_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    _consensus_tree(tmp_path / "b", h5py, bad_gene="ENSG10")
    msg = _assert_errors_match(tmerge.merge_consensus_batches, jmerge.merge_consensus_batches, str(tmp_path / "b"),
                               str(tmp_path / "out"))
    assert msg.startswith("record id mismatch in") and msg.endswith("ENSG10.h5")


def _preds_tree(root, h5py):
    rng = np.random.default_rng(9)
    for center, name in (("center_2", "g.h5"), ("center_10", "g2.h5"), ("center_1", "g3.h5")):
        (root / center).mkdir(parents=True)
        with h5py.File(root / center / name, "w") as f:
            f.create_dataset("preds", data=rng.normal(size=(4, 5)).astype(np.float32))
            f.create_dataset("alt_preds", data=rng.normal(size=(3,)))
            f.create_dataset("record_ids", data=np.array([b"a|b|c|d"] * 4))
            f.create_dataset("seqs", data=np.array([b"ACGT"] * 3))


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunk_1_of_2"])
def test_compress_h5_tree_matches_jax(tmp_path, chunked):
    h5py = pytest.importorskip("h5py")
    for tag in ("port", "jax"):
        _preds_tree(tmp_path / f"{tag}_in", h5py)
    keep = shutil.copytree(tmp_path / "port_in", tmp_path / "originals")
    kw = {"num_chunks": 2, "chunk_i": 1} if chunked else {}
    got = tmerge.compress_h5_tree(str(tmp_path / "port_in"), str(tmp_path / "port"), **kw)
    want = jmerge.compress_h5_tree(str(tmp_path / "jax_in"), str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(got) == (1 if chunked else 3)
    for p in got:
        rel = os.path.relpath(p, tmp_path / "port")
        _assert_h5_equal(p, tmp_path / "jax" / rel, h5py)
        assert not (tmp_path / "port_in" / rel).exists()  # the original is deleted
        c = _h5_contents(p, h5py)
        assert c["preds"][:3] == (np.float16, "gzip", 9) and c["record_ids"][1] is None
        np.testing.assert_array_equal(c["preds"][3], _h5_contents(keep / rel, h5py)["preds"][3].astype(np.float16))


def test_compress_guards_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    _preds_tree(tmp_path / "in", h5py)
    msg = _assert_errors_match(tmerge.compress_h5_tree, jmerge.compress_h5_tree, str(tmp_path / "in"),
                               str(tmp_path / "in"), exc=ValueError)
    assert msg.startswith("compress out_dir would overwrite its own input in place")
    for kw in ({"num_chunks": 2}, {"chunk_i": 0}):
        messages = []
        for mod in (tmerge, jmerge):
            with pytest.raises(ValueError) as info:
                mod.compress_h5_tree(str(tmp_path / "in"), str(tmp_path / "out"), **kw)
            messages.append(str(info.value))
        assert messages[0] == messages[1] == "num_chunks and chunk_i must be passed together"
    assert len(list((tmp_path / "in").rglob("*.h5"))) == 3  # nothing deleted by a refused call


def test_merge_cli_h5_subcommands_match_jax(tmp_path):
    """``consensus`` and ``compress`` (through the reference's
    ``--basenji_consensus_preds_dir`` alias, ``--keep_original``) on both
    command lines."""
    h5py = pytest.importorskip("h5py")
    _consensus_tree(tmp_path / "b", h5py)
    for main, tag in ((merge_main, "port"), (jax_merge_main, "jax")):
        assert main(["consensus", "--batch_dir", str(tmp_path / "b"), "--n_genes", "3", "-o", str(tmp_path / tag)]) == 0
    _assert_h5_equal(tmp_path / "port" / "expecto_preds.h5", tmp_path / "jax" / "expecto_preds.h5", h5py)
    _preds_tree(tmp_path / "p", h5py)
    for main, tag in ((merge_main, "zport"), (jax_merge_main, "zjax")):
        assert main(["compress", "--basenji_consensus_preds_dir", str(tmp_path / "p"), "--keep_original",
                     "--out_dir", str(tmp_path / tag)]) == 0
    for p in (tmp_path / "zport").rglob("*.h5"):
        _assert_h5_equal(p, tmp_path / "zjax" / p.relative_to(tmp_path / "zport"), h5py)
    assert len(list((tmp_path / "p").rglob("*.h5"))) == 3 and len(list((tmp_path / "zport").rglob("*.h5"))) == 3
