"""Chunk-merge and compression utilities (port of
expecto_tpu/pipeline/merge.py; reference merge_predict_batched.py,
merge_geuvadis_predict_consensus.py, merge_query_fimo_for_predictions.py,
compress_consensus.py).

Cluster-array runs chunk their work across jobs and write per-chunk files;
these mergers combine them deterministically (natural-sort order and count
checks, merge_predict_batched.py:23). ``natsorted`` also orders consensus
samples and genes. Host code only: h5py is imported inside the functions
that read or write h5 files.
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path

import numpy as np
import pandas as pd


def natsorted(items):
    """Natural sort (replacement for the natsort dependency)."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def merge_sed_batches(batch_dir: str, out_dir: str, n_chunks: int | None = None) -> pd.DataFrame:
    """Concatenate chunked sed.tsv outputs (merge_predict_batched.py:10-30)."""
    os.makedirs(out_dir, exist_ok=True)
    sed_files = natsorted(glob.glob(f"{batch_dir}/*/sed.tsv"))
    if n_chunks is not None and len(sed_files) != n_chunks:
        raise AssertionError(f"Expected {n_chunks} chunks but got {len(sed_files)} sed files")
    sed_df = pd.concat([pd.read_csv(f, sep="\t") for f in sed_files])
    # index=True (a repeating per-chunk RangeIndex as the first column) is
    # what the reference merger writes (merge_predict_batched.py:27), though
    # the per-chunk sed.tsv files are written index=False
    sed_df.to_csv(f"{out_dir}/sed.tsv", sep="\t")
    return sed_df


def parse_record_id(x) -> str:
    """'chr19:...|NA20828|-|1pIu' -> 'NA20828|1pIu'
    (merge_geuvadis_predict_consensus.py:45-51)."""
    x = x.decode("utf-8") if isinstance(x, bytes) else str(x)
    parts = x.split("|")
    return f"{parts[1]}|{parts[3]}"


def merge_consensus_batches(batch_dir: str, out_dir: str, n_genes: int | None = None) -> None:
    """Stack per-gene consensus h5s with record-id consistency checks
    (merge_geuvadis_predict_consensus.py:12-44)."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    # the per-gene *_chromatin.h5 siblings that the consensus pipeline writes
    # next to {gene}.h5 are not genes (the reference's bare */*.h5 glob
    # predates them)
    h5_files = natsorted(p for p in glob.glob(f"{batch_dir}/*/*.h5") if not p.endswith("_chromatin.h5"))
    if n_genes is not None and len(h5_files) != n_genes:
        raise AssertionError(f"Expected {n_genes} genes but got {len(h5_files)} h5 files")
    record_ids = None
    preds = []
    for h5_file in h5_files:
        with h5py.File(h5_file, "r") as f:
            curr = np.array([parse_record_id(x) for x in f["record_ids"]])
            if record_ids is None:
                record_ids = curr
            elif not (record_ids == curr).all():
                raise AssertionError(f"record id mismatch in {h5_file}")
            # 'preds' = top-eqtl layout; 'expecto_preds' = main consensus layout
            name = "preds" if "preds" in f else "expecto_preds"
            preds.append(np.array(f[name]))
    genes = [Path(x).stem for x in h5_files]
    with h5py.File(f"{out_dir}/expecto_preds.h5", "w") as f:
        f.create_dataset("record_ids", data=np.array(record_ids, "S"))
        f.create_dataset("genes", data=np.array(genes, "S"))
        f.create_dataset("preds", data=np.stack(preds))


def compress_h5_tree(
    preds_dir: str,
    out_dir: str,
    *,
    num_chunks: int | None = None,
    chunk_i: int | None = None,
    delete_original: bool = True,
) -> list[str]:
    """float16 + gzip-9 recompression of consensus prediction h5s
    (compress_consensus.py:12-69). Returns the output paths.

    Dataset-generic: every float dataset is rewritten float16 + gzip-9 and
    every other dataset is copied as it is, so nothing is dropped before the
    original is deleted (the reference hard-codes the names of the basenji
    tree it targets; this package's consensus trees carry others)."""
    import h5py

    if (num_chunks is None) != (chunk_i is None):
        raise ValueError("num_chunks and chunk_i must be passed together")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    center_files = natsorted(glob.glob(f"{preds_dir}/*/*.h5"))
    if num_chunks is not None:
        center_files = list(np.array_split(np.array(center_files, dtype=object), num_chunks)[chunk_i])
    for path in center_files:
        sub = f"{out_dir}/{Path(path).parent.name}"
        os.makedirs(sub, exist_ok=True)
        out_file = f"{sub}/{Path(path).name}"
        if os.path.abspath(out_file) == os.path.abspath(path):
            raise ValueError(f"compress out_dir would overwrite its own input in place: {path}")
        with h5py.File(path, "r") as f, h5py.File(out_file, "w") as fo:
            for name in f:
                data = f[name][...]
                if np.issubdtype(data.dtype, np.floating):
                    fo.create_dataset(name, data=data.astype(np.float16), compression="gzip", compression_opts=9)
                else:
                    fo.create_dataset(name, data=data)
        if delete_original:
            os.remove(path)
        written.append(out_file)
    return written


def merge_fimo_batches(batch_dir: str, out_dir: str, n_chunks: int | None = None) -> pd.DataFrame:
    """Concatenate chunked FIMO query outputs
    (merge_query_fimo_for_predictions.py:10-29)."""
    os.makedirs(out_dir, exist_ok=True)
    files = natsorted(glob.glob(f"{batch_dir}/*/fimo_results.tsv"))
    if n_chunks is not None and len(files) != n_chunks:
        raise AssertionError(f"Expected {n_chunks} chunks but got {len(files)} fimo files")
    df = pd.concat([pd.read_csv(f, sep="\t") for f in files])
    df.to_csv(f"{out_dir}/fimo_results.tsv", sep="\t", index=False)
    return df
