"""Per-SNP/TSS bin extraction from consensus prediction h5s (port of
expecto_tpu/analysis/extract.py; reference
extract_lymphoblastoid_consensus_preds.py:16-250): maps genomic positions to
ExPecto shift-window bins or Basenji 128-bp output bins. h5py and tqdm are
imported inside the functions that use them."""

from __future__ import annotations

import numpy as np

from ..genome.windows import gene_shifts


def get_snp_bin(snp_pos: int, tss_pos: int, strand: str, model: str = "expecto") -> int:
    """Bin index containing a SNP (extract_lymphoblastoid_consensus_preds.py
    :183-247).

    - 'expecto': first shift window whose [start, end) contains the SNP's
      TSS-relative position (2,000-bp windows at 200 shifts).
    - 'basenji': 128-bp bins over a 131,072-bp window with 896-bin center
      crop arithmetic.
    """
    if model == "expecto":
        windowsize = 2000
        s = {"+": 1, "-": -1}[strand]
        snp_rel_pos = snp_pos - tss_pos
        for i, shift in enumerate(gene_shifts()):
            bin_start = (shift * s) - int(windowsize / 2 - 1)
            bin_end = (shift * s) + int(windowsize / 2) + 1
            if bin_start <= snp_rel_pos < bin_end:
                return i
        raise AssertionError(f"SNP position {snp_pos} not found in any bin")

    if model == "basenji":
        seq_len, bin_resolution, num_bins, cropped_bins = 131072, 128, 1024, 896
        tss_index = seq_len // 2 - 1 if strand == "+" else seq_len // 2
        snp_index = tss_index + (snp_pos - tss_pos)
        if snp_index < 0 or snp_index >= seq_len:
            raise AssertionError(f"SNP index {snp_index} is out of the input sequence")
        snp_bin = snp_index // bin_resolution
        snp_bin_cropped = snp_bin - (num_bins - cropped_bins) // 2
        if snp_bin_cropped < 0 or snp_bin_cropped >= cropped_bins:
            raise AssertionError(f"SNP bin index {snp_bin_cropped} is out of the cropped output")
        return int(snp_bin_cropped)

    raise AssertionError(f"model {model} not recognized")


def extract_bins(chromatin_preds: np.ndarray, center_bin: int, flank: int = 50) -> np.ndarray:
    """Slice +-flank bins around a center bin, clipped to the array
    (extract path of extract_lymphoblastoid_consensus_preds.py)."""
    lo = max(center_bin - flank, 0)
    hi = min(center_bin + flank + 1, chromatin_preds.shape[-2])
    return chromatin_preds[..., lo:hi, :]


def _load_gene_tables(eqtls_csv: str, genes_csv: str, subset_genes_txt: str | None):
    """eqtls (indexed by lowercase gene name) + genes table with strand
    (extract_lymphoblastoid_consensus_preds.py:46-63)."""
    import pandas as pd

    eqtls_df = pd.read_csv(eqtls_csv, index_col=0)
    # lowercase to match the gene index and the lowercase per-gene h5 dirs
    eqtls_df = eqtls_df.set_index(eqtls_df["name"].str.lower())
    genes_df = pd.read_csv(genes_csv, names=["ens_id", "chrom", "bp", "gene_symbol", "strand"], index_col=False)
    genes_df["name"] = genes_df["gene_symbol"].fillna(genes_df["ens_id"]).str.lower()
    genes_df = genes_df.set_index("name")
    if subset_genes_txt is not None:
        subset_df = pd.read_csv(subset_genes_txt)
        subset_df["name"] = subset_df["name"].fillna(subset_df["geneID"]).str.lower()
        genes_df = genes_df[genes_df.index.isin(set(subset_df["name"]))]
    return eqtls_df, genes_df


def _extract_expecto_gene(row, *, extract_mode, out_dir, expecto_preds_dir, track_idx, track_ids):
    """One gene (or gene-SNP pair) of the ExPecto extraction branch
    (extract_lymphoblastoid_consensus_preds.py:80-117)."""
    import os

    import h5py
    import pandas as pd

    gene = row.name
    if extract_mode == "snp":
        preds_out_dir = f"{out_dir}/{gene}_{row['SNP_ID']}"
    else:
        preds_out_dir = f"{out_dir}/{gene}"
    os.makedirs(preds_out_dir, exist_ok=True)

    with h5py.File(f"{expecto_preds_dir}/{gene}/{gene}_chromatin.h5", "r") as gene_h5:
        preds = gene_h5["chromatin_preds"]
        sample_names = [x.decode("utf-8").split("|")[1] for x in gene_h5["record_ids"]]
        if extract_mode == "snp":
            target_bin = get_snp_bin(row["SNPpos"], row["TSSpos_x"], row["strand"], model="expecto")
        else:  # tss / 50_bins center on the TSS bin
            target_bin = get_snp_bin(row["bp"], row["bp"], row["strand"], model="expecto")
        if extract_mode != "50_bins":
            sel = preds[:, target_bin, :][:, track_idx]
            pd.DataFrame(sel, index=sample_names, columns=track_ids).to_csv(
                f"{preds_out_dir}/expecto_preds.csv"
            )
        else:
            sel = preds[:, max(target_bin - 50, 0) : target_bin + 51, :][:, :, track_idx].astype(np.float16)
            with h5py.File(f"{preds_out_dir}/expecto_gm12878_preds.h5", "w") as h5f:
                h5f.create_dataset("all_preds", data=sel, compression="gzip", compression_opts=9)
                h5f.create_dataset("sample_names", data=np.array(sample_names, dtype="S"))
                h5f.create_dataset("features", data=np.array(track_ids, dtype=h5py.special_dtype(vlen=str)))
    return preds_out_dir


def _extract_basenji_gene(row, *, extract_mode, out_dir, basenji_preds_dir, track_idx, track_ids):
    """One gene of the Basenji extraction branch
    (extract_lymphoblastoid_consensus_preds.py:119-181): per-sample h5s in
    {gene}/all_bins_per_sample/*.h5 with an 'all_preds' (n_bins, n_tracks)
    dataset."""
    import glob
    import os
    from pathlib import Path

    import h5py
    import pandas as pd

    gene = row.name
    if extract_mode == "snp":
        preds_out_dir = f"{out_dir}/{gene}_{row['SNP_ID']}"
    else:
        preds_out_dir = f"{out_dir}/{gene}"
        if extract_mode == "tss" and os.path.exists(f"{preds_out_dir}/basenji_preds.csv"):
            return preds_out_dir
    os.makedirs(preds_out_dir, exist_ok=True)

    sample_files = sorted(glob.glob(f"{basenji_preds_dir}/{gene}/all_bins_per_sample/*.h5"))
    if not sample_files:
        raise FileNotFoundError(
            f"no per-sample basenji h5 files for gene '{gene}' under "
            f"{basenji_preds_dir}/{gene}/all_bins_per_sample/"
        )
    sample_names = [Path(x).stem for x in sample_files]
    if extract_mode == "snp":
        target_bin = get_snp_bin(row["SNPpos"], row["TSSpos_x"], row["strand"], model="basenji")
    else:
        target_bin = get_snp_bin(row["bp"], row["bp"], row["strand"], model="basenji")

    if extract_mode != "50_bins":
        out_df = pd.DataFrame(index=sample_names, columns=track_ids)
        for sample_file in sample_files:
            with h5py.File(sample_file, "r") as gene_h5:
                out_df.loc[Path(sample_file).stem, :] = gene_h5["all_preds"][target_bin, :][track_idx]
        out_df.to_csv(f"{preds_out_dir}/basenji_preds.csv")
    else:
        lo = max(target_bin - 50, 0)
        hi = target_bin + 51  # clipped to the dataset length below
        all_preds = None
        for i, sample_file in enumerate(sample_files):
            with h5py.File(sample_file, "r") as gene_h5:
                hi_c = min(hi, gene_h5["all_preds"].shape[0])
                if all_preds is None:
                    all_preds = np.empty((len(sample_files), hi_c - lo, len(track_idx)), dtype=np.float16)
                all_preds[i] = gene_h5["all_preds"][lo:hi_c, :][:, track_idx]
        with h5py.File(f"{preds_out_dir}/basenji_gm12878_preds.h5", "w") as f:
            f.create_dataset("all_preds", data=all_preds, compression="gzip", compression_opts=9)
            f.create_dataset("sample_names", data=np.array(sample_names, dtype="S"))
            f.create_dataset("features", data=np.array(track_idx))
    return preds_out_dir


def extract_consensus_dataset(
    *,
    model: str,
    extract_mode: str,
    out_dir: str,
    eqtls_csv: str,
    genes_csv: str,
    subset_genes_txt: str | None = None,
    expecto_preds_dir: str | None = None,
    beluga_features_tsv: str | None = None,
    basenji_preds_dir: str | None = None,
    targets_file: str | None = None,
    cell_type: str = "GM12878",
    progress: bool = False,
    processes: int | None = None,
) -> list[str]:
    """Directory-level extraction loop (reference
    extract_lymphoblastoid_consensus_preds.py:16-117): selects the
    ``cell_type`` tracks of the chosen model, iterates eQTLs ('snp' mode) or
    genes ('tss'/'50_bins'), and writes per-gene(-SNP) prediction tables.

    ``processes`` > 1 fans the basenji branch out over a multiprocessing
    pool (the reference uses mp.Pool for it,
    extract_lymphoblastoid_consensus_preds.py:68-73); the expecto branch
    reads one h5 per gene and stays sequential.
    """
    import os

    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    eqtls_df, genes_df = _load_gene_tables(eqtls_csv, genes_csv, subset_genes_txt)

    if model == "expecto":
        features_df = pd.read_csv(beluga_features_tsv, sep="\t", index_col=0).reset_index(drop=True)
        features_df["ID"] = (
            features_df.index.astype(str) + "|" + features_df["Cell type"] + "|"
            + features_df["Assay"] + "|" + features_df["Source"]
        )
        sel = features_df[features_df["Cell type"].str.contains(cell_type, na=False)]
        worker = _extract_expecto_gene
        kw = dict(expecto_preds_dir=expecto_preds_dir)
    elif model == "basenji":
        features_df = pd.read_csv(targets_file, sep="\t", index_col=0).reset_index(drop=True)
        features_df["ID"] = (
            features_df.index.astype(str) + "|" + features_df["description"] + "|" + features_df["identifier"]
        )
        sel = features_df[features_df["description"].str.contains(cell_type, na=False)]
        worker = _extract_basenji_gene
        kw = dict(basenji_preds_dir=basenji_preds_dir)
    else:
        raise AssertionError(f"model {model} not recognized")

    if extract_mode == "snp":
        # index.map tolerates duplicate gene symbols in the annotation
        # (patch/alt contigs) where a merge-then-assign would fail to reindex
        strand_by_gene = genes_df.loc[~genes_df.index.duplicated(), "strand"]
        eqtls_df["strand"] = eqtls_df.index.map(strand_by_gene)
        if not set(eqtls_df["strand"]).issubset({"+", "-"}):
            raise AssertionError("Strand not found for all eqtls")
        rows_df = eqtls_df
    else:
        rows_df = genes_df

    import functools

    bound = functools.partial(
        worker, extract_mode=extract_mode, out_dir=out_dir,
        track_idx=np.array(sel.index), track_ids=list(sel["ID"]), **kw,
    )
    rows = [row for _, row in rows_df.iterrows()]
    if processes and processes > 1 and model == "basenji":
        import multiprocessing as mp

        # spawn: the parent may hold torch's threads, where fork can deadlock
        with mp.get_context("spawn").Pool(processes) as pool:
            it = pool.imap_unordered(bound, rows)
            if progress:
                from tqdm import tqdm

                it = tqdm(it, total=len(rows))
            return list(it)
    iterator = rows
    if progress:
        from tqdm import tqdm

        iterator = tqdm(rows)
    return [bound(row) for row in iterator]


def extract_consensus_track_bins(
    chromatin_h5_path: str,
    snp_pos: int,
    tss_pos: int,
    strand: str,
    track_indices,
    *,
    out_h5_path: str | None = None,
    flank: int = 50,
    model: str = "expecto",
):
    """Extract selected tracks at the SNP bin, TSS bin, and +-flank bins from
    a per-gene consensus chromatin h5 (the ExPecto branch of reference
    extract_lymphoblastoid_consensus_preds.py:16-180).

    Input h5: ``chromatin_preds`` (n_samples, n_bins, n_tracks) +
    ``record_ids`` as written by predict_consensus_genes. Returns a dict and
    optionally writes it as an h5.
    """
    import h5py

    track_indices = np.asarray(track_indices)
    with h5py.File(chromatin_h5_path, "r") as f:
        preds = np.asarray(f["chromatin_preds"])
        record_ids = np.asarray(f["record_ids"])

    snp_bin = get_snp_bin(snp_pos, tss_pos, strand, model)
    tss_bin = get_snp_bin(tss_pos, tss_pos, strand, model)
    out = {
        "snp_bin": snp_bin,
        "tss_bin": tss_bin,
        "snp_bin_preds": preds[:, snp_bin][:, track_indices],
        "tss_bin_preds": preds[:, tss_bin][:, track_indices],
        "flank_preds": extract_bins(preds, snp_bin, flank)[..., track_indices],
        "record_ids": record_ids,
    }
    if out_h5_path is not None:
        with h5py.File(out_h5_path, "w") as f:
            for k, v in out.items():
                if k in ("snp_bin", "tss_bin"):
                    f.attrs[k] = v
                else:
                    f.create_dataset(k, data=v)
    return out
