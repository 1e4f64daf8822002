#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s analysis phase on the CPU, without a card.

    python3 scripts/rehearse_analysis_phase.py [--work DIR] [--seed N]

The analysis phase reads the earlier phases' outputs, which only a card run
makes. This script writes stand-ins of the same shapes under ``--work``
(default ``build/rehearse_analysis``): the seeded 2 x 300 kb genome with N
runs, 1,024 substitutions and 128 insertions with their gene rows, 24,338
training genes, 128 bootstrap ``.save`` files of 20,020 weights, and the
entry phase's two cluster tables from the port's ``score_sed_with_clusters``
on random effects. Then it runs ``chip_smoke.analysis_phase`` over them with
every check, and prints the phase's report. Times it prints are of this
host's CPU, not of any device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd

REPO = Path(__file__).resolve().parents[1]


def fabricate(cs, seed: int):
    """The earlier phases' outputs that the analysis phase reads, under
    ``cs.WORK``; returns the main model."""
    from expecto_tpu_torch.genome.fasta import write_fasta
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.genome.windows import variant_shifts
    from expecto_tpu_torch.io.tables import load_closest_genes
    from expecto_tpu_torch.io.xgb import save_expression_model
    from expecto_tpu_torch.models.gblinear import GBLinearModel
    from expecto_tpu_torch.pipeline.sed import score_sed_with_clusters

    w = cs.WORK
    (w / "train" / "boot").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contigs = {}
    for name in ("chr1", "chr2"):
        seq = bases[rng.integers(0, 4, cs.CONTIG_LEN)]
        for start in rng.integers(2000, cs.CONTIG_LEN - 2000, 6):
            seq[start : start + int(rng.integers(20, 400))] = ord("N")
        contigs[name] = seq.tobytes().decode()
    write_fasta(w / "genome.fa", contigs)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    vcf, genes = [], []
    for i, site in enumerate(rng.choice(2 * (cs.CONTIG_LEN - 6000), cs.N_SUBS + cs.N_INDELS, replace=False)):
        chrom = ("chr1", "chr2")[int(site) % 2]
        pos = 3000 + int(site) // 2
        ref = contigs[chrom][pos - 1]
        alt = comp.get(ref, "A") if i < cs.N_SUBS else ref + "AC"
        vcf.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}")
        for g in range(int(rng.integers(1, 4))):
            tss = pos + int(rng.integers(-20000, 20000))
            genes.append(f"{chrom[3:]}\t{pos - 1}\t{pos}\t{ref}\t{alt}\t{chrom[3:]}\t{tss - 1}\t{tss}\t{'+-'[g % 2]}"
                         f"\tENSG{pos:08d}{g}\t{tss - pos}")
    (w / "variants.vcf").write_text("\n".join(vcf) + "\n")
    (w / "genes.tsv").write_text("\n".join(genes) + "\n")

    n = cs.TRAIN_GENES
    pd.DataFrame({"id": [f"ENSG{i:011d}" for i in range(n)], "symbol": [f"G{i}" for i in range(n)],
                  "seqnames": "chr1", "strand": "+", "TSS": 1, "CAGE_representative_TSS": 1,
                  "type": "protein_coding"}).to_csv(w / "train" / "geneanno.csv", index=False)
    true_w = (rng.normal(size=cs.TRAIN_FEATURES) * 0.01).astype(np.float32)
    for j in range(cs.TRAIN_BOOT_SEEDS):
        m = GBLinearModel(weight=(true_w + rng.normal(scale=0.003, size=true_w.size)).astype(np.float32), bias=0.1)
        save_expression_model(m, w / "train" / "boot" / f"bootstrap_seed{j}.save")
        save_expression_model(m, w / "train" / "boot" / f"bootstrap_seed{j}.dump")

    vcf_df = standardize_chroms(read_vcf(w / "variants.vcf"))
    gene = load_closest_genes(w / "genes.tsv")
    ref = rng.random((len(variant_shifts(cs.MAXSHIFT)), len(vcf_df), 2002)).astype(np.float32)
    alt = np.clip(ref + rng.normal(0, 0.05, ref.shape), 0, 1).astype(np.float32)
    eff = {"ref": ref, "alt": alt, "diff": alt - ref}
    model = GBLinearModel(weight=(rng.standard_normal(cs.TRAIN_FEATURES) * 0.02).astype(np.float32), bias=0.1)
    labels = rng.permutation(np.arange(2002) % cs.ENTRY_CLUSTERS)
    membership = (rng.random((2002, cs.ENTRY_CLUSTERS)) < cs.ENTRY_RSAT_P).astype(np.float64)
    score_sed_with_clusters(eff, vcf_df, gene, model, labels, maxshift=cs.MAXSHIFT,
                            out_dir=w / "entry" / "clusters_labels")
    score_sed_with_clusters(eff, vcf_df, gene, model, [f"rsat_{j}" for j in range(cs.ENTRY_CLUSTERS)],
                            maxshift=cs.MAXSHIFT, out_dir=w / "entry" / "clusters_rsat", membership=membership)
    return GBLinearModel(weight=true_w, bias=0.1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", default=str(REPO / "build" / "rehearse_analysis"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    cs.WORK = Path(args.work)
    t0 = time.perf_counter()
    main_model = fabricate(cs, args.seed)
    print(f"stand-in inputs in {time.perf_counter() - t0:.1f} s (host CPU)", flush=True)
    report = {}
    t0 = time.perf_counter()
    cs.analysis_phase(report, "host CPU, no card", args.seed, main_model)
    print(f"analysis phase {time.perf_counter() - t0:.1f} s (host CPU)")
    print(json.dumps({k: v for k, v in report["analysis"].items() if k not in ("on_card", "cpu_only")},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
