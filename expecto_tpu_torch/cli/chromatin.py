"""CLI: variant chromatin effects on a CUDA GPU, the first half of the h5
contract (``python -m expecto_tpu_torch.cli.chromatin``; the arguments of
``expecto_tpu.cli.chromatin`` plus ``--device``).

Writes ``snps_hg19.vcf`` (the standardized VCF, the ``--coorFile`` of
``expecto_tpu_torch.cli.predict``), ``not_lifted.vcf`` with ``--hg38`` (the
rows the chain file does not map), ``dropped_contigs.vcf`` when rows on
non-canonical contigs are dropped, and ``{prefix}.shift_{s}.diff.h5`` per
shift (``.legacy.diff.h5`` with ``--legacy_h5`` / ``--legacy_only``).

Default compute is fp32 with TF32 off and an fp32 wire (parity mode);
``--bf16`` runs bf16 compute with an fp16 wire, diff still taken in fp32 on
the device.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict variant chromatin effects")
    p.add_argument("inputfile", type=str, help="Input file in vcf format")
    p.add_argument("--hg38", action="store_true", help="Lift variants from hg38 to hg19 (requires --chain_file)")
    p.add_argument("--chain_file", type=str, default=None, help="UCSC hg38->hg19 over.chain[.gz] for --hg38")
    p.add_argument("--strict_liftover", action="store_true",
                   help="reference-parity liftover: abort when a position has multiple chain "
                        "mappings (chromatin.py:128) instead of taking the top-scoring chain")
    p.add_argument("--chunk_size", type=int, default=int(1e5))
    p.add_argument("--chunk_i", type=int, default=None)
    p.add_argument("--maxshift", type=int, default=800)
    p.add_argument("--inputsize", type=int, default=2000)
    p.add_argument("--batchsize", type=int, default=1024)
    p.add_argument("--output_dir", type=str, default="chromatin_out")
    p.add_argument("--legacy_h5", action="store_true",
                   help="also write original-ExPecto single-'pred' h5s alongside the diff/ref/alt schema")
    p.add_argument("--legacy_only", action="store_true",
                   help="write only the original-ExPecto 'pred' h5s (implies --legacy_h5): pred is the "
                        "diff alone, so only diff leaves the device, half the fetch")
    p.add_argument("--genome", type=str, default="./resources/hg19.fa")
    p.add_argument("--beluga_weights", type=str, default="./resources/deepsea.beluga.npz",
                   help="native npz checkpoint (models/convert.py)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute and an fp16 wire (throughput mode)")
    p.add_argument("--cuda", action="store_true", help="ignored (--device picks the device); kept for CLI parity")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; raises if no GPU is present)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.hg38 and not args.chain_file:
        print("--hg38 requires --chain_file (no network access for chain download)", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from ..genome.fasta import FastaIndex
    from ..genome.vcf import read_vcf, standardize_chroms, write_vcf_hg19
    from ..models.convert import load_params_npz
    from ..parallel.runner import BelugaRunner
    from ..pipeline.chromatin import compute_variant_chromatin_effects

    runner = BelugaRunner(
        load_params_npz(args.beluga_weights),
        batch_size=args.batchsize,
        device=args.device,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        # the fp16 wire is safe for the h5 contract: diff = alt - ref is
        # taken in fp32 on the device before the cast, and the per-window
        # fallback rows force an fp32 wire
        out_dtype=np.float16 if args.bf16 else np.float32,
    )
    genome = FastaIndex(args.genome)
    os.makedirs(args.output_dir, exist_ok=True)
    vcf = read_vcf(args.inputfile, chunk_size=args.chunk_size, chunk_i=args.chunk_i)

    if args.hg38:
        from ..genome.liftover import ChainLiftover, liftover_vcf

        print("Lifting over to hg19...")
        lifted, failed = liftover_vcf(vcf, ChainLiftover(args.chain_file), strict=args.strict_liftover)
        print(f"Failed to lift {int(failed.sum())} variants from hg38 to hg19")
        vcf[failed].to_csv(f"{args.output_dir}/not_lifted.vcf", sep="\t", header=False, index=False)
        vcf = lifted[~failed]

    # standardize before writing snps_hg19.vcf: the emitted file is the
    # --coorFile of the predict step, so its rows must align 1:1 with the
    # per-shift h5s. The reference writes it before standardizing
    # (chromatin.py:232-241), a deliberate divergence.
    n_before = vcf.shape[0]
    std = standardize_chroms(vcf)
    if std.shape[0] != n_before:
        dropped = vcf[~vcf.index.isin(std.index)]
        dropped.to_csv(f"{args.output_dir}/dropped_contigs.vcf", sep="\t", header=False, index=False)
        print(f"Dropped {n_before - std.shape[0]} variants on non-canonical contigs "
              f"(written to {args.output_dir}/dropped_contigs.vcf)")
    vcf = std
    write_vcf_hg19(vcf, f"{args.output_dir}/snps_hg19.vcf")

    try:
        compute_variant_chromatin_effects(
            vcf, genome, runner, args.output_dir, maxshift=args.maxshift, inputsize=args.inputsize,
            legacy_h5=args.legacy_h5, legacy_only=args.legacy_only,
        )
    finally:
        genome.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
