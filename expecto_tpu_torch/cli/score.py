"""CLI: one-shot SED serving on a CUDA GPU — VCF to per-tissue expression
effects in a single device pass (``python -m expecto_tpu_torch.cli.score``;
the arguments of ``expecto_tpu.cli.score`` plus ``--device``).

Under ``torchrun`` each rank serves its block of the (variant, gene) rows on
its own card (or a shared one), the ranks exchange the per-row scalars, and
rank 0 writes ``--output``::

    torchrun --standalone --nproc_per_node 2 -m expecto_tpu_torch.cli.score ...

``--trace_dir DIR`` profiles the scoring call (``utils/profiling.trace``):
the Chrome trace shows the ``sed.*`` stage spans and the ``runner.*``
spans beside the card's kernels and copies, and ``spans_*.jsonl`` lists
every span with its parent, times and counts.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fused variant SED scoring (chromatin + predict in one pass)")
    p.add_argument("inputfile", help="VCF of variants (substitutions and indels; contig-edge rows fall back to the per-window path in-process)")
    p.add_argument("--geneFile", required=True, help="closest-gene association file")
    p.add_argument("--model_save_file", default=None)
    p.add_argument("--modelList", default=None)
    p.add_argument("--genome", default="./resources/hg19.fa")
    p.add_argument("--beluga_weights", default="./resources/deepsea.beluga.npz")
    p.add_argument("--maxshift", type=int, default=800)
    p.add_argument("--fixeddist", type=int, default=0)
    p.add_argument("--batchsize", type=int, default=2048)
    p.add_argument("--fp32", action="store_true", help="full-precision parity mode (default bf16 compute, fp16 wire)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; raises if no GPU is present)")
    p.add_argument("--output", default="output.csv")
    p.add_argument("--trace_dir", default=None,
                   help="profile the scoring into this directory: a Chrome trace (trace_*.json: the program's "
                        "spans, its host work and the card's kernels on one timeline) and the spans as JSON "
                        "lines (spans_*.jsonl)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.model_save_file or args.modelList):
        print("either --model_save_file or --modelList is required", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from ..genome.fasta import FastaIndex
    from ..genome.vcf import read_vcf, standardize_chroms
    from ..io.tables import load_closest_genes, load_modellist
    from ..models.convert import load_params_npz
    from ..parallel.mesh import local_device, maybe_initialize_distributed
    from ..parallel.runner import BelugaRunner
    from ..pipeline.sed import score_sed_serving
    from ..utils.profiling import trace

    # several ranks: join the process group before any CUDA work; rows then
    # shard per rank and rank 0 writes the merged output.csv
    maybe_initialize_distributed(args.device)
    runner = BelugaRunner(
        load_params_npz(args.beluga_weights),
        batch_size=args.batchsize,
        device=local_device(args.device),
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
        out_dtype=np.float32 if args.fp32 else np.float16,
    )
    genome = FastaIndex(args.genome)
    vcf = standardize_chroms(read_vcf(args.inputfile))
    gene = load_closest_genes(args.geneFile)

    if args.modelList:
        modellist = load_modellist(args.modelList)
        paths = modellist.iloc[:, 0].tolist()
        names = modellist.iloc[:, 1].tolist() if modellist.shape[1] > 1 else None
    else:
        paths, names = [args.model_save_file], None

    try:
        with trace(args.trace_dir):
            df = score_sed_serving(
                vcf, gene, genome, runner, paths,
                maxshift=args.maxshift, fixeddist=args.fixeddist,
                model_names=names, output_csv=args.output,
            )
    finally:
        genome.close()
    print(f"wrote {args.output} ({df.shape[0]} rows x {len(paths)} models)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
