"""CLI: chunk mergers and the h5 precision compressor
(``python -m expecto_tpu_torch.cli.merge``; the subcommands and flags of
``expecto_tpu.cli.merge``, reference merge_predict_batched.py /
merge_geuvadis_predict_consensus.py / merge_query_fimo_for_predictions.py /
compress_consensus.py).

Host code only: ``sed`` and ``fimo`` join tab-separated chunk files;
``consensus`` and ``compress`` read and write h5 files (they need h5py).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Merge chunked pipeline outputs")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sed", help="merge chunked sed.tsv outputs")
    sp.add_argument("--batch_dir", required=True)
    sp.add_argument("--n_chunks", type=int, default=None)
    sp.add_argument("-o", dest="out_dir", default="merge_predict_batched")

    cp = sub.add_parser("consensus", help="merge per-gene consensus h5s")
    cp.add_argument("--batch_dir", required=True)
    cp.add_argument("--n_genes", type=int, default=None)
    cp.add_argument("-o", dest="out_dir", default="merge_geuvadis_predict_consensus")

    fp = sub.add_parser("fimo", help="merge chunked FIMO results")
    fp.add_argument("--batch_dir", required=True)
    fp.add_argument("--n_chunks", type=int, default=None)
    fp.add_argument("-o", dest="out_dir", default="merge_fimo")

    zp = sub.add_parser("compress", help="float16+gzip recompress consensus h5s")
    zp.add_argument("--preds_dir", "--basenji_consensus_preds_dir", dest="preds_dir", required=True)
    zp.add_argument("--num_chunks", type=int, default=None)
    zp.add_argument("--chunk_i", type=int, default=None)
    zp.add_argument("--keep_original", action="store_true")
    zp.add_argument("--out_dir", required=True)

    args = p.parse_args(argv)
    from ..pipeline import merge as m

    if args.cmd == "sed":
        m.merge_sed_batches(args.batch_dir, args.out_dir, args.n_chunks)
    elif args.cmd == "consensus":
        m.merge_consensus_batches(args.batch_dir, args.out_dir, args.n_genes)
    elif args.cmd == "fimo":
        m.merge_fimo_batches(args.batch_dir, args.out_dir, args.n_chunks)
    elif args.cmd == "compress":
        m.compress_h5_tree(
            args.preds_dir, args.out_dir,
            num_chunks=args.num_chunks, chunk_i=args.chunk_i,
            delete_original=not args.keep_original,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
