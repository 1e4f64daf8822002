#!/usr/bin/env python3
"""fp32 outputs of two or more trees of the port, bit for bit, on one NVIDIA GPU.

    python3 scripts/probe_fp32_trees.py --package TREE --package TREE [...] [--seed N] [--out DIR]

Each ``--package TREE`` (a directory holding an ``expecto_tpu_torch``) runs
in a process of its own, on chip_smoke.py's seeded inputs made once
(Beluga's published widths, 218 models, maxshift 800), the fp32 (parity
mode) flows whose fc1 goes through ``ops/spans.fc1_pre_from_phases``: the
serve on the first 256 substitutions (``--fp32``'s settings), the chromatin
CLI's streaming h5 step on every variant, the gene call on 96 genes and the
consensus private mix's track predictions (64 records). Prints the sha256
of each flow's output per tree and exits non-zero unless every tree gives
the same digests; ``--out DIR`` writes them to DIR/probe_fp32_trees.json.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N_GENES = 96


def _chip_smoke():
    """chip_smoke.py of this repository, whichever package comes first on
    the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def digest(obj) -> str:
    """sha256 over the values, dtypes, shapes and names of a flow's output
    (data frames, arrays, and dicts and lists of them)."""
    import numpy as np
    import pandas as pd

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, pd.DataFrame):
            h.update(repr(list(x.columns)).encode())
            for c in x.columns:
                feed(x[c].to_numpy())
        elif isinstance(x, np.ndarray):
            h.update(repr((x.dtype.str, x.shape)).encode())
            h.update(repr(x.tolist()).encode() if x.dtype == object else np.ascontiguousarray(x).tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(repr(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for y in x:
                feed(y)
        else:
            h.update(repr(x).encode())

    feed(obj)
    return h.hexdigest()


def child(package: Path, seed: int) -> dict:
    """{flow: digest} of the fp32 flows on the ``expecto_tpu_torch`` of ``package``."""
    sys.path.insert(0, str(package))
    cs = _chip_smoke()
    import numpy as np
    import torch

    import expecto_tpu_torch
    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.features import compute_gene_features
    from expecto_tpu_torch.pipeline.sed import score_sed_serving

    if Path(expecto_tpu_torch.__file__).resolve().parents[1] != package:
        raise AssertionError(f"expecto_tpu_torch came from {expecto_tpu_torch.__file__}, not {package}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = load_params_npz(cs.WORK / "beluga.npz")
    genome = FastaIndex(cs.WORK / "genome.fa")
    ml = load_modellist(cs.WORK / "modellist")
    vcf = standardize_chroms(read_vcf(cs.WORK / "variants.vcf"))
    serve_vcf = standardize_chroms(read_vcf(cs.WORK / "fp32_serve.vcf"))
    serve_genes = load_closest_genes(cs.WORK / "fp32_serve_genes.tsv")
    genes = cs.pipeline_gene_records(seed)[:N_GENES]
    private = cs.consensus_cohort(seed, 64, private=True, n_sites=42)
    flows = {
        "serve_fp32": (cs.BATCH, lambda r: score_sed_serving(serve_vcf, serve_genes, genome, r, ml.iloc[:, 0].tolist(),
                                                             maxshift=cs.MAXSHIFT, model_names=ml.iloc[:, 1].tolist())),
        "h5_stream_fp32": (cs.H5_BATCH, lambda r: cs._chromatin_streaming(r, vcf, genome)),
        "gene_fp32": (cs.GENE_BATCH, lambda r: compute_gene_features(genes, genome, r)),
        "consensus_private_fp32": (cs.CONS_BATCH, lambda r: cs._consensus_call(r, private, "preds")),
    }
    out = {"package": str(package)}
    try:
        for name, (batch, call) in flows.items():
            runner = BelugaRunner(params, batch_size=batch, device="cuda", compute_dtype=torch.float32,
                                  out_dtype=np.float32)
            out[name] = digest(call(runner))
            del runner
            torch.cuda.empty_cache()
    finally:
        genome.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", action="append", default=[],
                    help="a tree holding an expecto_tpu_torch (repeatable; at least two)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_fp32_trees: no CUDA GPU available", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.seed)), flush=True)
        return 0
    if len(args.package) < 2:
        ap.error("give at least two --package trees to compare")
    sys.path.insert(0, str(REPO))
    cs = _chip_smoke()
    card = cs.card_line()
    inputs = cs.make_inputs(args.seed)
    cs.subset(inputs, range(cs.N_FP32_SERVE), "fp32_serve")
    runs = []
    for package in args.package:
        res = subprocess.run([sys.executable, __file__, "--child", package, "--seed", str(args.seed)],
                             stdout=subprocess.PIPE, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    flows = [k for k in runs[0] if k != "package"]
    same = {f: len({r[f] for r in runs}) == 1 for f in flows}
    print(f"fp32 outputs bit-equal across {len(runs)} trees: {same} [{card}]", flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_fp32_trees.json").write_text(json.dumps({"card": card, "runs": runs, "same": same},
                                                                          indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
