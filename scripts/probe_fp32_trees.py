#!/usr/bin/env python3
"""The port's fp32 outputs of two or more trees within the flows' fp32 limits,
and their bf16 outputs bit for bit, on one NVIDIA GPU.

    python3 scripts/probe_fp32_trees.py --package TREE --package TREE [...] [--seed N] [--out DIR]

Each ``--package TREE`` (a directory holding an ``expecto_tpu_torch``) runs
in a process of its own, on chip_smoke.py's seeded inputs made once
(Beluga's published widths, 218 models, maxshift 800), the flows whose fc1
goes through ``ops/spans.fc1_pre_from_phases``. In fp32 (parity mode): the
serve on the first 256 substitutions (``--fp32``'s settings), the chromatin
CLI's streaming h5 step on every variant, the gene call on 96 genes and the
consensus private cohort's features (64 records, fp32 wire). In bf16 (the
CLIs' defaults, fp16 wire): the serve on every row and the h5 step. Each
later tree is held against the first: its fp32 outputs within chip_smoke.py's
fp32 limits of each flow (serve: REF/ALT rtol 1e-4, SED, all with atol 1e-5
of max|REF|; h5: REF/ALT rtol 1e-4 atol 1e-5, diff atol 1e-5; gene and
consensus features: 1e-5 of max|feature|), with max |diff| printed, and
its bf16 outputs equal to the first tree's bit for bit (sha256). Exits
non-zero on a miss; ``--out DIR`` writes the results to
DIR/probe_fp32_trees.json. The outputs pass between the processes through
build/probe_fp32_trees/, removed at the end.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pickle
import shutil
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


def child(package: Path, seed: int, dump: Path) -> dict:
    """{flow: sha256} of the bf16 flows on the ``expecto_tpu_torch`` of
    ``package``; the fp32 flows' outputs are pickled to ``dump``."""
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
    all_genes = load_closest_genes(cs.WORK / "genes.tsv")
    serve_vcf = standardize_chroms(read_vcf(cs.WORK / "fp32_serve.vcf"))
    serve_genes = load_closest_genes(cs.WORK / "fp32_serve_genes.tsv")
    genes = cs.pipeline_gene_records(seed)[:N_GENES]
    private = cs.consensus_cohort(seed, 64, private=True, n_sites=42)

    def serve(v, g):
        return lambda r: score_sed_serving(v, g, genome, r, ml.iloc[:, 0].tolist(), maxshift=cs.MAXSHIFT,
                                           model_names=ml.iloc[:, 1].tolist())

    flows = {
        "serve_fp32": (torch.float32, cs.BATCH, serve(serve_vcf, serve_genes)),
        "h5_stream_fp32": (torch.float32, cs.H5_BATCH, lambda r: cs._chromatin_streaming(r, vcf, genome)),
        "gene_fp32": (torch.float32, cs.GENE_BATCH, lambda r: compute_gene_features(genes, genome, r)),
        "consensus_private_features_fp32": (torch.float32, cs.CONS_BATCH,
                                            lambda r: cs._consensus_call(r, private, "features")),
        "serve_bf16": (torch.bfloat16, cs.BATCH, serve(vcf, all_genes)),
        "h5_stream_bf16": (torch.bfloat16, cs.H5_BATCH, lambda r: cs._chromatin_streaming(r, vcf, genome)),
    }
    out, fp32 = {"package": str(package)}, {}
    try:
        for name, (dtype, batch, call) in flows.items():
            wire = np.float32 if dtype == torch.float32 else np.float16
            runner = BelugaRunner(params, batch_size=batch, device="cuda", compute_dtype=dtype, out_dtype=wire)
            got = call(runner)
            if dtype == torch.float32:
                fp32[name] = got
            else:
                out[name] = digest(got)
            del runner
            torch.cuda.empty_cache()
    finally:
        genome.close()
    dump.write_bytes(pickle.dumps(fp32, protocol=pickle.HIGHEST_PROTOCOL))
    return out


def _max_gap(got, want) -> float:
    import numpy as np

    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def compare_fp32(cs, got: dict, want: dict) -> dict:
    """max |got - want| of each fp32 flow, raising where a flow misses its
    limit (module docstring)."""
    import numpy as np

    gaps = {}
    gaps["serve_fp32"] = cs._serve_check(got["serve_fp32"], want["serve_fp32"], "serve_fp32")
    h5 = {}
    for s, (g, w) in enumerate(zip(got["h5_stream_fp32"], want["h5_stream_fp32"])):
        for name, rtol, atol in (("diff", 0, cs.H5_DIFF_ATOL), ("ref", cs.H5_RTOL, cs.H5_ATOL),
                                 ("alt", cs.H5_RTOL, cs.H5_ATOL)):
            np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol, err_msg=f"h5_stream_fp32 {name} {s}")
            h5[name] = max(h5.get(name, 0.0), _max_gap(g[name], w[name]))
    gaps["h5_stream_fp32"] = h5
    for name, rel in (("gene_fp32", cs.GENE_FEAT_RTOL), ("consensus_private_features_fp32", cs.CONS_FEAT_RTOL)):
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name], np.float64)
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {g.shape} against {w.shape}")
        gap, limit = _max_gap(g, w), rel * float(np.abs(w).max())
        if not gap <= limit:
            raise AssertionError(f"{name}: max |diff| {gap} over {limit}")
        gaps[name] = {"max_abs_diff": gap, "limit": limit}
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", action="append", default=[],
                    help="a tree holding an expecto_tpu_torch (repeatable; at least two)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_fp32_trees: no CUDA GPU available", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.seed, Path(args.dump))), flush=True)
        return 0
    if len(args.package) < 2:
        ap.error("give at least two --package trees to compare")
    sys.path.insert(0, str(REPO))
    cs = _chip_smoke()
    card = cs.card_line()
    inputs = cs.make_inputs(args.seed)
    cs.subset(inputs, range(cs.N_FP32_SERVE), "fp32_serve")
    work = REPO / "build" / "probe_fp32_trees"
    work.mkdir(parents=True, exist_ok=True)
    runs, fp32_gaps = [], []
    try:
        for i, package in enumerate(args.package):
            dump = work / f"tree{i}.pkl"
            res = subprocess.run([sys.executable, __file__, "--child", package, "--seed", str(args.seed), "--dump",
                                  str(dump)], stdout=subprocess.PIPE, text=True, check=True)
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
            if i:
                gaps = compare_fp32(cs, pickle.loads(dump.read_bytes()), pickle.loads((work / "tree0.pkl").read_bytes()))
                fp32_gaps.append({"package": package, "against": args.package[0], "max_abs_diff": gaps})
                print(json.dumps(fp32_gaps[-1]), flush=True)
                dump.unlink()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    flows = [k for k in runs[0] if k != "package"]
    same = {f: len({r[f] for r in runs}) == 1 for f in flows}
    print(f"fp32 outputs within their limits across {len(runs)} trees; bf16 outputs bit-equal: {same} [{card}]",
          flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_fp32_trees.json").write_text(json.dumps(
            {"card": card, "runs": runs, "fp32": fp32_gaps, "bf16_same": same}, indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
