#!/usr/bin/env python3
"""How the port's pipelined runner drains its chunks, on one NVIDIA GPU.

    python3 scripts/probe_pipeline_torch.py [--out DIR] [--seed N] [--repeats R] [--package TREE ...]

Runs three flows of chip_smoke.py's pipeline phase on its seeded inputs
(full Beluga widths): the chromatin CLI's streaming h5 step (fp32, batch
1,024), the consensus private mix's track predictions (bf16, 64 records)
and the gene call (bf16, 768 genes: one full gene block a strand). Each
flow runs on one runner in three ways, in turns, R timed calls each after a
warm-up: depth 1, the CLI's depth with ``FETCH_WORKERS`` writer threads,
and the CLI's depth with one writer (the writes in the calling thread, in
order). Outputs must equal the depth-1 output bit for bit. Reports the
median wall of each way, the card's idle share of one profiled call each
(as chip_smoke.py's pipeline phase takes it) and the chunks of each runner
call in that profiled call.

Each ``--package TREE`` (a directory holding an ``expecto_tpu_torch``; the
default is this repository) runs in a process of its own, in the order
given, on inputs made once: list two trees as A B B A to compare them in
one run. ``--out DIR`` writes ``DIR/probe_pipeline.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py of this repository, whichever package comes first on
    the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _flows(cs, seed: int):
    """[(name, compute dtype, batch, CLI depth, call(runner), equal(a, b))]
    and a close() for their genome."""
    import numpy as np
    import torch

    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.pipeline.features import compute_gene_features

    genome = FastaIndex(cs.WORK / "genome.fa")
    vcf = standardize_chroms(read_vcf(cs.WORK / "variants.vcf"))
    genes = cs.pipeline_gene_records(seed)
    private = cs.consensus_cohort(seed, 64, private=True, n_sites=42)

    def dsets_equal(a, b):
        return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b, strict=True) for k in x)

    return [
        ("h5_stream_fp32", torch.float32, cs.H5_BATCH, 4, lambda r: cs._chromatin_streaming(r, vcf, genome),
         dsets_equal),
        ("consensus_private_bf16", torch.bfloat16, cs.CONS_BATCH, 4,
         lambda r: cs._consensus_call(r, private, "preds"), np.array_equal),
        ("gene_bf16", torch.bfloat16, cs.GENE_BATCH, cs.GENE_CLI_DEPTH,
         lambda r: compute_gene_features(genes, genome, r), np.array_equal),
    ], genome.close


def child(package: Path, seed: int, repeats: int) -> dict:
    """The three flows on the ``expecto_tpu_torch`` of ``package``."""
    sys.path.insert(0, str(package))
    cs = _chip_smoke()
    import numpy as np
    import torch

    import expecto_tpu_torch
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.ops import cuda_build
    from expecto_tpu_torch.parallel.runner import BelugaRunner

    if Path(expecto_tpu_torch.__file__).resolve().parents[1] != package:
        raise AssertionError(f"expecto_tpu_torch came from {expecto_tpu_torch.__file__}, not {package}")
    cuda_build.build()
    params = load_params_npz(cs.WORK / "beluga.npz")
    flows, close = _flows(cs, seed)
    out = {"package": str(package)}
    try:
        for name, dtype, batch, depth, call, equal in flows:
            kind = str(dtype).removeprefix("torch.")
            wire = np.float16 if dtype == torch.bfloat16 else np.float32
            runner = BelugaRunner(params, batch_size=batch, device="cuda", compute_dtype=dtype, out_dtype=wire)
            pool = runner.FETCH_WORKERS
            call(runner)  # warm-up
            ways = {"depth1": (1, pool), f"depth{depth}_workers{pool}": (depth, pool),
                    f"depth{depth}_workers1": (depth, 1)}
            walls, want = {w: [] for w in ways}, None
            for _ in range(repeats):
                for way, (d, workers) in ways.items():
                    runner.FETCH_WORKERS = workers
                    got, wall, _counts, _peak = cs._pipeline_call(runner, call, d, kind)
                    if want is None:
                        want = got
                    elif not equal(got, want):
                        raise AssertionError(f"{name} {way}: the output differs from depth 1")
                    walls[way].append(wall)
            prof = {}
            for way, (d, workers) in ways.items():
                runner.FETCH_WORKERS = workers
                prof[way] = cs._pipeline_profiled(runner, call, d)
            out[name] = {way: {"wall_s": statistics.median(walls[way]), "walls_s": walls[way], **prof[way]}
                         for way in ways}
            del runner
            torch.cuda.empty_cache()
    finally:
        close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--package", action="append", default=None,
                    help="a tree holding an expecto_tpu_torch (repeatable; default: this repository)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_pipeline_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.seed, args.repeats)), flush=True)
        return 0
    sys.path.insert(0, str(REPO))
    cs = _chip_smoke()
    card = cs.card_line()
    cs.make_inputs(args.seed)
    runs = []
    for package in args.package or [str(REPO)]:
        res = subprocess.run([sys.executable, __file__, "--child", package, "--seed", str(args.seed),
                              "--repeats", str(args.repeats)], stdout=subprocess.PIPE, text=True, check=True)
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append(run)
        for name, flow in run.items():
            if name == "package":
                continue
            print(f"{package} {name}: " + "; ".join(
                f"{way} median {v['wall_s']:.3f} s of {[round(w, 3) for w in v['walls_s']]}, idle "
                f"{100 * v['idle_share']:.1f} % (profiled {v['profiled_wall_s']:.3f} s, {v['syncs']} syncs, runner "
                f"calls of {cs._runs(v['chunks_per_call'])} chunks)" for way, v in flow.items()) + f" [{card}]",
                  flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_pipeline.json").write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
