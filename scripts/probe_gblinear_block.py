#!/usr/bin/env python3
"""The K-model trainer's block step on one NVIDIA GPU: its two kernels per
K, and a round of the sweep against another tree's in turns.

    python3 scripts/probe_gblinear_block.py [--ks 1,128,218,256,1000] [--out DIR]
    python3 scripts/probe_gblinear_block.py --package smoke_tree/parent --package . --package . \\
        --package smoke_tree/parent [--ks ...] [--rounds R] [--out DIR]

Without ``--package``: for each K of ``chip_smoke.TRAIN_BLOCK_SHAPES`` (at
the row count of the call that runs it), ``chip_smoke.block_step_row``: the
gradient kernel and the residual kernel (``ops/gblinear_block.py``) held to
float64 and to the coordinate step bit for bit, then timed beside their
bounds, the plain block step, the torch block step they replaced (SGEMM
and ``csrc/gblinear_cd.cu``: the yardstick) and ``torch.addmm``.

With ``--package DIR`` (repeatable): each tree in its own process, in the
order given (parent, change, change, parent), builds the sweep's state with
that tree's ``models.gblinear.multi_state`` on seeded full-width features
(20,020 of them: 40 blocks of 512) and times ``multi_round``, ms a round
by the host clock after a synchronize, the least of ``--rounds`` rounds
after two warm ones, at each K (``--profile``: and the card's time by
kernel over one more round). Unpack the other tree with ``git archive``
into a git-ignored directory first. Prints one JSON line a row and writes
them all to ``DIR/probe_gblinear_block.json`` with ``--out``. ``--unchecked``
records failed checks in the rows instead of raising, to time a copy of the
tree whose kernels were cut down on purpose (their products taken out,
say), run from that copy.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FEATURES = 20_020


def _shapes(ks: str | None) -> list[tuple[int, int]]:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    want = None if ks is None else {int(k) for k in ks.split(",")}
    return [(n, k) for n, k in cs.TRAIN_BLOCK_SHAPES if want is None or k in want]


def _profiled_round(fn) -> list[dict]:
    """One call of ``fn`` under ``torch.profiler``: the card's time by
    kernel name (the longest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, dict] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            k = by_name.setdefault(e.name(), {"name": e.name()[:90], "calls": 0, "ms": 0.0})
            k["calls"] += 1
            k["ms"] += e.duration_ns() / 1e6
    return sorted(by_name.values(), key=lambda k: -k["ms"])


def round_worker(package: str, shapes: list[tuple[int, int]], rounds: int, seed: int, profile: bool) -> list[dict]:
    """ms a round of ``package``'s ``multi_round`` at each (rows, K), and
    with ``profile`` the card's time by kernel over one more round."""
    sys.path.insert(0, str(Path(package).resolve()))
    import numpy as np
    import torch

    from expecto_tpu_torch.models import gblinear

    rows = []
    rng = np.random.default_rng(seed)
    X_all = rng.standard_normal((max(n for n, _k in shapes), FEATURES), dtype=np.float32)
    for n, k in shapes:
        X = X_all[:n]
        Y = rng.standard_normal((n, k), dtype=np.float32)
        W = rng.integers(0, 3, size=(n, k)).astype(np.float32)
        hp = gblinear.GBLinearParams()
        s = gblinear.multi_state(X, Y, W, hp, torch.device("cuda"))
        walls = []
        for it in range(2 + rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gblinear.multi_round(hp, s)
            torch.cuda.synchronize()
            if it >= 2:
                walls.append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(s.w_blocks).all()):
            raise AssertionError(f"{package}: non-finite weights at K = {k}")
        row = {"package": package, "n": n, "K": k, "ms_per_round": min(walls), "walls_ms": walls}
        if profile:
            row["kernels"] = _profiled_round(lambda: gblinear.multi_round(hp, s))
        rows.append(row)
        del s
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default=None, help="comma-separated K values of chip_smoke.TRAIN_BLOCK_SHAPES")
    ap.add_argument("--package", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true", help="with --package: the card's time by kernel in a round")
    ap.add_argument("--unchecked", action="store_true",
                    help="record failed checks in the rows instead of raising (a tree cut down on purpose)")
    ap.add_argument("--round-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    shapes = _shapes(args.ks)
    if args.round_worker:
        for row in round_worker(args.round_worker, shapes, args.rounds, args.seed, args.profile):
            print(json.dumps(row), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("probe_gblinear_block: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = cs.card_line()
    rows = []
    if args.package:
        for package in args.package:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--round-worker", package, "--rounds",
                   str(args.rounds), "--seed", str(args.seed)] + (["--ks", args.ks] if args.ks else []) + (
                   ["--profile"] if args.profile else [])
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=1800, check=True, cwd=REPO).stdout
            for line in out.splitlines():
                row = {**json.loads(line), "card": card}
                rows.append(row)
                print(json.dumps(row), flush=True)
    else:
        sys.path.insert(0, str(REPO))
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        for n, k in shapes:
            row = {**cs.block_step_row(n, k, gen, checked=not args.unchecked), "card": card}
            rows.append(row)
            print(json.dumps({key: v for key, v in row.items() if key != "times"}), flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_gblinear_block.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
