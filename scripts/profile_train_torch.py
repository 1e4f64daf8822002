#!/usr/bin/env python3
"""Where the time of the port's gblinear training goes, on one NVIDIA GPU.

    python3 scripts/profile_train_torch.py [--out DIR] [--seed N]

Builds chip_smoke.py's seeded training tables (24,338 genes x 20,020 fp32
features, 218 tissues) and runs the two sweeps with the reference's
hyperparameters (eta 0.01, lambda 100, 100 rounds, blocks of 512 features):
K = 1, one tissue with its watchlist (``train_expression_model``), and
K = 218, every tissue in one sweep (``train_all_tissues(vectorized=True)``).
Each runs once to warm up, once timed, once under ``torch.profiler``. Prints
per sweep the wall time (unprofiled and profiled), the card's busy and idle
shares over the call and inside the rounds (each round is a
``gblinear_round`` range), the time a round on the card and on the host
(the CPU side of the range: the time to issue the round's launches), the
device time per kernel name inside the rounds, and the time a round
without the profiler: the trainer the call made (``train_gblinear`` or
``train_gblinear_multi``, with its arguments) called again at 20 and at 100
rounds, three times each in turns, the difference of the median walls over
80. ``--out DIR`` writes them to ``DIR/profile_train.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from expecto_tpu_torch.pipeline import train as ptrain

    # the trainer each sweep calls, with its arguments, for the unprofiled round time
    trainers = {}
    for name in ("train_gblinear", "train_gblinear_multi"):
        def spy(*a, _fn=getattr(ptrain, name), _name=name, **kw):
            trainers[_name] = (_fn, a, kw)
            return _fn(*a, **kw)
        setattr(ptrain, name, spy)

    def unprofiled_ms_per_round(name: str) -> dict:
        fn, a, kw = trainers[name]
        walls = {20: [], 100: []}
        for _ in range(3):
            for rounds in walls:
                hp = dataclasses.replace(a[2], num_round=rounds)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*a[:2], hp, *a[3:], **kw)
                torch.cuda.synchronize()
                walls[rounds].append(time.perf_counter() - t0)
        return {"trainer": name, "walls_20_s": walls[20], "walls_100_s": walls[100],
                "ms_per_round": 1e3 * (statistics.median(walls[100]) - statistics.median(walls[20])) / 80}

    card = cs.card_line()
    inp = cs.make_train_inputs(args.seed)
    X, geneanno, expression = inp["X"], inp["geneanno"], inp["expression"]
    sweeps = {
        "k1": (lambda: ptrain.train_expression_model(X, geneanno, expression.iloc[:, 1].values, device="cuda"),
               "train_gblinear"),
        "k218": (lambda: ptrain.train_all_tissues(X, geneanno, expression, vectorized=True, device="cuda"),
                 "train_gblinear_multi"),
    }
    results = {}
    for tag, (fn, trainer) in sweeps.items():
        fn()  # warm-up: kernel load, cuBLAS handles, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_off = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace = cs._round_trace(prof, cs.TRAIN_ROUNDS)
        dev = cs.profiled_events(prof)
        rounds_dev = sorted((s, e) for s, e, name in dev if name == "gblinear_round")
        host_ms = [(e - s) / 1e3 for s, e, name in cs.profiled_events(prof, "cpu") if name == "gblinear_round"]
        by_name: dict[str, dict] = {}
        j = 0
        for s, end, name in sorted(ev for ev in dev if ev[2] != "gblinear_round"):
            while j < len(rounds_dev) and rounds_dev[j][1] < s:
                j += 1
            if j < len(rounds_dev) and rounds_dev[j][0] <= s and end <= rounds_dev[j][1]:
                k = by_name.setdefault(name, {"name": name, "calls": 0, "device_ms": 0.0})
                k["calls"] += 1
                k["device_ms"] += (end - s) / 1e3
        kernels = sorted(by_name.values(), key=lambda k: -k["device_ms"])
        r = {"wall_s": wall_off, "profiled_wall_s": wall, "host_ms_per_round_median": statistics.median(host_ms),
             "host_ms_per_round_max": max(host_ms), **trace,
             "call_idle_share": 1 - trace["call_busy_ms"] / (wall * 1e3), "kernels_in_rounds": kernels,
             "unprofiled": unprofiled_ms_per_round(trainer)}
        results[tag] = r
        sweep_ms = r["sweep_ms_per_round"] * cs.TRAIN_ROUNDS
        print(f"card: {card}; {tag}: call {wall_off:.3f} s unprofiled, {wall:.3f} s profiled; card busy "
              f"{r['call_busy_ms']:.1f} ms (idle {100 * r['call_idle_share']:.1f} % of the call); {r['ms_per_round']:.3f} "
              f"ms a round on the card ({r['sweep_ms_per_round']:.3f} ms the block sweep, idle "
              f"{100 * r['sweep_idle_share']:.1f} %), host {r['host_ms_per_round_median']:.3f} ms a round to issue it "
              f"(max {r['host_ms_per_round_max']:.3f}); without the profiler {r['unprofiled']['ms_per_round']:.3f} ms a "
              f"round ({trainer} at 100 and 20 rounds: {[round(w, 3) for w in r['unprofiled']['walls_100_s']]}, "
              f"{[round(w, 3) for w in r['unprofiled']['walls_20_s']]} s)")
        for k in kernels[:12]:
            print(f"  device {k['device_ms']:9.2f} ms {100 * k['device_ms'] / max(sweep_ms, 1e-9):5.1f}% of the sweep "
                  f" x{k['calls']:<6d} {k['name'][:110]}")
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "profile_train.json").write_text(json.dumps({"card": card, **results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
