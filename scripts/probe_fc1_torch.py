#!/usr/bin/env python3
"""fc1's strided product on one NVIDIA GPU: the tensor-core kernel against
its plain version and cuBLAS.

    python3 scripts/probe_fc1_torch.py [--reps N] [--splits 1,2,4,8] [--out DIR]

At each fc1 shape of the bf16 flows (a serving chunk, an h5 pair chunk, a
gene chunk and a consensus chunk, each pool-2 phase; Beluga's published
widths, seeded inputs) this script holds ``ops/fc1.fc1_strided`` (the kernel
of ``csrc/fc1_strided_tc.cu``) against ``fc1_strided_plain`` within two
bf16 steps of max|y|, checks two calls bit for bit, then times, in turns,
best of ``--reps`` rounds: the kernel at its own split-K count and at each
count of ``--splits`` (its launcher called directly), the plain version
(fp32 sum), today's ``unfold`` + 2003-column ``torch.matmul`` and the
library yardstick, one ``torch.matmul`` of the same windows by the weight
zero-padded to 2,048 columns (the port never calls it). Prints one JSON line
a shape with the bound (operations at 989 TFLOP/s against each input read
once and the output written once at 3.35 TB/s) and the card's name and
power limit; ``--out DIR`` also writes them to DIR/probe_fc1.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, dense bf16 and HBM3
C, N_OUT = 640, 2003
# name: (N, F, s0, stride, n_win); the phase buffers of 3,600-bp serving and
# h5 spans have 206 frames, those of 41,800/41,808-bp gene and consensus
# spans 2,594
SHAPES = {
    "serve ph0": (227, 206, 0, 25, 5), "serve ph2": (227, 206, 12, 25, 4),
    "h5 ph0": (224, 206, 0, 25, 5), "h5 ph2": (224, 206, 12, 25, 4),
    "gene ph0": (16, 2594, 0, 25, 100), "gene ph2": (16, 2594, 12, 25, 100),
    "consensus ph0": (5, 2594, 0, 25, 100), "consensus ph2": (5, 2594, 12, 25, 100),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n: int, f: int, s0: int, stride: int, n_win: int) -> tuple[float, str]:
    """The least time for the product: the frames the windows cover, the
    weight and the output moved once, or the operations at the bf16 peak."""
    frames = (n_win - 1) * stride + 106
    nbytes = 2 * (n * frames * C + 106 * C * N_OUT + n * n_win * N_OUT)
    ops = 2.0 * n * n_win * 106 * C * N_OUT
    b, o = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_OPS
    return max(b, o), ("bytes" if b > o else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--splits", default="1,2,4,8", help="split-K counts to time beside the kernel's own")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_fc1_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from expecto_tpu_torch.ops import cuda_build, fc1

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((106 * C, N_OUT), generator=gen, device=dev) / (106 * C) ** 0.5).bfloat16()
    w_pad = F.pad(w, (0, 2048 - N_OUT))
    launch = cuda_build.launcher("fc1_strided_tc", 9)
    wp = fc1._packed(w)
    rows = []
    for name, (n, f, s0, stride, n_win) in SHAPES.items():
        buf = torch.rand((n, f, C), generator=gen, device=dev).bfloat16()
        m = n * n_win
        own = fc1.fc1_splits(m, N_OUT, 106 * C, sms)
        y = fc1.fc1_strided(buf, w, s0, stride, n_win)
        want = fc1.fc1_strided_plain(buf, w, s0, stride, n_win)
        torch.cuda.synchronize()
        err = float((y.float() - want.float()).abs().max())
        tol = 2 * 2.0**-8 * float(want.float().abs().max())
        if err > tol or not torch.equal(y, fc1.fc1_strided(buf, w, s0, stride, n_win)):
            raise AssertionError(f"{name}: the kernel misses the plain version ({err} > {tol}) or repeats unequal")
        a = fc1._windows(buf, s0, stride, n_win)

        def forced(splits, out=torch.empty_like(y)):
            ws = torch.empty((splits, m, 2048), device=dev) if splits > 1 else None
            err = launch(buf.data_ptr(), wp.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(), n,
                         buf.stride(0), C, s0, stride, n_win, 106, N_OUT, splits,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return out

        fns = {"kernel": lambda: fc1.fc1_strided(buf, w, s0, stride, n_win),
               "plain": lambda: fc1.fc1_strided_plain(buf, w, s0, stride, n_win),
               "unfold_matmul_2003": lambda: fc1._windows(buf, s0, stride, n_win) @ w,
               "library_matmul_2048": lambda: a @ w_pad}
        for s in (int(x) for x in args.splits.split(",") if x):
            if s != own:
                fns[f"kernel_splits{s}"] = lambda s=s: forced(s)
        for fn in fns.values():
            fn()
        times = {k: float("inf") for k in fns}
        for _ in range(args.reps):
            for key, fn in fns.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    fn()
                end.record()
                end.synchronize()
                times[key] = min(times[key], start.elapsed_time(end) / 3)
        bound, by = bound_ms(n, f, s0, stride, n_win)
        row = {"shape": name, "N": n, "F": f, "s0": s0, "stride": stride, "n_win": n_win, "M": m, "splits": own,
               "max_abs_err": err, "tol": tol, "bound_ms": bound, "bound_by": by,
               "tflops_kernel": 2.0 * m * 106 * C * N_OUT / times["kernel"] / 1e9,
               **{f"{k}_ms": v for k, v in times.items()}, "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del buf, a, y, want
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_fc1.json").write_text(json.dumps(rows, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
