#!/usr/bin/env python3
"""fc1's strided product on one NVIDIA GPU: the tensor-core kernels against
their plain version and cuBLAS, and the bf16 kernel's schedule knobs.

    python3 scripts/probe_fc1_torch.py [--reps N] [--groups 0,2,5] [--cols 0,1,2] [--map-tiles]
                                       [--shapes NAME,...] [--out DIR]
    python3 scripts/probe_fc1_torch.py --dtype float32 [--reps N] [--package DIR]
                                       [--shapes NAME,...] [--out DIR]

At each fc1 shape of the bf16 flows (a serving chunk, an h5 pair chunk, a
gene chunk and a consensus chunk, each pool-2 phase; Beluga's published
widths, seeded inputs) this script holds ``ops/fc1.fc1_strided`` (the kernel
of ``csrc/fc1_strided_tc.cu``) against ``fc1_strided_plain`` within two
bf16 steps of max|y|, checks two calls bit for bit, then times, in turns,
best of ``--reps`` rounds: the kernel at its own schedule
(``fc1_schedule``: tile rows, rows, cols, groups), the kernel at every
other combination of ``--groups`` (the schedule's slice count, the K
ranges; 0 = the schedule's own) and ``--cols`` (column tiles a group's
block; 0 = the schedule's own), with ``--map-tiles`` also at the row tiles
that a TMA tensor map of the windows would force (below), each variant
first held to the plain version like the default, the plain
version (fp32 sum), the ``unfold`` + 2003-column ``torch.matmul`` that the
kernel replaced and the library yardstick, one ``torch.matmul`` of the same
windows by the weight zero-padded to 2,048 columns (the port never calls
it). Prints one JSON line a shape with the bound (operations at 989
TFLOP/s against each input read once and the output written once at 3.35
TB/s), the yardstick's time beside every variant's, and the card's name and
power limit; ``--out DIR`` also writes them to DIR/probe_fc1.json.

``--map-tiles``: the kernel loads A by ``cp.async``. A TMA tensor map can
name the windows only as the 4-D tensor (channel, r, a, sample) of frame
s0 + stride*a + r, dims {C, stride, ceil((F - s0)/stride), N}, byte
strides {2C, 2*stride*C, 2*ld}; window w's K chunk of frame f and channels
64j.. is the box {64, 1, bw, bn} at (64j, f % stride, w0 + f // stride,
n0). A box is rectangular in (window, sample), so a row tile holds bw =
min(n_win, 128) windows of bn = max(1, 128 // n_win) whole samples. The
probe encodes that map with the driver's ``cuTensorMapEncodeTiled``
(128-byte swizzle) and reports its CUresult (0: accepted), and times the
kernel at row tiles of bw * bn rows: the cost of such tiles, beside
whatever the copy engine would save.

``--dtype float32``: the parity-mode kernels (three TF32 passes: the split
pass ``csrc/fc1_split_tf32.cu``, then ``csrc/fc1_strided_tf32x3_swap.cu``
at M <= ``SWAP_MAX_M`` or ``csrc/fc1_strided_tf32x3.cu`` above it) at the
same 11 shapes and at M = 1, 4, 5, 8, 16, 32, 64, 65, 96, 128, 129, 192,
256 and 512 windows of the serving span's buffer (F 206, s0 0, stride 25),
fp32 inputs. Each shape: the route's call (``fc1_strided``) and each fp32
kernel through its launcher (``ops/fc1._launch``), against the plain
version and a float64 product of the same inputs: within FP32_REL of
max|y| of float64 and within FP32_PLAIN_REL of the plain version, the
plain version within FP32_PLAIN_REL of float64, the first window read one
frame late outside both, two calls bit-equal; then, in turns, best of
``--reps``: the call, each kernel (split pass included), the split pass
alone, the plain version (``unfold`` + the 2,003-column SGEMM, TF32 off,
which is also the path the kernels replaced) and the yardstick, one SGEMM
of the same windows, made contiguous as (M, K), by W zero-padded to 2,048
columns (TF32 off), and beside it the same SGEMM on the windows as an (N,
n_win, K) tensor (``chip_smoke.py``'s fc1 phase before this probe's
re-timing) and by the 2,003-column W. The bound: 3 x 2MKN operations at the
TF32 rate (495 TFLOP/s) against the function's bytes (the frames, fp32 W
and y once) at 3.35 TB/s, with the share of the 67 TFLOP/s FFMA peak
beside it, and each kernel's streamed bytes (``fc1.streamed_bytes``).
``--package DIR`` imports ``expecto_tpu_torch`` from another tree (the
parent's, unpacked with ``git archive``) and times its ``fc1_strided`` at
the same shapes, with its own kernels' builds: run parent, change, change,
parent in one call to compare them on one card. ``--unchecked`` records
each check in the row instead of raising, to time a tree whose kernel was
cut down on purpose (a kernel with its products taken out, say).
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM, dense bf16 and HBM3
PEAK_TF32, PEAK_FFMA = 495e12, 67e12  # H100 SXM, dense TF32 tensor cores and fp32 outside them
# the fp32 limits of chip_smoke.py, of max|y|: the kernel against float64;
# the plain SGEMM against float64 and the kernel against the plain version
FP32_REL, FP32_PLAIN_REL = 1e-5, 4e-5
C, N_OUT = 640, 2003
# name: (N, F, s0, stride, n_win); the phase buffers of 3,600-bp serving and
# h5 spans have 206 frames, those of 41,800/41,808-bp gene and consensus
# spans 2,594; the last three are small chunks (M = 60, 640, 200)
SHAPES = {
    "serve ph0": (227, 206, 0, 25, 5), "serve ph2": (227, 206, 12, 25, 4),
    "h5 ph0": (224, 206, 0, 25, 5), "h5 ph2": (224, 206, 12, 25, 4),
    "gene ph0": (16, 2594, 0, 25, 100), "gene ph2": (16, 2594, 12, 25, 100),
    "consensus ph0": (5, 2594, 0, 25, 100), "consensus ph2": (5, 2594, 12, 25, 100),
    # small chunks: a serving tail (12 spans), an h5 tail (64 pairs), two gene spans
    "serve tail ph0": (12, 206, 0, 25, 5), "h5 tail ph0": (128, 206, 0, 25, 5), "gene 2 ph0": (2, 2594, 0, 25, 100),
}
# the fp32 probe's M sweep at the serving span's (F, s0, stride): "M=m" is
# N samples of n_win windows (n_win <= 5 fit 206 frames)
M_SWEEP = {f"M={n * n_win}": (n, 206, 0, 25, n_win) for n, n_win in (
    (1, 1), (1, 4), (1, 5), (2, 4), (4, 4), (8, 4), (16, 4), (13, 5), (24, 4), (32, 4), (43, 3), (48, 4), (64, 4),
    (128, 4))}


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


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def map_box(n_win: int) -> tuple[int, int]:
    """(bw, bn): the windows and samples of the 4-D map's box (module
    docstring)."""
    return min(n_win, 128), max(1, 128 // n_win)


def encode_window_map(buf, s0: int, stride: int, n_win: int) -> int:
    """Encodes the 4-D tensor map of the windows of ``buf`` (N, F, C) bf16
    on the card; returns the driver's CUresult (0: accepted)."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    encode = lib.cuTensorMapEncodeTiled
    encode.restype = ctypes.c_int
    encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
    n, f, c = buf.shape
    bw, bn = map_box(n_win)
    dims = (ctypes.c_uint64 * 4)(c, stride, -(-(f - s0) // stride), n)
    strides = (ctypes.c_uint64 * 3)(2 * c, 2 * stride * c, 2 * buf.stride(0))
    box = (ctypes.c_uint32 * 4)(64, 1, bw, bn)
    ones = (ctypes.c_uint32 * 4)(1, 1, 1, 1)
    raw = ctypes.create_string_buffer(128 + 64)  # a CUtensorMap: 128 bytes on a 64-byte boundary
    tmap = (ctypes.addressof(raw) + 63) // 64 * 64
    bf16, interleave_none, swizzle_128b, l2_128b, oob_zero = 9, 0, 3, 2, 0
    return encode(tmap, bf16, 4, buf.data_ptr() + 2 * s0 * c, dims, strides, box, ones, interleave_none,
                  swizzle_128b, l2_128b, oob_zero)


def best_times(fns: dict, reps: int) -> dict:
    """Each callable's best time of ``reps`` rounds, in turns, of 3 calls
    timed with CUDA events (ms a call), after one warm-up call each."""
    import torch

    for fn in fns.values():
        fn()
    times = {key: float("inf") for key in fns}
    for _ in range(reps):
        for key, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fn()
            end.record()
            end.synchronize()
            times[key] = min(times[key], start.elapsed_time(end) / 3)
    return times


def bound_fp32_ms(n: int, s0: int, stride: int, n_win: int) -> tuple[float, str, float]:
    """The least time for the fp32 product: its inputs (the frames the
    windows cover, W) read once and the output written once, in fp32, or
    the three TF32 passes' operations at the TF32 peak; and the one pass of
    fp32 operations at the FFMA peak."""
    frames = (n_win - 1) * stride + 106
    nbytes = 4 * (n * frames * C + 106 * C * N_OUT + n * n_win * N_OUT)
    ops = 2.0 * n * n_win * 106 * C * N_OUT
    b, o = 1e3 * nbytes / PEAK_BYTES, 1e3 * 3 * ops / PEAK_TF32
    return max(b, o), ("bytes" if b > o else "operations"), 1e3 * ops / PEAK_FFMA


def probe_fp32(args, card: str) -> list[dict]:
    """The ``--dtype float32`` probe (module docstring): one row a shape."""
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.ops import fc1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 106 * C
    w = torch.randn((k, N_OUT), generator=gen, device=dev) / k**0.5
    w_pad = F.pad(w, (0, 2048 - N_OUT))
    w64 = w.double()
    routes = [r for r in ("tf32x3_swap", "tf32x3") if r in fc1.TILES and hasattr(fc1, "_launch")]
    rows = []
    for name in args.shapes.split(","):
        n, f, s0, stride, n_win = {**SHAPES, **M_SWEEP}[name]
        buf = torch.rand((n, f, C), generator=gen, device=dev)
        m = n * n_win
        a = fc1._windows(buf, s0, stride, n_win)
        want = fc1.fc1_strided_plain(buf, w, s0, stride, n_win)
        exact = (a.double() @ w64).float()
        torch.cuda.synchronize()
        limit = FP32_REL * float(exact.abs().max())
        plain_limit = FP32_PLAIN_REL / FP32_REL * limit
        plain_f64 = float((want - exact).abs().max())
        late = want.clone()
        late[:, 0] = fc1.fc1_strided_plain(buf, w, s0 + 1, stride, 1)[:, 0]
        calls = {"kernel": lambda: fc1.fc1_strided(buf, w, s0, stride, n_win),
                 **{r: (lambda r=r: fc1._launch(r, buf, w, s0, stride, n_win)) for r in routes}}
        checks = {}
        for key, fn in calls.items():
            y = fn()
            err_plain, err_f64 = float((y - want).abs().max()), float((y - exact).abs().max())
            late_err = float((y - late).abs().max())
            bit_equal = torch.equal(y, fn())
            missed = err_f64 > limit or max(err_plain, plain_f64) > plain_limit or late_err <= plain_limit
            if (missed or not bit_equal) and not args.unchecked:
                raise AssertionError(f"{name} {key}: vs plain {err_plain}, vs float64 {err_f64}, plain vs float64 "
                                     f"{plain_f64}, late window {late_err} (limit {limit}), bit-equal {bit_equal}")
            checks[key] = {"err_plain": err_plain, "err_f64": err_f64, "late_err": late_err, "within_limits": not missed,
                           "bit_equal": bit_equal}
            del y
        a2 = a.reshape(m, k).contiguous()
        fns = {**calls, "plain": lambda: fc1.fc1_strided_plain(buf, w, s0, stride, n_win),
               "library_matmul_2048": lambda: a2 @ w_pad, "library_matmul_2048_3d": lambda: a @ w_pad,
               "library_matmul_2003": lambda: a2 @ w}
        if routes:
            span = (n_win - 1) * stride + 106
            fns["split"] = lambda: fc1.split_planes(buf, s0, span)
        times = best_times(fns, args.reps)
        bound, by, ffma_ms = bound_fp32_ms(n, s0, stride, n_win)
        lib = times["library_matmul_2048"]
        route = fc1._route("cuda", torch.float32, m) if routes else "tf32x3"
        row = {"shape": name, "dtype": "float32", "N": n, "F": f, "s0": s0, "stride": stride, "n_win": n_win, "M": m,
               "route": route, "package": args.package or ".",
               "schedule": list(fc1.fc1_schedule(m, N_OUT, k, fc1.resident_ctas(dev), tiles=fc1.TILES[route])),
               "checks": checks, "plain_err_f64": plain_f64, "limit": limit, "plain_limit": plain_limit,
               "bound_ms": bound, "bound_by": by, "ffma_bound_ms": ffma_ms,
               "tflops_kernel": 2.0 * m * k * N_OUT / times["kernel"] / 1e9,
               **{f"{key}_ms": v for key, v in times.items()},
               "vs_library": {key: times[key] / lib for key in times},
               "share_of_bound": {key: bound / times[key] for key in calls},
               "share_of_ffma_peak": ffma_ms / times["kernel"], "card": card}
        if routes:
            row["streamed_bytes"] = {r: fc1.streamed_bytes(r, n, n_win, stride, C, N_OUT) for r in routes}
            row["schedules"] = {r: list(fc1.fc1_schedule(m, N_OUT, k, fc1.resident_ctas(dev), tiles=fc1.TILES[r]))
                                for r in routes}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del buf, a, a2, want, exact, late
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--groups", default="0", help="schedule slice counts (0: the schedule's own)")
    ap.add_argument("--cols", default="0", help="column tiles a group's block (0: the schedule's own)")
    ap.add_argument("--map-tiles", action="store_true", help="also the row tiles of a TMA map (docstring)")
    ap.add_argument("--shapes", default=None,
                    help="names of SHAPES (and, with --dtype float32, of M_SWEEP) to run (default: all)")
    ap.add_argument("--package", default=None,
                    help="--dtype float32: import expecto_tpu_torch from this tree instead (docstring)")
    ap.add_argument("--unchecked", action="store_true",
                    help="--dtype float32: record the checks without raising (to time a tree whose kernel was cut "
                         "down on purpose)")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_fc1_torch: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.package).resolve() if args.package else REPO))
    from expecto_tpu_torch.ops import cuda_build, fc1

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if args.dtype == "float32":
        args.shapes = args.shapes or ",".join([*SHAPES, *M_SWEEP])
        rows = probe_fp32(args, card)
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / "probe_fc1_fp32.json").write_text(json.dumps(rows, indent=1))
        print(card, flush=True)
        return 0
    if args.package:
        ap.error("--package takes --dtype float32")
    args.shapes = args.shapes or ",".join(SHAPES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 106 * C
    w = (torch.randn((k, N_OUT), generator=gen, device=dev) / k**0.5).bfloat16()
    w_pad = F.pad(w, (0, 2048 - N_OUT))
    launch = cuda_build.launcher("fc1_strided_tc", 13)
    rows = []
    for name in args.shapes.split(","):
        n, f, s0, stride, n_win = SHAPES[name]
        buf = torch.rand((n, f, C), generator=gen, device=dev).bfloat16()
        m = n * n_win
        period = fc1.walk_period(C, stride)
        wp = fc1._packed(w, period)
        own = fc1.fc1_schedule(m, N_OUT, k, fc1.resident_ctas(dev))
        y = fc1.fc1_strided(buf, w, s0, stride, n_win)
        want = fc1.fc1_strided_plain(buf, w, s0, stride, n_win)
        torch.cuda.synchronize()
        tol = 2 * 2.0**-8 * float(want.float().abs().max())

        def check(got, what):
            err = float((got.float() - want.float()).abs().max())
            if err > tol:
                raise AssertionError(f"{name} {what}: the kernel misses the plain version ({err} > {tol})")
            return err

        err = check(y, "own schedule")
        if not torch.equal(y, fc1.fc1_strided(buf, w, s0, stride, n_win)):
            raise AssertionError(f"{name}: two calls differ")
        a = fc1._windows(buf, s0, stride, n_win)

        def forced(sched, out=torch.empty_like(y)):
            ws = torch.empty((2 * sched.groups, sched.cols, m, 256), device=dev) if sched.groups > 1 else None
            e = launch(buf.data_ptr(), wp.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(), n,
                       buf.stride(0), C, s0, stride, n_win, 106, N_OUT, period, *sched,
                       torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"launch failed: {e}")
            return out

        fns = {"kernel": lambda: fc1.fc1_strided(buf, w, s0, stride, n_win),
               "plain": lambda: fc1.fc1_strided_plain(buf, w, s0, stride, n_win),
               "unfold_matmul_2003": lambda: fc1._windows(buf, s0, stride, n_win) @ w,
               "library_matmul_2048": lambda: a @ w_pad}
        schedules = {"kernel": list(own)}
        variants = [("kernel_t{}_r{}_c{}_g{}", dict(groups=g or None, cols=cc or None))
                    for g, cc in itertools.product(_ints(args.groups), _ints(args.cols))]
        extra = {}
        if args.map_tiles:
            bw, bn = map_box(n_win)
            variants.append(("kernel_map_tiles", dict(tile_rows=bw * bn)))
            extra = {"map_box": [64, 1, bw, bn], "map_encode_result": encode_window_map(buf, s0, stride, n_win)}
        for name_fmt, knobs in variants:
            sched = fc1.fc1_schedule(m, N_OUT, k, fc1.resident_ctas(dev), **knobs)
            key = name_fmt.format(*sched)
            if key in fns or (list(sched) == schedules["kernel"] and key != "kernel_map_tiles"):
                continue
            check(forced(sched), key)
            fns[key] = lambda s=sched: forced(s)
            schedules[key] = list(sched)
        times = best_times(fns, args.reps)
        bound, by = bound_ms(n, f, s0, stride, n_win)
        lib = times["library_matmul_2048"]
        row = {"shape": name, "N": n, "F": f, "s0": s0, "stride": stride, "n_win": n_win, "M": m,
               "schedule": schedules["kernel"], "max_abs_err": err, "tol": tol, "bound_ms": bound, "bound_by": by,
               "tflops_kernel": 2.0 * m * k * N_OUT / times["kernel"] / 1e9,
               **{f"{key}_ms": v for key, v in times.items()},
               "vs_library": {key: times[key] / lib for key in schedules},
               "share_of_bound": {key: bound / times[key] for key in schedules},
               "schedules": schedules, **extra, "card": card}
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
