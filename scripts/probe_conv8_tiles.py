#!/usr/bin/env python3
"""The fp32 SIMT conv8_relu kernel with its row tile forced, on one NVIDIA GPU.

    python3 scripts/probe_conv8_tiles.py [--reps N]

``csrc/conv8_relu.cu`` picks a 64- or a 128-row tile per launch (its
``launch_tile``). This script builds two variants of that source under
``build/probe_tiles/``, one that always takes the 64-row tile and one that
always takes the 128-row tile, checks both against the plain version, then
times both beside the kernel's own choice (``conv8_relu``) at every fp32
conv1-conv5 shape of one substitution chunk (chip_smoke.py's shapes, N =
227), in turns, best of ``--reps`` rounds. Prints one line per shape and the
launch-weighted chunk totals.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CHOICE = "if (10 * busiest_rows(m, cols, sms, 64) <= 9 * busiest_rows(m, cols, sms, 128))"


def build_variants() -> dict:
    """{"t64": launcher, "t128": launcher} built from csrc/conv8_relu.cu with
    the tile choice replaced by a constant."""
    from expecto_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "conv8_relu.cu").read_text()
    if CHOICE not in src:
        raise RuntimeError("csrc/conv8_relu.cu no longer holds the tile choice this probe replaces")
    out = REPO / "build" / "probe_tiles"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, cond in (("t64", "if (true)"), ("t128", "if (false)")):
        (out / f"{tag}.cu").write_text(src.replace(CHOICE, cond))
        cmd = [cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS, "-diag-suppress", "177", "-o",
               str(out / f"lib{tag}.so"), str(out / f"{tag}.cu")]
        procs[tag] = subprocess.Popen(cmd)
    fns = {}
    for tag, proc in procs.items():
        if proc.wait(timeout=cuda_build.NVCC_TIMEOUT_S) != 0:
            raise RuntimeError(f"nvcc failed for the {tag} variant")
        fn = ctypes.CDLL(str(out / f"lib{tag}.so")).conv8_relu_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_conv8_tiles: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv8 import _packed, conv8_relu, conv8_relu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    fns = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def variant(tag, x, w, b):
        n, l, cin = x.shape
        y = torch.empty((n, l - 7, w.shape[2]), device=dev)
        err = fns[tag](x.data_ptr(), _packed(w, "simt").data_ptr(), b.data_ptr(), y.data_ptr(), n, l, cin, w.shape[2],
                       0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{tag} launch failed: error {err}")
        return y

    specs = {f"conv{i}": (cin, cout) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    totals = dict.fromkeys(("t64", "t128", "auto", "bound"), 0.0)
    for (name, length), per in sorted(cs.chunk_launches().items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        if name == "conv0":
            continue
        cin, cout = specs[name]
        x = torch.randn((cs.CHUNK, length, cin), generator=gen, device=dev)
        w = torch.randn((8, cin, cout), generator=gen, device=dev) / (8 * cin) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        want = conv8_relu_plain(x, w, b)
        runs = {"t64": lambda: variant("t64", x, w, b), "t128": lambda: variant("t128", x, w, b),
                "auto": lambda: conv8_relu(x, w, b)}
        for tag, fn in runs.items():
            cs._check_close(fn(), want, cs.FP32_ATOL, cs.FP32_RTOL, f"{tag} {name} L={length}")
        times = {tag: [] for tag in runs}
        for _ in range(args.reps):
            for tag, fn in runs.items():
                times[tag].append(cs.cuda_ms(fn))
        best = {tag: min(ms) for tag, ms in times.items()}
        nbytes = 4 * (x.numel() + w.numel() + b.numel() + cs.CHUNK * (length - 7) * cout)
        bound = cs._bound(nbytes, 2.0 * cs.CHUNK * (length - 7) * cin * cout * 8, "fp32")["bound_ms"]
        for tag, ms in best.items():
            totals[tag] += per * ms
        totals["bound"] += per * bound
        print(f"{name} L={length} x{per} bound {bound:.3f} ms: " + " ".join(
            f"{tag} {ms:.3f} ms ({100 * bound / ms:.1f} %)" for tag, ms in best.items()), flush=True)
        del x, w, b, want
        torch.cuda.empty_cache()
    print("fp32 chunk ms: " + ", ".join(f"{k} {v:.3f}" for k, v in totals.items()) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
