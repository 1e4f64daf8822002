#!/usr/bin/env python3
"""Where the time of the gblinear round kernel goes, on one NVIDIA GPU.

    python3 scripts/probe_gblinear_round.py [--reps N]

``csrc/gblinear_round.cu`` runs, per feature block, (A) the partial
gradients over each CTA's rows, a grid sync, (B) the per-feature reduction
and coordinate update, a grid sync, and (C) the residual update. This
script builds variants of that source under ``build/probe_round/`` with
phases compiled out (their results are wrong; only their times are read):
the grid syncs alone, A alone, A and B, and every phase but one; then
times each beside the kernel itself in turns (CUDA events, best of
``--reps``) at the published shape (22,296 rows, 40 blocks of 512
features), at twice the rows, and at 132 rows (one a CTA: the per-block
cost that does not scale with the data); and two variants of the whole
kernel with the gradient phase's column loop unrolled 2 and 6 times (the
kernel unrolls it 4 times). Prints microseconds a block.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# (phase, its first line, the line after it) in csrc/gblinear_round.cu
PHASES = (("A", "    // (A) partial gradients", "    grid.sync();\n\n    // (B)"),
          ("B", "    // (B) each feature's gradient", "    grid.sync();\n\n    // (C)"),
          ("C", "    // (C) r += dw^T Xb", "  }\n\n  for (int c = threadIdx.x; c < len; c += THREADS) r[lo + c]"))
VARIANTS = {"kernel": (), "syncs": ("A", "B", "C"), "A": ("B", "C"), "A+B": ("C",), "B+C": ("A",), "A+C": ("B",),
            "unroll2": (), "unroll6": ()}
UNROLL = "#pragma unroll 4  // 16 loads a lane in flight"
SHAPES = ((22_296, 40), (44_592, 40), (132, 40))  # (rows, blocks of 512)


def build_variants() -> dict:
    """{variant: launcher} built from csrc/gblinear_round.cu with each
    phase wrapped in ``#ifndef SKIP_<phase>`` and the variant's phases
    defined away."""
    from expecto_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "gblinear_round.cu").read_text()
    for phase, start, end in PHASES:
        i = src.index(start)
        j = src.index(end, i)
        src = src[:i] + f"#ifndef SKIP_{phase}\n" + src[i:j] + "#endif\n" + src[j:]
    if UNROLL not in src:
        raise RuntimeError("csrc/gblinear_round.cu no longer holds the unroll this probe replaces")
    out = REPO / "build" / "probe_round"
    out.mkdir(parents=True, exist_ok=True)
    (out / "gblinear_cd.cuh").write_text((cuda_build.CSRC_DIR / "gblinear_cd.cuh").read_text())
    procs = {}
    for tag, skip in VARIANTS.items():
        name = tag.replace("+", "_")
        unroll = tag[len("unroll"):] if tag.startswith("unroll") else "4"
        (out / f"{name}.cu").write_text(src.replace(UNROLL, UNROLL.replace("unroll 4", f"unroll {unroll}")))
        cmd = [cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS, *(f"-DSKIP_{p}" for p in skip), "-o",
               str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[tag] = subprocess.Popen(cmd)
    fns = {}
    for tag, proc in procs.items():
        if proc.wait(timeout=cuda_build.NVCC_TIMEOUT_S) != 0:
            raise RuntimeError(f"nvcc failed for the {tag} variant")
        fn = ctypes.CDLL(str(out / f"lib{tag.replace('+', '_')}.so")).gblinear_round_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_gblinear_round: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from expecto_tpu_torch.models.gblinear import _pad_blocks
    from expecto_tpu_torch.ops import gblinear_round as gr

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, n_blocks in SHAPES:
        Xt, _ = _pad_blocks(torch.randn((n_blocks * 512, n), generator=gen, device="cuda"), 512)
        hess = Xt.square().sum(2)
        w, bias = torch.zeros((n_blocks, 512), device="cuda"), torch.zeros(1, device="cuda")
        r = torch.randn(n, generator=gen, device="cuda")
        ctas = gr.round_ctas(0, n, 512)
        scratch = torch.zeros(gr.scratch_floats(ctas, 512), device="cuda")

        def launch(tag):
            err = fns[tag](Xt.data_ptr(), hess.data_ptr(), w.data_ptr(), bias.data_ptr(), r.data_ptr(),
                           scratch.data_ptr(), n_blocks, 512, n, ctas, float(n), 0.01, 100.0, 0.0,
                           torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{tag} launch failed: CUDA error {err}")

        times = {tag: [] for tag in fns}
        for _ in range(args.reps):
            for tag in fns:
                times[tag].append(cs.cuda_ms(lambda t=tag: launch(t), reps=10) * 1e3 / n_blocks)
        best = {tag: min(us) for tag, us in times.items()}
        bound_us = 1e6 * 4 * Xt.numel() / cs.PEAK_BYTES / n_blocks
        print(f"{n} rows x {n_blocks} blocks of 512 ({ctas} CTAs), us a block (X once at "
              f"{cs.PEAK_BYTES / 1e12:.2f} TB/s: {bound_us:.2f}): " + ", ".join(
                  f"{tag} {us:.2f}" for tag, us in best.items()) + f" [{card}]", flush=True)
        del Xt, hess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
