#!/usr/bin/env python3
"""The gblinear round kernel on one NVIDIA GPU: where its time goes, and its
time beside another tree's round kernel.

    python3 scripts/probe_gblinear_round.py [--shapes published,double,...] [--variants a,b] [--reps N] [--out DIR]
    python3 scripts/probe_gblinear_round.py --package smoke_tree/parent --package . --package . \\
        --package smoke_tree/parent [--shapes ...] [--reps N] [--out DIR]

Shapes (rows, blocks of 512 features): ``published`` 22,296 x 40 (the
one-tissue training call), ``double`` 44,592 x 40, ``tiny`` 132 x 40 (the
per-block cost that does not scale with the data), ``tiles_3`` 101,376 x
8, ``tiles_4`` 135,168 x 8, ``tiles_8`` 270,336 x 4 and ``tiles_16``
540,672 x 2 (the "shared" plan at 3, 4, 8 and 16 tiles a CTA), and one
block at the edges of three
"shared" plans: ``cap_8192`` 1,081,344 and ``cap_8192_plus`` 1,081,345
(8,192 rows a CTA: this kernel's cap, 32 tiles), ``cap_shared`` 3,799,356
and ``cap_streamed`` 3,799,357 (the last row of the "shared" plan of the
kernel this design replaced, and the first of its "streamed" plan),
``cap_smem`` 5,609,472 and ``cap_smem_plus`` 5,609,473 (the cap of the
``r_shared_smem`` variant on an H100: r's slice beside a ring of 3 slots).

Without ``--package``: the kernel's ptxas report (registers, spills) and
its SASS's local loads and stores; then variants of
``csrc/gblinear_round.cu`` built under ``build/probe_round/``, each a text
edit of the source (their results are wrong; only their times are read;
``--variants`` picks some, default all): ``ring_48k``, ``ring_80k`` and
``ring_112k`` (the ring's share of the slots at 1-2 tiles a CTA,
``RING_BYTES``: fewer cache slots), ``ring_tiles_40k`` and
``ring_tiles_112k`` (the same past 2 tiles, ``RING_BYTES_TILES``),
``r_shared_smem`` (the "shared" plan while r's slice leaves the
ring its slots, past 8,192 floats a CTA), ``no_polls`` (every cross-CTA
value read in one round, whatever its tag), ``no_A_math`` (the gradient's
products left out), ``no_C_global`` (the residual update's reads of the
streamed rows from global memory left out), ``stream_only`` (all three),
``no_tma`` (no copy issued: the consumers' own time), ``no_tma_no_wait``
(nor any wait for a stage), ``no_warp_sum`` and ``no_A_rows`` (the
gradient's shuffle sums, or its rows, left out), and ``timeline`` (the
last CTA's clock at each phase of each block and around block 1's pairs of
stages: cycles by phase, printed; also built on top of four variants).
Each shape times the kernel and each variant, in turns, by CUDA events,
best of ``--reps``: us a block.

With ``--package DIR`` (repeatable): each tree in its own process, in the
order given (parent, change, change, parent), times that tree's
``ops/gblinear_round.gblinear_round`` on its own ``_pad_blocks`` layout and
``round_scratch`` at each shape, and its ``gblinear_round_plain`` (the
plain round): ms a round by CUDA events, best of ``--reps``, the state
advancing round by round. Unpack the other tree with
``git archive`` into a git-ignored directory first. Prints one JSON line a
row and writes them all to ``DIR/probe_gblinear_round.json`` with ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = {"published": (22_296, 40), "double": (44_592, 40), "tiny": (132, 40), "tiles_3": (101_376, 8),
          "tiles_4": (135_168, 8),
          "tiles_8": (270_336, 4), "tiles_16": (540_672, 2), "cap_8192": (1_081_344, 1),
          "cap_8192_plus": (1_081_345, 1), "cap_shared": (3_799_356, 1), "cap_streamed": (3_799_357, 1),
          "cap_smem": (5_609_472, 1), "cap_smem_plus": (5_609_473, 1)}
B = 512
# (variant, [(text in csrc/gblinear_round.cu, its replacement, occurrences)])
NO_POLLS = ("    if (__all_sync(FULL, ready)) return", "    if (true) return", 2)
NO_A_MATH = ("            if (lane < q_n) acc[u] = dot4(x4[lane], r4[lane], acc[u]);\n"
             "            if (lane + 32 < q_n) acc[u] = dot4(x4[lane + 32], r4[lane + 32], acc[u]);\n", "", 1)
NO_C_GLOBAL = ("        for (; j >= j_lo; j -= p.groups, xj -= step) axpy4(dw_s[j], ldcg4(xj), acc);\n", "", 1)
NO_C_BATCH = ("for (; j - (C_BATCH - 1) * p.groups >= j_lo; j -= C_BATCH * p.groups) {",
              "for (; false; j -= C_BATCH * p.groups) {", 1)
TIMELINE = """
#define TL_AT(i) reinterpret_cast<long long*>((reinterpret_cast<uintptr_t>(dw_g + B) + 64) & ~uintptr_t(63))[i]
#define TL(k) if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1) TL_AT(b * 8 + (k)) = clock64();
#define SL_ON (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1 && b == 1)
#define SL(k) if (SL_ON) reinterpret_cast<long long*>(dw_s)[3 * s + (k)] = clock64();
#define SL_OUT if (SL_ON) for (int k = 0; k < 3 * p.NG; ++k) TL_AT(8 * p.n_blocks + k) = reinterpret_cast<long long*>(dw_s)[k];
"""
TIMELINE_PHASES = ("A", "B", "dw wait", "C")
TIMELINE_EDITS = [("using namespace hopper;\n", "using namespace hopper;\n" + TIMELINE, 1),
                  ("    const float* Xb = p.X + (size_t)b * B * p.ld + lo;\n",
                   "    const float* Xb = p.X + (size_t)b * B * p.ld + lo;\n    TL(0);\n", 1),
                  ("    // (B) each feature's gradient", "    TL(1);\n    SL_OUT;\n    // (B) each feature's gradient", 1),
                  ("    if (warp == 0) take_all(dw_g, B, tag_dw, dw_s, lane);", "    TL(2);\n    if (warp == 0) take_all(dw_g, B, tag_dw, dw_s, lane);", 1),
                  ("    for (int t = tiles - 1; t >= 0; --t) {", "    TL(3);\n    for (int t = tiles - 1; t >= 0; --t) {", 1),
                  ("      consumer_sync();\n    }\n    if (lane == 0 && tiles > 0)", "      consumer_sync();\n    }\n    TL(4);\n    if (lane == 0 && tiles > 0)", 1),
                  # and block 1's stages of (A): before the wait, after it, after the release (kept in
                  # shared memory until (A) ends: a global store would hold the next mbarrier arrival)
                  ("        const int n_st = s + 1 < p.NG ? 2 : 1;\n",
                   "        const int n_st = s + 1 < p.NG ? 2 : 1;\n        SL(0);\n", 1),
                  ("        for (int off = 16; off; off >>= 1) {  // the two shuffle sums, interleaved",
                   "        SL(1);\n        for (int off = 16; off; off >>= 1) {  // the two shuffle sums, interleaved", 1),
                  ("            if (lane == 0) mbar_arrive(empty0 + 8 * slot[u]);\n          }\n        }\n      }\n",
                   "            if (lane == 0) mbar_arrive(empty0 + 8 * slot[u]);\n          }\n        }\n        SL(2);\n      }\n", 1)]
VARIANTS = {"no_polls": [NO_POLLS], "no_A_math": [NO_A_MATH], "no_C_global": [NO_C_BATCH, NO_C_GLOBAL],
            "stream_only": [NO_POLLS, NO_A_MATH, NO_C_BATCH, NO_C_GLOBAL],
            # a producer that issues no copy (an arrival in its place): the consumers' own time
            "no_tma": [("            mbar_expect_tx(full0 + 8 * slot, bytes);\n"
                        "            tma_load_2d(smem_addr(stage0 + slot * slot_floats), &xmap, full0 + 8 * slot, lo + t * T,\n"
                        "                        b * B + s * p.FS);\n", "            mbar_arrive(full0 + 8 * slot);\n", 1),
                       ("          mbar_expect_tx(full0 + 8 * s, bytes);\n", "          mbar_arrive(full0 + 8 * s);\n"
                        "          continue;\n", 1)],
            # no copies and no waits for them: the consumers' loop alone (the producers still wait for
            # free slots, so nothing runs away)
            "no_tma_no_wait": [("            mbar_expect_tx(full0 + 8 * slot, bytes);\n"
                                "            tma_load_2d(smem_addr(stage0 + slot * slot_floats), &xmap, full0 + 8 * slot, lo + t * T,\n"
                                "                        b * B + s * p.FS);\n", "            mbar_arrive(full0 + 8 * slot);\n", 1),
                               ("          mbar_expect_tx(full0 + 8 * s, bytes);\n", "          mbar_arrive(full0 + 8 * s);\n"
                                "          continue;\n", 1),
                               ("          warp_wait(full0 + 8 * slot[u], (ring_stage[u] ? ring_use : b) & 1, lane);\n", "", 1)],
            # (A) without its shuffle sums; (A) without its rows (the waits and arrivals alone)
            "no_warp_sum": [("        for (int off = 16; off; off >>= 1) {  // the two shuffle sums, interleaved",
                             "        for (int off = 16; off && false; off >>= 1) {", 1)],
            "no_A_rows": [("          if (warp < B - (s + u) * p.FS) {  // feature row", "          if (false) {  // feature row", 1)],
            # the ring's share of the slots (the "shared" plan's 40 KB at 1-2 tiles a CTA, 80 KB past them:
            # the rest are cache slots)
            **{f"ring_{kb}k": [("constexpr int RING_BYTES = 40960;", f"constexpr int RING_BYTES = {1024 * kb};", 1)]
               for kb in (48, 80, 112)},
            **{f"ring_tiles_{kb}k": [("constexpr int RING_BYTES_TILES = 81920;",
                                      f"constexpr int RING_BYTES_TILES = {1024 * kb};", 1)] for kb in (40, 112)},
            # the "shared" plan while the slots beside r's whole slice hold the ring (past 8,192 floats)
            "r_shared_smem": [("  pl->streamed = static_cast<long long>(pl->tiles_max) * pl->T > R_SHARED;",
                               "  pl->streamed = (optin - static_cast<long long>(layout(pl->T, pl->FS, 0, B, "
                               "pl->groups, pl->tiles_max * pl->T).bytes)) / (slot_bytes(pl->T, pl->FS) + 16LL) < "
                               "(RING_BYTES + slot_bytes(pl->T, pl->FS) + 15LL) / (slot_bytes(pl->T, pl->FS) + 16LL);",
                               1)],
            # (C)'s feature groups (8 in the kernel: 11 at the published tile) and loads in flight (16)
            "groups_11": [("constexpr int GROUPS_MAX = 8;", "constexpr int GROUPS_MAX = 11;", 1)],
            "c_batch_12": [("constexpr int C_BATCH = 16;", "constexpr int C_BATCH = 12;", 1)],
            # the last CTA's thread 0 writes clock64() at each phase boundary of each block past the
            # scratch (read by variants_main): the kernel's results stay right
            "timeline": TIMELINE_EDITS}
VARIANTS.update({f"timeline+{tag}": TIMELINE_EDITS + VARIANTS[tag]
                 for tag in ("no_C_global", "no_polls", "no_tma", "no_tma_no_wait")})
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [ctypes.c_void_p]


def build_variants(variants: list[str] | None = None) -> dict:
    """{variant: its launcher}: the built kernel itself, and each variant of
    VARIANTS (or of ``variants``) compiled from an edited copy of
    csrc/gblinear_round.cu."""
    from expecto_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "gblinear_round.cu").read_text()
    out = REPO / "build" / "probe_round"
    out.mkdir(parents=True, exist_ok=True)
    for header in ("gblinear_cd.cuh", "hopper_common.cuh"):
        (out / header).write_text((cuda_build.CSRC_DIR / header).read_text())
    procs = {}
    for tag, edits in VARIANTS.items():
        if variants is not None and tag not in variants:
            continue
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"csrc/gblinear_round.cu no longer holds {count} x {old!r} ({tag})")
            text = text.replace(old, new)
        (out / f"{tag}.cu").write_text(text)
        cmd = [cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS, "-o", str(out / f"lib{tag}.so"), str(out / f"{tag}.cu")]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"kernel": cuda_build.load("gblinear_round")}
    for tag, proc in procs.items():
        log, _ = proc.communicate(timeout=cuda_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:  # a variant this toolkit refuses is left out, with its first error
            print(f"variant {tag} left out: nvcc failed: " + next((line for line in log.splitlines() if "error" in line),
                                                                  log[-300:]), flush=True)
            continue
        libs[tag] = ctypes.CDLL(str(out / f"lib{tag}.so"))
    fns = {}
    for tag, lib in libs.items():
        fn = lib.gblinear_round_launch
        fn.argtypes, fn.restype = LAUNCH_ARGTYPES, ctypes.c_int
        fns[tag] = fn
    return fns


def _inputs(pad_blocks, n: int, n_blocks: int, seed: int):
    """Seeded standard-normal feature blocks in the tree's own layout, their
    hessians, zero weights and bias, and r."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n_blocks * B, n), generator=gen, device="cuda")
    Xt, _ = pad_blocks(X, B)
    del X
    hess = torch.stack([torch.linalg.vector_norm(Xb, dim=1).square() for Xb in Xt])
    r = torch.randn(n, generator=gen, device="cuda")
    return Xt, hess, r


def variants_main(shapes: list[str], reps: int, card: str, variants: list[str] | None = None) -> list[dict]:
    import torch

    import chip_smoke as cs
    from expecto_tpu_torch.models.gblinear import _pad_blocks
    from expecto_tpu_torch.ops import cuda_build
    from expecto_tpu_torch.ops import gblinear_round as gr

    report = cuda_build.ptxas_report("gblinear_round")
    cuda_build.load("gblinear_round")  # built: its SASS is read from the library
    sass = {op: cuda_build.sass_count("gblinear_round", op) for op in ("LDL", "STL")}
    print("ptxas:", " | ".join(line.strip() for line in report.splitlines() if "gblinear_round_kernel" in line
                               or "registers" in line or "spill" in line), flush=True)
    print(f"SASS local loads {sass['LDL']}, local stores {sass['STL']}", flush=True)
    fns = build_variants(variants)
    rows = [{"ptxas": report, "sass": sass, "card": card}]
    for shape in shapes:
        n, n_blocks = SHAPES[shape]
        Xt, hess, r0 = _inputs(_pad_blocks, n, n_blocks, seed=n)
        g = gr.device_geometry(0, n, B)
        w, bias, r = torch.zeros((n_blocks, B), device="cuda"), torch.zeros(1, device="cuda"), r0.clone()
        room = gr.scratch_floats(g.ctas, B) + 32 + 16 * n_blocks + 8 * g.stages  # and the timeline's clocks
        scratch = torch.zeros(room + room % 2, device="cuda")

        def launch(tag):
            err = fns[tag](Xt.data_ptr(), hess.data_ptr(), w.data_ptr(), bias.data_ptr(), r.data_ptr(),
                           scratch.data_ptr(), n_blocks, B, n, Xt.stride(1), g.ctas, gr._tags(scratch, n_blocks),
                           float(n), 0.01, 100.0, 0.0, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{tag} launch failed: CUDA error {err}")

        runs = [tag for tag in fns if not tag.startswith("timeline")]
        times = {run: [] for run in runs}
        for rep in range(reps):
            for run in (runs if rep % 2 == 0 else runs[::-1]):
                times[run].append(cs.cuda_ms(lambda run=run: launch(run), reps=5 if n > 10**6 else 10, warmup=1))
        us = {tag: 1e3 * min(t) / n_blocks for tag, t in times.items()}
        cycles = {}  # the last CTA's cycles a block by phase, by timeline build
        for tag in [t for t in fns if t.startswith("timeline")]:
            launch(tag)
            torch.cuda.synchronize()
            at = (scratch.data_ptr() + 4 * gr.scratch_floats(g.ctas, B) + 64) & ~63  # as TL's address
            stamps = scratch.view(torch.int64)[(at - scratch.data_ptr()) // 8:][:8 * n_blocks]
            stamps = stamps.view(n_blocks, 8)[:, :5].double()
            cycles[tag] = dict(zip(TIMELINE_PHASES, stamps.diff(dim=1).mean(0).cpu().tolist()))
            cycles[tag]["block"] = float(stamps[1:, 0].diff().mean()) if n_blocks > 2 else 0.0
            if n_blocks > 1:  # block 1's pairs of stages: their waits and loads, the rest; cycles
                st = scratch.view(torch.int64)[(at - scratch.data_ptr()) // 8 + 8 * n_blocks:][:3 * g.stages]
                st = st.view(g.stages, 3)[::2].double()
                waits, rest = (st[:, 1] - st[:, 0]).cpu().tolist(), (st[:, 2] - st[:, 1]).cpu().tolist()
                cycles[tag + " pairs"] = {"wait": waits, "rest": rest}
                print(f"  block 1's pairs of stages, waits and loads / the rest, cycles: " + " ".join(
                    f"{a:.0f}/{z:.0f}" for a, z in zip(waits, rest)), flush=True)
            print(f"{shape} {tag}: the last CTA's cycles a block " + ", ".join(f"{k} {v:.0f}" for k, v in
                                                                             cycles[tag].items()), flush=True)
        bound_us = 1e6 * 4 * n_blocks * B * n / cs.PEAK_BYTES / n_blocks
        row = {"shape": shape, "n": n, "n_blocks": n_blocks, "geometry": g._asdict(), "us_a_block": us,
               "cta0_cycles_a_block": cycles,
               "bound_us_a_block": bound_us, "card": card}
        rows.append(row)
        print(f"{shape}: {n} rows x {n_blocks} blocks of {B} ({g.ctas} CTAs, tile {g.tile} x {g.tiles_max}, "
              f"{g.slots} slots, plan cache {g.cache}, {'streamed' if g.streamed else 'shared'}), us a block "
              f"(X once at {cs.PEAK_BYTES / 1e12:.2f} TB/s: {bound_us:.2f}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in us.items()) + f" [{card}]", flush=True)
        del Xt, hess, w, r, r0
        torch.cuda.empty_cache()
    return rows


def round_worker(package: str, shapes: list[str], reps: int) -> list[dict]:
    """ms a round of ``package``'s round kernel at each shape."""
    sys.path.insert(0, str(Path(package).resolve()))
    import torch

    from expecto_tpu_torch.models.gblinear import _pad_blocks
    from expecto_tpu_torch.ops import gblinear_round as gr

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    rows = []
    for shape in shapes:
        n, n_blocks = SHAPES[shape]
        Xt, hess, r = _inputs(_pad_blocks, n, n_blocks, seed=n)
        w, bias = torch.zeros((n_blocks, B), device="cuda"), torch.zeros(1, device="cuda")
        scratch = gr.round_scratch(Xt)
        gr.reset_launch_counts()
        times = [cs.cuda_ms(lambda: gr.gblinear_round(Xt, hess, w, bias, r, scratch, float(n), 0.01, 100.0, 0.0),
                            reps=3 if n > 10**6 else 20, warmup=1) for _ in range(reps)]
        if not bool(torch.isfinite(w).all() and torch.isfinite(r).all()) or gr.gblinear_round.launches == 0:
            raise AssertionError(f"{package}: non-finite state or no kernel launch at {shape}")
        plain = [cs.cuda_ms(lambda: gr.gblinear_round_plain(Xt, hess, w, bias, r, None, float(n), 0.01, 100.0, 0.0),
                            reps=3 if n > 10**6 else 5, warmup=1) for _ in range(reps)]
        rows.append({"package": package, "shape": shape, "n": n, "n_blocks": n_blocks, "ms": min(times),
                     "times_ms": times, "plain_ms": min(plain), "plan": gr.round_plan(0, n, B),
                     "bound_ms": 1e3 * 4 * Xt.numel() / cs.PEAK_BYTES})
        del Xt, hess, w, r, scratch
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--package", action="append", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants to build and time beside the kernel (default: all; 'none')")
    ap.add_argument("--out", default=None)
    ap.add_argument("--round-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = args.shapes.split(",")
    if args.round_worker:
        for row in round_worker(args.round_worker, shapes, args.reps):
            print(json.dumps(row), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("probe_gblinear_round: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    rows = []
    if args.package:
        for package in args.package:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--round-worker", package, "--shapes", args.shapes,
                   "--reps", str(args.reps)]
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=1800, check=True, cwd=REPO).stdout
            for line in out.splitlines():
                row = {**json.loads(line), "card": card}
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items() if k != "times_ms"}), flush=True)
    else:
        rows = variants_main(shapes, args.reps, card, None if args.variants is None else
                             [v for v in args.variants.split(",") if v in VARIANTS])
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "probe_gblinear_round.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
