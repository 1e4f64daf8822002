#!/usr/bin/env python3
"""The fp32 conv8_relu kernels at every conv1-conv5 shape of the flows, on one NVIDIA GPU.

    python3 scripts/probe_conv8_tf32x3.py [--cases serve,gene,backbone,patch40,patch384] [--reps N]
                                          [--no-simt] [--variant pool_atomic] [--out DIR]

For each case (chip_smoke.py's shapes: the serving chunk of 227 spans of
3,600 bp and its patch sub-span, the gene chunk of 16 spans of 41,800, the
consensus backbone of one 41,808-bp span and the patch batches of N·K = 40
and 384 sub-spans of 704), every conv1-conv5 launch (conv1 and conv3
pooled, as the flows launch them) on seeded fp32 inputs at Beluga's widths:

- the tf32x3 kernel (``csrc/conv8_relu_tf32x3.cu``, the route fp32 takes)
  held against the fp32 plain version within chip_smoke.py's FP32_ATOL /
  FP32_RTOL and against a float64 product within FP32_F64_REL of max|y|, a
  limit that one TF32 pass (the plain version in float64 on the operands
  rounded to TF32: the planted fault) must miss; a second call equal bit
  for bit; a pooled launch equal to the unpooled one followed by
  ``ops/spans._pool4_from``;
- timed (CUDA events, best of ``--reps``) beside the SIMT kernel (route
  "simt"), the plain version and ``F.conv1d`` with TF32 off (then
  ``F.max_pool1d`` when pooled), with the FFMA bound (one pass at 67
  TFLOP/s) and the 3xTF32 bound (three passes at 495 TFLOP/s); where
  ``ops/conv8.py::tf32x3_splits`` splits K, also the same kernel with K
  whole (``whole_ms``), the yardstick of the split rule.

``--variant pool_atomic`` builds a copy of the kernel's source under
``build/probe_tf32x3/`` with the SIMT kernel's pooling rule (tiles stepping
128 rows, a group across a tile edge merged by atomicMax into zero-filled
outputs, the zero fill timed with it) and times it beside the kernel at the
pooled shapes (same checks against the plain version). Prints one line a
shape and each case's launch-weighted totals; ``--out DIR`` writes them as
JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FP32_F64_REL = 1e-5

# csrc/conv8_relu.cu's pooling rule in the tf32x3 kernel's epilogue: every
# group with a row in the 128-row tile, a whole one stored, one across a tile
# edge merged by atomicMax on zero-filled outputs (ReLU outputs >= +0 order
# as their bits)
POOL_ATOMIC = r"""__device__ __forceinline__ void store_pooled(const float* tile, const Outputs& out, long long m0, int M, int L,
                                             int Cout) {
  constexpr int PIECES = BN / 4;
  const int l_out = L - KW + 1;
  for (int it = threadIdx.x; it < (TM + POOL_W - 1) * PIECES; it += CONSUMER_THREADS) {
    const int i = it / PIECES - (POOL_W - 1), q = it % PIECES, c = blockIdx.y * BN + 4 * q;
    const long long m = m0 + i;
    if (m < 0 || m >= M || c >= Cout) continue;
    const int n = (int)(m / L), l = (int)(m - (long long)n * L);
    const int ph = l % POOL_W, j = l / POOL_W, frames = (l_out - ph) / POOL_W;
    if (!((out.mask >> ph) & 1) || j >= frames) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < POOL_W; ++r) {
      if (i + r < 0 || i + r >= TM) continue;
      const float* src = tile + (i + r) * POOL_LD + 4 * q;
      for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], src[e]);
    }
    float* dst = out.y[ph] + ((size_t)n * frames + j) * Cout + c;
    const bool whole = i >= 0 && i + POOL_W <= TM;
    for (int e = 0; e < 4 && c + e < Cout; ++e) {
      if (whole) dst[e] = v[e];
      else atomicMax(reinterpret_cast<int*>(dst + e), __float_as_int(v[e]));
    }
  }
}
"""
VARIANTS = {"pool_atomic": [("(long long)blockIdx.x * (MODE == POOL ? TM - POOL_W : TM)", "(long long)blockIdx.x * TM"),
                           ("const int step = MODE == POOL ? TM - POOL_W : TM;", "const int step = TM;"),
                           ("STORE_POOLED", POOL_ATOMIC)]}


def build_variants(tags: list[str]) -> dict:
    """{tag: (plain launcher, pooled launcher)} built from csrc/conv8_relu_tf32x3.cu
    with each named variant's replacements (VARIANTS)."""
    from expecto_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "conv8_relu_tf32x3.cu").read_text()
    subs = {tag: VARIANTS[tag] for tag in tags}
    out = REPO / "build" / "probe_tf32x3"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, pairs in subs.items():
        text = src
        for old, new in pairs:
            if old == "STORE_POOLED":  # the whole function
                start = text.index("__device__ __forceinline__ void store_pooled(")
                old = text[start : text.index("\n}\n", start) + 3]
            if old not in text:
                raise RuntimeError(f"variant {tag}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / f"{tag}.cu").write_text(text)
        cmd = [cuda_build._tool("nvcc"), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC_DIR), "-Xptxas", "-v",
               "-o", str(out / f"lib{tag}.so"), str(out / f"{tag}.cu")]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate(timeout=cuda_build.NVCC_TIMEOUT_S)
        print(f"variant {tag} ptxas: " + " | ".join(line.strip() for line in log.splitlines()
                                                   if "registers" in line or "spill" in line), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {tag}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{tag}.so"))
        plain, pooled = lib.conv8_relu_tf32x3_launch, lib.conv8_relu_tf32x3_pool4_launch
        plain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        pooled.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        plain.restype = pooled.restype = ctypes.c_int
        fns[tag] = (plain, pooled)
    return fns


def cases(names: list[str]) -> list[tuple[str, int, Counter]]:
    """(case, spans, {(layer, L, pool phases): launches}) of chip_smoke.py's shapes."""
    import chip_smoke as cs
    from expecto_tpu_torch.ops.spans import PATCH_SUB_LEN

    table = {"serve": (cs.CHUNK, cs.chunk_launches()), "gene": (cs.GENE_ROWS, cs.gene_chunk_launches()),
             **{f"h5_{n}": (n, cs.h5_chunk_launches()) for n in cs.H5_CHUNK_N},
             "windows": (cs.CONS_BATCH, cs.consensus_kernel_launches(2000, (0,))),
             "backbone": (1, cs.consensus_kernel_launches(cs.CONS_SPAN)),
             "patch40": (40, cs.consensus_kernel_launches(PATCH_SUB_LEN)),
             "patch384": (384, cs.consensus_kernel_launches(PATCH_SUB_LEN))}
    return [(name, *table[name]) for name in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="serve,gene,backbone,patch40,patch384",
                    help="of serve, gene, backbone, patch40, patch384, h5_112, h5_64, windows")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variant", action="append", default=[], choices=("pool_atomic",))
    ap.add_argument("--no-simt", action="store_true", help="skip the SIMT kernel's times")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_conv8_tf32x3: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops import cuda_build, spans
    from expecto_tpu_torch.ops.conv8 import (_packed, _route, _tf32x3_parts, conv8_relu, conv8_relu_plain,
                                             conv8_relu_pool4)
    from expecto_tpu_torch.ops.fc1 import split_tf32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    built = cuda_build.build(["conv8_relu_tf32x3", "conv8_relu"], ptxas_info=True)
    for name, (secs, log) in built.items():
        print(f"built {name} in {secs:.1f} s: " + " | ".join(line.strip() for line in log.splitlines()
                                                            if "registers" in line or "spill" in line), flush=True)
    print(f"conv8_relu_tf32x3 SASS: {cuda_build.sass_count('conv8_relu_tf32x3', 'HGMMA')} HGMMA", flush=True)
    variants = build_variants(args.variant) if args.variant else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def best(fn) -> float:
        return min(cs.cuda_ms(fn) for _ in range(args.reps))

    def variant_call(fns, x, w, b, pool, zero=False, whole=False):
        n, l, cin = x.shape
        cout, l_out = w.shape[2], l - 7
        splits, ws = (1, None) if whole else _tf32x3_parts(x, cout)
        wsp = 0 if ws is None else ws.data_ptr()
        stream = torch.cuda.current_stream().cuda_stream
        wp = _packed(w, "tf32x3").data_ptr()
        if not pool:
            y = torch.empty((n, l_out, cout), device=dev)
            err = fns[0](x.data_ptr(), wp, b.data_ptr(), y.data_ptr(), wsp, n, l, cin, cout, splits, stream)
        else:
            make = torch.zeros if zero else torch.empty
            y = {ph: make((n, (l_out - ph) // 4, cout), device=dev) for ph in pool}
            ys = [y[ph].data_ptr() if ph in y else 0 for ph in range(4)]
            err = fns[1](x.data_ptr(), wp, b.data_ptr(), *ys, wsp, n, l, cin, cout, splits,
                         sum(1 << ph for ph in pool), stream)
        if err:
            raise RuntimeError(f"variant launch failed: {err}")
        return y

    specs = {f"conv{i}": (cin, cout) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    report = []
    for case, n, launches in cases(args.cases.split(",")):
        tot = Counter()
        for (name, length, pool), per in sorted(launches.items(), key=lambda kv: (kv[0][0], -kv[0][1])):
            if name == "conv0":
                continue
            cin, cout = specs[name]
            x = torch.randn((n, length, cin), generator=gen, device=dev)
            w = torch.randn((8, cin, cout), generator=gen, device=dev) / (8 * cin) ** 0.5
            b = torch.randn((cout,), generator=gen, device=dev) * 0.1
            assert _route("cuda", x.dtype, cin, x.data_ptr()) == "tf32x3"
            l_out = length - 7
            what = f"{case} {name} N={n} L={length} {cin}->{cout} pool {list(pool)}"
            y = conv8_relu(x, w, b)
            if not torch.equal(y, conv8_relu(x, w, b)):
                raise AssertionError(f"{what}: a second call differs")
            y64 = conv8_relu_plain(x.double(), w.double(), b.double())
            scale = float(y64.abs().max())
            f64_err = float((y - y64).abs().max()) / scale
            hx, hw = split_tf32(x)[0], split_tf32(w)[0]
            one_pass = float((conv8_relu_plain(hx.double(), hw.double(), b.double()) - y64).abs().max()) / scale
            del hx, hw
            plain_err = cs._check_close(y, conv8_relu_plain(x, w, b), cs.FP32_ATOL, cs.FP32_RTOL, what)
            if f64_err > FP32_F64_REL or one_pass <= FP32_F64_REL:
                raise AssertionError(f"{what}: float64 gap {f64_err:.3g}, one TF32 pass {one_pass:.3g} "
                                     f"(limit {FP32_F64_REL})")
            del y64
            if pool:
                got = conv8_relu_pool4(x, w, b, pool)
                for ph in pool:
                    if not torch.equal(got[ph], spans._pool4_from(y, ph)):
                        raise AssertionError(f"{what}: phase {ph} differs from the unpooled kernel + pool")
                launch = lambda: conv8_relu_pool4(x, w, b, pool)  # noqa: E731
                simt = lambda: conv8_relu_pool4(x, w, b, pool, route="simt")  # noqa: E731
                plain = lambda: [spans._pool4_from(conv8_relu_plain(x, w, b), ph) for ph in pool]  # noqa: E731
            else:
                launch = lambda: conv8_relu(x, w, b)  # noqa: E731
                simt = lambda: conv8_relu(x, w, b, route="simt")  # noqa: E731
                plain = lambda: conv8_relu_plain(x, w, b)  # noqa: E731
            del y
            xt, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()

            def library():
                yc = F.relu(F.conv1d(xt, wt, b))
                return [F.max_pool1d(yc[:, :, ph:], 4) for ph in pool] if pool else yc

            ops = 2.0 * n * l_out * cin * cout * 8
            row = {"case": case, "layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "pool": list(pool),
                   "launches": per, "splits": _tf32x3_parts(x, cout)[0], "max_abs_err": plain_err,
                   "f64_rel": f64_err, "one_pass_rel": one_pass, "ms": best(launch),
                   "simt_ms": None if args.no_simt else best(simt), "plain_ms": best(plain),
                   "library_ms": best(library), "ffma_bound_ms": 1e3 * ops / cs.PEAK_FLOPS["fp32"],
                   "tf32x3_bound_ms": 1e3 * 3 * ops / cs.PEAK_FLOPS["tf32"]}
            if row["splits"] > 1:
                fns = (cuda_build.launcher("conv8_relu_tf32x3", 5, n_ptrs=5),
                       cuda_build.launcher("conv8_relu_tf32x3", 6, n_ptrs=8, entry="conv8_relu_tf32x3_pool4_launch"))
                got = variant_call(fns, x, w, b, pool, whole=True)
                want = conv8_relu_pool4(x, w, b, pool) if pool else conv8_relu(x, w, b)
                for ph in (pool or [None]):
                    g, t = (got[ph], want[ph]) if pool else (got, want)
                    cs._check_close(g, t, cs.FP32_ATOL, cs.FP32_RTOL, f"{what} with K whole")
                row["whole_ms"] = best(lambda fns=fns: variant_call(fns, x, w, b, pool, whole=True))
            for tag, fns in variants.items():
                zero = tag == "pool_atomic"
                if zero and not pool:
                    continue
                got = variant_call(fns, x, w, b, pool, zero)
                want = conv8_relu_pool4(x, w, b, pool) if pool else conv8_relu(x, w, b)
                for ph in (pool or [None]):
                    g, t = (got[ph], want[ph]) if pool else (got, want)
                    if not torch.equal(g, t):
                        cs._check_close(g, t, cs.FP32_ATOL, cs.FP32_RTOL, f"{what} variant {tag}")
                row[f"{tag}_ms"] = best(lambda fns=fns, zero=zero: variant_call(fns, x, w, b, pool, zero))
            del xt, wt, x, w, b
            torch.cuda.empty_cache()
            report.append(row)
            tot["whole_ms"] += per * row.get("whole_ms", row["ms"])
            for key in ("ms", "simt_ms", "plain_ms", "library_ms", "ffma_bound_ms", "tf32x3_bound_ms",
                        *(f"{t}_ms" for t in variants)):
                if row.get(key) is not None:
                    tot[key] += per * row[key]
            if pool:
                tot["pooled_ms"] += per * row["ms"]
            extra = "".join(f" {t} {row[f'{t}_ms']:.3f}" for t in ("whole", *variants) if f"{t}_ms" in row)
            simt_txt = "n/a" if row["simt_ms"] is None else f"{row['simt_ms']:.3f}"
            print(f"{what} x{per} splits {row['splits']}: tf32x3 {row['ms']:.3f} ms{extra} simt {simt_txt} "
                  f"conv1d {row['library_ms']:.3f} plain {row['plain_ms']:.3f}; bounds ffma "
                  f"{row['ffma_bound_ms']:.3f} 3xtf32 {row['tf32x3_bound_ms']:.3f} "
                  f"({100 * row['tf32x3_bound_ms'] / row['ms']:.1f} %); err {plain_err:.3g}, f64 {f64_err:.3g}, one pass "
                  f"{one_pass:.3g}", flush=True)
        print(f"case {case} totals (launch-weighted ms): " + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()) +
              f"; tf32x3 at {100 * tot['tf32x3_bound_ms'] / tot['ms']:.1f} % of its 3xTF32 bound", flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "probe_conv8_tf32x3.json").write_text(json.dumps({"card": card, "rows": report}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
