#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (expecto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Phases (any failure raises, and the script exits non-zero with no result):

1. card: name and power limit as nvidia-smi reports them;
2. build: nvcc compiles every kernel of ``expecto_tpu_torch/csrc`` for
   sm_90a, one process per source, all at once;
3. kernels: ``conv8_relu`` at every shape it runs in one substitution chunk
   of the main path (227 variants; maxshift 800: the six Beluga layers over
   the 3,600-bp span and over the alt allele's patch sub-span) in fp32 and
   bf16, held against its plain PyTorch version on the same inputs, and
   timed beside the plain version and cuDNN's ``F.conv1d`` (a yardstick
   only: the port never calls it);
4. main path: ``python -m expecto_tpu_torch.cli.score`` (its ``main``) at
   Beluga's published widths with seeded random weights, 218 seeded tissue
   models, maxshift 800, default bf16 compute and fp16 wire, on ~1,024
   substitutions, ~128 indels and 4 contig-edge rows of a seeded genome;
   launch counts are zeroed just before and read just after; then warm
   repeats of the same serving call give the throughput;
5. parity: a few of those variants scored with ``--fp32`` on the card and on
   the CPU (plain path), REF/ALT/SED compared.

The line before the last is the card's name and power limit; the line before
that is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--out DIR`` also writes the full report
to ``DIR/chip_smoke.json``. Inputs and built kernels go under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

MAXSHIFT = 800
SPAN_LEN = 2 * MAXSHIFT + 2000
BATCH = 2048  # the score CLI's default --batchsize
CHUNK = BATCH // 9  # spans per substitution chunk at 9 shift offsets
N_MODELS = 218
N_SUBS, N_INDELS = 1024, 128
CONTIG_LEN = 300_000
DEVICE = "cuda"

# kernel tolerances against the plain version on identical inputs:
#  fp32: both sum up to 5,120 fp32 products in different orders (TF32 off)
#  bf16: the kernel reads the same bf16 values and sums in fp32, then rounds
#        its output to bf16 (relative step 2^-8); the plain reference is the
#        fp32 plain version on those bf16 values upcast
FP32_ATOL, FP32_RTOL = 1e-4, 1e-4
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2

# fp32 end-to-end parity, card vs CPU: REF/ALT rtol 1e-4; SED differences two
# separately rounded 20,020-term fp32 products, so its absolute noise scales
# with |REF| (tests/torch_port_common.sed_atol)
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_stack(span_len: int, phases) -> list[tuple[str, int]]:
    """(layer, input length) of each conv8_relu launch of
    ops/spans.conv6_phases over spans of ``span_len`` bases: conv0..conv3
    once, conv4/conv5 once per pool-2 phase."""
    launches, length = [], span_len
    for i in range(4):
        launches.append((f"conv{i}", length))
        length -= 7
        if i == 1:
            length //= 4  # pool1
    for ph in sorted(phases):
        l4 = (length - ph) // 4  # pool2 from this phase
        launches += [("conv4", l4), ("conv5", l4 - 7)]
    return launches


def chunk_launches() -> Counter:
    """{(layer, L): launches} of one substitution chunk of the main path
    (parallel/runner._preds_from_ref): the ref conv stack over the full
    span, forward and reverse complement, and the alt allele's patch
    sub-span (ops/spans.conv6_phases_patch), forward and reverse complement."""
    from expecto_tpu_torch.genome.windows import variant_shifts
    from expecto_tpu_torch.ops.spans import conv6_patch_ranges, conv6_patch_subspan

    offsets = [s + MAXSHIFT for s in variant_shifts(MAXSHIFT)]
    mutpos = MAXSHIFT + 999  # pipeline/sed.py: maxshift + inputsize // 2 - 1
    tally = Counter()
    for offs, mut in ((offsets, mutpos), ([2 * MAXSHIFT - o for o in offsets], SPAN_LEN - mutpos - 1)):
        phases = sorted({(o // 4) % 4 for o in offs})
        full = conv_stack(SPAN_LEN, phases)
        frames = dict(zip(phases, (length - 7 for name, length in full if name == "conv5")))
        s0, s1 = conv6_patch_subspan(conv6_patch_ranges(mut, 1, phases, frames), SPAN_LEN)
        tally.update(full + conv_stack(s1 - s0, phases))
    return tally


def kernel_phase(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from expecto_tpu_torch.models.beluga import CONV_SPECS
    from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = {f"conv{i}": (cin, cout) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    rows, n = [], CHUNK
    for (name, length), per_chunk in sorted(chunk_launches().items(), key=lambda kv: (kv[0][0], -kv[0][1])):
        cin, cout = specs[name]
        x32 = torch.randn((n, length, cin), generator=gen, device=dev)
        if cin == 4:  # conv0 reads one-hot bases
            x32 = torch.eye(5, 4, device=dev)[torch.randint(0, 5, (n, length), generator=gen, device=dev)]
        w32 = torch.randn((8, cin, cout), generator=gen, device=dev) / (8 * cin) ** 0.5
        b32 = torch.randn((cout,), generator=gen, device=dev) * 0.1
        l_out = length - 7
        flops = 2.0 * n * l_out * cin * cout * 8
        row = {"layer": name, "N": n, "L": length, "Cin": cin, "Cout": cout, "launches_per_chunk": per_chunk}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
            y = conv8_relu(x, w, b)
            torch.cuda.synchronize()
            want = conv8_relu_plain(x.float(), w.float(), b.float())
            err = (y.float() - want).abs()
            atol, rtol = (FP32_ATOL, FP32_RTOL) if tag == "fp32" else (BF16_ATOL, BF16_RTOL)
            ok = bool((err <= atol + rtol * want.abs()).all())
            max_err = float(err.max())
            if not ok:
                raise AssertionError(f"conv8_relu {tag} {name} disagrees with the plain version: max |err| {max_err}")
            del y, want, err
            xt = x.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).contiguous()  # (Cout, Cin, 8)
            size = x.element_size()
            nbytes = (x.numel() + w.numel() + b.numel() + n * l_out * cout) * size
            row[tag] = {
                "max_abs_err": max_err,
                "ms": cuda_ms(lambda: conv8_relu(x, w, b)),
                "plain_ms": cuda_ms(lambda: conv8_relu_plain(x, w, b)),
                "library_ms": cuda_ms(lambda: F.relu(F.conv1d(xt, wt, b))),
                "bytes_ms": 1e3 * nbytes / PEAK_BYTES,
                "ops_ms": 1e3 * flops / PEAK_FLOPS[tag],
                "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[tag]),
                "bound_by": "bytes" if nbytes / PEAK_BYTES > flops / PEAK_FLOPS[tag] else "operations",
            }
            del x, w, b, xt, wt
        log(f"kernel conv8_relu {name} N={n} L={length} {cin}->{cout} x{per_chunk} per chunk: "
            + "; ".join(f"{t} err {row[t]['max_abs_err']:.3g} kernel {row[t]['ms']:.3f} ms plain {row[t]['plain_ms']:.3f} ms "
                        f"conv1d {row[t]['library_ms']:.3f} ms bound {row[t]['bound_ms']:.3f} ms ({row[t]['bound_by']})"
                        for t in ("fp32", "bf16")))
        rows.append(row)
        torch.cuda.empty_cache()
    report["conv8_layers"] = rows


def make_inputs(seed: int) -> dict:
    """Seeded genome, VCF, closest-gene table, 218 gblinear models and
    full-width Beluga weights under build/chip_smoke."""
    import numpy as np

    from expecto_tpu_torch.genome.fasta import write_fasta
    from expecto_tpu_torch.io.xgb import save_xgb07_binary
    from expecto_tpu_torch.models.beluga import CONV_SPECS, FC1_IN, FC1_OUT, FC2_OUT
    from expecto_tpu_torch.models.convert import save_params_npz
    from expecto_tpu_torch.models.gblinear import GBLinearModel

    rng = np.random.default_rng(seed)
    WORK.mkdir(parents=True, exist_ok=True)
    bases = np.frombuffer(b"ACGT", np.uint8)
    contigs = {}
    for name in ("chr1", "chr2"):
        seq = bases[rng.integers(0, 4, CONTIG_LEN)]
        for start in rng.integers(2000, CONTIG_LEN - 2000, 6):  # a few N runs
            seq[start : start + int(rng.integers(20, 400))] = ord("N")
        contigs[name] = seq.tobytes().decode()
    write_fasta(WORK / "genome.fa", contigs)

    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    # one variant per site (the gene table repeats rows per variant key)
    sites = rng.choice(2 * (CONTIG_LEN - 6000), N_SUBS + N_INDELS, replace=False)
    variants = []
    for i, site in enumerate(sites):
        kind = "sub" if i < N_SUBS else "indel"
        chrom = ("chr1", "chr2")[int(site) % 2]
        pos = 3000 + int(site) // 2
        seq = contigs[chrom]
        if kind == "sub":
            ref = seq[pos - 1]
            alt = comp.get(ref, "A")
        elif rng.random() < 0.5:  # insertion of 1-20 bp
            ref = seq[pos - 1]
            alt = ref + "".join(rng.choice(list("ACGT"), int(rng.integers(1, 21))))
        else:  # deletion of 1-20 bp
            ref = seq[pos - 1 : pos + int(rng.integers(1, 21))]
            alt = seq[pos - 1]
        variants.append((chrom, pos, ref, alt))
    for chrom, pos in (("chr1", 700), ("chr2", 1500), ("chr1", CONTIG_LEN - 600), ("chr2", CONTIG_LEN - 1300)):
        ref = contigs[chrom][pos - 1]
        variants.append((chrom, pos, ref, comp.get(ref, "A")))  # contig-edge rows: per-window fallback

    vcf_lines, gene_lines = [], []
    for chrom, pos, ref, alt in variants:
        vcf_lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}")
        for g in range(int(rng.integers(1, 4))):
            tss = pos + int(rng.integers(-20000, 20000))
            strand = "+" if rng.random() < 0.5 else "-"
            gene_lines.append(f"{chrom[3:]}\t{pos - 1}\t{pos}\t{ref}\t{alt}\t{chrom[3:]}\t{tss - 1}\t{tss}\t{strand}"
                              f"\tENSG{pos:08d}{g}\t{tss - pos}")
    (WORK / "variants.vcf").write_text("\n".join(vcf_lines) + "\n")
    (WORK / "genes.tsv").write_text("\n".join(gene_lines) + "\n")

    model_dir = WORK / "models"
    model_dir.mkdir(exist_ok=True)
    modellist = ["ModelName\tTissue"]
    for j in range(N_MODELS):
        w = (rng.standard_normal(10 * 2002) * 0.02).astype(np.float32)
        path = model_dir / f"tissue{j:03d}.save"
        save_xgb07_binary(GBLinearModel(weight=w, bias=float(rng.normal(0, 0.1)), base_score=2.0), path)
        modellist.append(f"{path}\tTissue{j:03d}")
    (WORK / "modellist").write_text("\n".join(modellist) + "\n")

    def layer(shape, fan_in):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in))
        return {"w": w, "b": (rng.standard_normal(shape[-1]) * 0.05).astype(np.float32)}

    params = {f"conv{i}": layer((8, cin, cout), 8 * cin) for i, (_w, cin, cout) in enumerate(CONV_SPECS)}
    params["fc1"] = layer((FC1_IN, FC1_OUT), FC1_IN)
    params["fc2"] = layer((FC1_OUT, FC2_OUT), FC1_OUT)
    save_params_npz(params, WORK / "beluga.npz")
    return {"variants": variants, "n_rows": len(gene_lines)}


def score_args(vcf: Path, genes: Path, *extra: str) -> list[str]:
    return [str(vcf), "--geneFile", str(genes), "--modelList", str(WORK / "modellist"),
            "--genome", str(WORK / "genome.fa"), "--beluga_weights", str(WORK / "beluga.npz"),
            "--maxshift", str(MAXSHIFT), "--device", DEVICE, *extra]


def check_output(csv: Path, n_rows: int):
    import numpy as np
    import pandas as pd

    df = pd.read_csv(csv)
    names = [f"Tissue{j:03d}" for j in range(N_MODELS)]
    if df.shape != (n_rows, 8 + 3 * N_MODELS):
        raise AssertionError(f"{csv.name}: shape {df.shape}, expected {(n_rows, 8 + 3 * N_MODELS)}")
    ref = df[[f"REF_{m}" for m in names]].to_numpy(np.float64)
    alt = df[[f"ALT_{m}" for m in names]].to_numpy(np.float64)
    sed = df[names].to_numpy(np.float64)
    if not (np.isfinite(ref).all() and np.isfinite(alt).all() and np.isfinite(sed).all()):
        raise AssertionError(f"{csv.name}: non-finite values")
    # ALT is rebuilt as REF + SED in fp32 on the host
    gap = float(np.abs(sed - (alt - ref)).max())
    if gap > 1e-5 * max(1.0, float(np.abs(alt).max())):
        raise AssertionError(f"{csv.name}: SED != ALT - REF (max gap {gap})")
    return df, ref, alt, sed


def main_path_phase(report: dict, inputs: dict, card: str) -> None:
    import numpy as np
    import torch

    from expecto_tpu_torch.cli.score import main as score_main
    from expecto_tpu_torch.ops.conv8 import conv8_relu

    out_csv = WORK / "output.csv"
    torch.cuda.reset_peak_memory_stats()
    conv8_relu.launches = 0
    t0 = time.perf_counter()
    rc = score_main(score_args(WORK / "variants.vcf", WORK / "genes.tsv", "--output", str(out_csv)))
    wall = time.perf_counter() - t0
    launches = conv8_relu.launches
    if rc != 0:
        raise AssertionError(f"score CLI returned {rc}")
    if launches <= 0:
        raise AssertionError("the main path launched no conv8_relu kernel")
    _df, ref, _alt, sed = check_output(out_csv, inputs["n_rows"])
    n_var = len(inputs["variants"])
    report["main_path"] = {
        "variants": n_var, "rows": inputs["n_rows"], "models": N_MODELS, "maxshift": MAXSHIFT,
        "cli_wall_s": wall, "conv8_relu_launches": launches,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        "sed_abs_max": float(np.abs(sed).max()), "ref_abs_max": float(np.abs(ref).max()),
    }
    log(f"main path: {n_var} variants, {inputs['n_rows']} (variant, gene) rows x {N_MODELS} models in {wall:.2f} s "
        f"(CLI incl. weight load) = {inputs['n_rows'] / wall:.1f} rows/s, {n_var / wall:.1f} variants/s; "
        f"conv8_relu launches {launches} [{card}]")
    report["main_path"]["serve_wall_s"] = serve_repeats(inputs, card)


def serve_repeats(inputs: dict, card: str, repeats: int = 3) -> list[float]:
    """Warm repeats of the serving call itself (runner and models built,
    kernel loaded): the end-to-end throughput without CLI start-up."""
    import numpy as np
    import pandas as pd
    import torch

    from expecto_tpu_torch.genome.fasta import FastaIndex
    from expecto_tpu_torch.genome.vcf import read_vcf, standardize_chroms
    from expecto_tpu_torch.io.tables import load_closest_genes, load_modellist
    from expecto_tpu_torch.models.convert import load_params_npz
    from expecto_tpu_torch.parallel.runner import BelugaRunner
    from expecto_tpu_torch.pipeline.sed import score_sed_serving

    runner = BelugaRunner(load_params_npz(WORK / "beluga.npz"), batch_size=BATCH, device=DEVICE,
                          compute_dtype=torch.bfloat16, out_dtype=np.float16)
    genome = FastaIndex(WORK / "genome.fa")
    vcf = standardize_chroms(read_vcf(WORK / "variants.vcf"))
    gene = load_closest_genes(WORK / "genes.tsv")
    ml = load_modellist(WORK / "modellist")
    walls = []
    try:
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df = score_sed_serving(vcf, gene, genome, runner, ml.iloc[:, 0].tolist(), maxshift=MAXSHIFT,
                                   model_names=ml.iloc[:, 1].tolist())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        genome.close()
    if not isinstance(df, pd.DataFrame) or len(df) != inputs["n_rows"]:
        raise AssertionError("warm serving returned the wrong number of rows")
    med = statistics.median(walls)
    log(f"warm serving ({repeats} runs): median {med:.3f} s = {inputs['n_rows'] / med:.1f} rows/s, "
        f"{len(inputs['variants']) / med:.1f} variants/s; runs {[round(w, 3) for w in walls]} [{card}]")
    return walls


def parity_phase(report: dict, inputs: dict) -> None:
    """fp32 on the card vs fp32 on the CPU for a substitution with its genes,
    a second substitution, an indel and a contig-edge row."""
    import numpy as np

    from expecto_tpu_torch.cli.score import main as score_main

    variants = inputs["variants"]
    picks = [0, 1, N_SUBS, len(variants) - 1]
    vcf_lines = (WORK / "variants.vcf").read_text().splitlines()
    gene_lines = (WORK / "genes.tsv").read_text().splitlines()
    keep = {f"{variants[i][0][3:]}\t{variants[i][1] - 1}\t{variants[i][1]}\t{variants[i][2]}\t{variants[i][3]}"
            for i in picks}
    (WORK / "parity.vcf").write_text("\n".join(vcf_lines[i] for i in picks) + "\n")
    genes = [g for g in gene_lines if "\t".join(g.split("\t")[:5]) in keep]
    (WORK / "parity_genes.tsv").write_text("\n".join(genes) + "\n")
    frames = {}
    for tag, device in (("card", DEVICE), ("cpu", "cpu")):
        out = WORK / f"parity_{tag}.csv"
        rc = score_main(score_args(WORK / "parity.vcf", WORK / "parity_genes.tsv", "--fp32", "--device", device,
                                   "--output", str(out)))
        if rc != 0:
            raise AssertionError(f"fp32 score CLI on {device} returned {rc}")
        frames[tag] = check_output(out, len(genes))
    _dg, ref_g, alt_g, sed_g = frames["card"]
    _dc, ref_c, alt_c, sed_c = frames["cpu"]
    sed_atol = 1e-5 * max(1.0, float(np.abs(ref_c).max()))
    errs = {"REF": float(np.abs(ref_g - ref_c).max()), "ALT": float(np.abs(alt_g - alt_c).max()),
            "SED": float(np.abs(sed_g - sed_c).max())}
    for name, g, c, atol in (("REF", ref_g, ref_c, PARITY_ATOL), ("ALT", alt_g, alt_c, PARITY_ATOL),
                             ("SED", sed_g, sed_c, sed_atol)):
        np.testing.assert_allclose(g, c, rtol=PARITY_RTOL, atol=atol, err_msg=f"card vs CPU fp32 {name}")
    report["parity"] = {"rows": len(genes), "max_abs_err": errs, "sed_atol": sed_atol}
    log(f"parity fp32 card vs CPU on {len(genes)} rows x {N_MODELS} models: max |err| {errs}")


def kernel_table(report: dict) -> dict:
    """The kernel line: conv8_relu over every launch of one substitution
    chunk (each shape weighted by its launches there), bf16 as the main path
    runs it; per-shape numbers in ``layers``."""
    layers = report["conv8_layers"]

    def total(key, tag="bf16"):
        return sum(r[tag][key] * r["launches_per_chunk"] for r in layers)

    return {"kernels": [{
        "name": "conv8_relu",
        "route": "cuda",
        "source": "expecto_tpu_torch/csrc/conv8_relu.cu",
        "replaces": "expecto_tpu/ops/pallas_conv.py:49",
        "launches": report["main_path"]["conv8_relu_launches"],
        "max_abs_err": max(r["bf16"]["max_abs_err"] for r in layers),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if total("ops_ms") >= total("bytes_ms") else "bytes",
        "library_ms": total("library_ms"),
        "max_err_fp32": max(r["fp32"]["max_abs_err"] for r in layers),
        "max_err_bf16": max(r["bf16"]["max_abs_err"] for r in layers),
        "layers": [{"layer": r["layer"], "N": r["N"], "L": r["L"], "Cin": r["Cin"], "Cout": r["Cout"],
                    "launches_per_chunk": r["launches_per_chunk"],
                    **{f"{t}_{k}": r[t][k] for t in ("fp32", "bf16")
                       for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}}
                   for r in layers],
    }]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report to DIR/chip_smoke.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from expecto_tpu_torch.ops import cuda_build

    card = card_line()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "seed": args.seed}
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = cuda_build.build(ptxas_info=True)
    report["build_s"] = time.perf_counter() - t0
    for name, (secs, out) in built.items():
        log(f"built csrc/{name}.cu in {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build phase {report['build_s']:.1f} s")

    t0 = time.perf_counter()
    kernel_phase(report)
    log(f"kernel phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    inputs = make_inputs(args.seed)
    log(f"inputs: {len(inputs['variants'])} variants, {inputs['n_rows']} rows ({time.perf_counter() - t0:.1f} s)")

    main_path_phase(report, inputs, card)
    t0 = time.perf_counter()
    parity_phase(report, inputs)
    log(f"parity phase {time.perf_counter() - t0:.1f} s")

    table = kernel_table(report)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "chip_smoke.json").write_text(json.dumps({**report, **table}, indent=1))
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
