"""Seeded inputs of the benchmark: the genome, the gene annotation, VCF
chunks with their closest-gene tables, gene lists, the Beluga weights, the
tissue models and the training matrices.

Everything here is made by the benchmark and handed to both the program and
the reference (``benchmark/reference``). Nothing imports the program.

Seeds: every draw takes its own stream, ``stream(seed, tag, *index)``, so a
call's VCF does not depend on how many calls came before it. The genome and
its gene annotation are a fixed reference assembly (seed ``GENOME_SEED``),
as every user scores against the same genome; the weights, models, VCFs,
gene lists and training matrices follow ``--seed``.

The VCF composition (SNVs and indels by length) is fixed by the traffic
file and only the positions, alleles and order vary with the seed, so every
call and every seed runs the same shapes. Generators credited to
``expecto_tpu_torch/bench.py`` (``_train_workload``: normal X, Y + 2) and
``chip_smoke.py`` (He-scaled Beluga weights) are rewritten here, not
imported.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

GENOME_SEED = 20180716  # ExPecto's publication month; any fixed value
BASES = np.frombuffer(b"ACGT", np.uint8)


def stream(seed: int, tag: str, *index: int) -> np.random.SeedSequence:
    """A seed sequence for one named draw: the same (seed, tag, index) gives
    the same numbers, whatever else the run drew."""
    tag_word = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little")
    return np.random.SeedSequence([int(seed) % 2**64, tag_word, *[int(i) for i in index]])


def rng(seed: int, tag: str, *index: int) -> np.random.Generator:
    return np.random.default_rng(stream(seed, tag, *index))


def torch_generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(stream(seed, tag).generate_state(1, np.uint64)[0]))
    return g


# ---- the genome and its gene annotation ------------------------------------------


@dataclass
class Genome:
    """Contig name -> uint8 ASCII bases (A, C, G, T, N)."""

    contigs: dict


def make_genome(spec: dict) -> Genome:
    """``spec``: {"contigs": n, "contig_len": L, "n_runs_per_mb": r,
    "n_run_len": [lo, hi]}: uniform bases with runs of N, from
    ``GENOME_SEED``."""
    g = rng(GENOME_SEED, "genome")
    contigs = {}
    for c in range(int(spec["contigs"])):
        length = int(spec["contig_len"])
        seq = BASES[g.integers(0, 4, length, dtype=np.uint8)]
        n_runs = int(round(spec["n_runs_per_mb"] * length / 1e6))
        lo, hi = spec["n_run_len"]
        starts = g.integers(0, length - hi, n_runs)
        lens = g.integers(lo, hi + 1, n_runs)
        for s, n in zip(starts, lens):
            seq[s : s + n] = ord("N")
        contigs[f"chr{c + 1}"] = seq
    return Genome(contigs)


def genome_tag(spec: dict) -> str:
    return hashlib.sha256(json.dumps([GENOME_SEED, spec], sort_keys=True).encode()).hexdigest()[:16]


def write_fasta(genome: Genome, path: str, width: int = 60) -> None:
    """The genome as a FASTA file, written to a temporary name and renamed,
    so a reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        for name, seq in genome.contigs.items():
            f.write(f">{name}\n".encode())
            full = len(seq) // width * width
            body = np.empty((len(seq) // width, width + 1), np.uint8)
            body[:, :width] = seq[:full].reshape(-1, width)
            body[:, width] = ord("\n")
            f.write(body.tobytes())
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")
    os.replace(tmp, path)


def read_fasta(path: str) -> Genome:
    raw = np.fromfile(path, np.uint8)
    text = raw.tobytes()
    contigs = {}
    for block in text.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        contigs[head.split()[0].decode()] = np.frombuffer(body.replace(b"\n", b""), np.uint8).copy()
    return Genome(contigs)


def cached_genome(spec: dict, cache_dir: str) -> tuple[Genome, str]:
    """(genome, FASTA path): read from ``cache_dir`` when a run in this
    checkout wrote it already, else made and written there."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"genome-{genome_tag(spec)}.fa")
    if os.path.exists(path):
        return read_fasta(path), path
    genome = make_genome(spec)
    write_fasta(genome, path)
    return genome, path


@dataclass
class GeneAnnotation:
    """Representative TSS per gene: contig, 1-based position, strand (+1/-1)."""

    chrom: np.ndarray
    tss: np.ndarray
    strand: np.ndarray


def make_annotation(genome: Genome, spacing: int) -> GeneAnnotation:
    """About one TSS per ``spacing`` bp on each contig, jittered, on random
    strands (from ``GENOME_SEED``)."""
    g = rng(GENOME_SEED, "annotation")
    chroms, tss, strands = [], [], []
    for name, seq in genome.contigs.items():
        pos = np.arange(spacing // 2, len(seq) - spacing // 2, spacing, dtype=np.int64)
        pos = pos + g.integers(-spacing // 4, spacing // 4 + 1, len(pos))
        chroms.append(np.full(len(pos), name, dtype=object))
        tss.append(pos)
        strands.append(np.where(g.random(len(pos)) < 0.5, 1, -1))
    return GeneAnnotation(np.concatenate(chroms), np.concatenate(tss), np.concatenate(strands))


# ---- VCF chunks ------------------------------------------------------------------


@dataclass
class VcfChunk:
    """One call's variants, sorted by (contig, position), with the closest
    TSS of each: the VCF's columns and the closest-gene table's."""

    chrom: np.ndarray  # object: "chr1", ...
    pos: np.ndarray  # int64, 1-based
    ref: np.ndarray  # object strings
    alt: np.ndarray
    tss: np.ndarray  # int64, the closest TSS
    strand: np.ndarray  # object "+" / "-"
    gene: np.ndarray  # object gene ids

    def __len__(self) -> int:
        return len(self.pos)


def indel_lengths(n_indels: int, max_len: int) -> np.ndarray:
    """Signed allele-length changes of a chunk's indels: lengths 1..max_len
    in turn, insertions (+) and deletions (-) alternating: a fixed mix."""
    i = np.arange(n_indels)
    return np.where(i % 2 == 0, 1, -1) * ((i // 2) % max_len + 1)


def make_vcf(seed: int, call: int, genome: Genome, annotation: GeneAnnotation, traffic: dict) -> VcfChunk:
    """Call ``call``'s VCF: ``variants_per_call`` variants at distinct
    positions at least ``edge_margin`` bp from a contig edge, REF matching
    the genome (no N in it); ``indel_share`` of them indels of
    :func:`indel_lengths`, the rest SNVs, in random order."""
    g = rng(seed, "vcf", call)
    n = int(traffic["variants_per_call"])
    n_ind = int(round(n * traffic["indel_share"]))
    dl = np.concatenate([np.zeros(n - n_ind, np.int64), indel_lengths(n_ind, int(traffic["indel_max_len"]))])
    dl = dl[g.permutation(n)]
    names = list(genome.contigs)
    lens = np.array([len(genome.contigs[c]) for c in names], np.int64)
    margin = int(traffic["edge_margin"])
    # candidates in bulk: a contig by length, a position inside the margins;
    # drop repeats and those with an N in the 8 bases a REF may span
    m = 2 * n + 1024
    ci = g.choice(len(names), size=m, p=lens / lens.sum())
    pos = margin + (g.random(m) * (lens[ci] - 2 * margin)).astype(np.int64)
    ok = np.ones(m, bool)
    for c, name in enumerate(names):
        on = ci == c
        ok[on] = ~np.any(genome.contigs[name][(pos[on] - 1)[:, None] + np.arange(8)] == ord("N"), axis=1)
    _, first = np.unique(ci * (1 << 40) + pos, return_index=True)
    keep = np.zeros(m, bool)
    keep[first] = True
    keep &= ok
    idx = np.flatnonzero(keep)[:n]
    if len(idx) < n:
        raise RuntimeError("the genome has too few N-free positions for this traffic")
    order = np.lexsort((pos[idx], ci[idx]))
    ci, pos = ci[idx][order], pos[idx][order]
    chrom = np.array(names, dtype=object)[ci]
    first_base = np.empty(n, np.uint8)
    for c, name in enumerate(names):
        on = ci == c
        first_base[on] = genome.contigs[name][pos[on] - 1]
    # SNVs: one of the three other bases
    other = BASES[None, :] != first_base[:, None]
    alt_base = BASES[np.argsort(~other, axis=1, kind="stable")[np.arange(n), g.integers(0, 3, n)]]
    ref = first_base.view("S1").astype(str).astype(object)
    alt = alt_base.view("S1").astype(str).astype(object)
    for i in np.flatnonzero(dl):
        seq = genome.contigs[chrom[i]]
        p0 = pos[i] - 1
        if dl[i] > 0:
            alt[i] = ref[i] + BASES[g.integers(0, 4, dl[i])].tobytes().decode()
        else:
            ref[i] = seq[p0 : p0 - dl[i] + 1].tobytes().decode()
            alt[i] = ref[i][0]
    tss, strand, gene = closest_tss(annotation, chrom, pos)
    return VcfChunk(chrom, pos, ref, alt, tss, strand, gene)


def closest_tss(annotation: GeneAnnotation, chrom: np.ndarray, pos: np.ndarray):
    """The closest representative TSS on the variant's contig, as the
    closest-features step of ExPecto's README pairs them."""
    tss = np.empty(len(pos), np.int64)
    strand = np.empty(len(pos), object)
    gene = np.empty(len(pos), object)
    for c in dict.fromkeys(chrom.tolist()):
        m = chrom == c
        on = np.flatnonzero(annotation.chrom == c)
        t = annotation.tss[on]
        j = np.clip(np.searchsorted(t, pos[m]), 1, len(t) - 1)
        left, right = t[j - 1], t[j]
        pick = np.where(np.abs(pos[m] - left) <= np.abs(right - pos[m]), j - 1, j)
        tss[m] = t[pick]
        strand[m] = np.where(annotation.strand[on][pick] > 0, "+", "-")
        gene[m] = np.array([f"G{k:06d}" for k in on[pick]], dtype=object)
    return tss, strand, gene


# ---- gene lists -----------------------------------------------------------------


@dataclass
class GeneList:
    chrom: np.ndarray
    tss: np.ndarray
    strand: np.ndarray  # +1 / -1
    gene: np.ndarray

    def __len__(self) -> int:
        return len(self.tss)


def make_genes(seed: int, call: int, genome: Genome, traffic: dict) -> GeneList:
    """Call ``call``'s genes: ``genes_per_call`` TSSs, half on each strand,
    at least ``tss_margin`` bp from a contig edge, in random order."""
    g = rng(seed, "genes", call)
    n = int(traffic["genes_per_call"])
    names = list(genome.contigs)
    lens = np.array([len(genome.contigs[c]) for c in names], np.float64)
    margin = int(traffic["tss_margin"])
    ci = g.choice(len(names), size=n, p=lens / lens.sum())
    tss = np.array([margin + int(x * (lens[c] - 2 * margin)) for c, x in zip(ci, g.random(n))], np.int64)
    strand = np.where(np.arange(n) < n // 2, 1, -1)[g.permutation(n)]
    chrom = np.array([names[c] for c in ci], dtype=object)
    gene = np.array([f"S{call:04d}_{i:05d}" for i in range(n)], dtype=object)
    return GeneList(chrom, tss, strand, gene)


# ---- weights and tissue models ---------------------------------------------------


def beluga_shapes(cfg: dict) -> list[tuple[str, tuple, tuple]]:
    """(layer, weight shape, bias shape) in the port's npz layout: conv
    weights (8, in, out), fc1 (C6 * frames, fc1_out) over a length-major
    flatten, fc2 (fc1_out, tracks)."""
    width = int(cfg["conv_width"])
    chans = [4, *cfg["conv_channels"]]
    out = [(f"conv{i}", (width, chans[i], chans[i + 1]), (chans[i + 1],)) for i in range(len(chans) - 1)]
    out.append(("fc1", (chans[-1] * int(cfg["conv6_frames"]), int(cfg["fc1_out"])), (int(cfg["fc1_out"]),)))
    out.append(("fc2", (int(cfg["fc1_out"]), int(cfg["tracks"])), (int(cfg["tracks"]),)))
    return out


def make_beluga(seed: int, cfg: dict, device) -> dict:
    """Beluga weights on ``device`` in fp32: each weight N(0, 2 / fan_in)
    (He scaling, as ``chip_smoke.py`` draws them), each bias N(0, 0.01^2),
    one ``randn`` a tensor from one generator on the device."""
    g = torch_generator(seed, "beluga", device)
    params = {}
    for name, w_shape, b_shape in beluga_shapes(cfg):
        fan_in = math.prod(w_shape[:-1])
        w = torch.randn(w_shape, generator=g, device=device) * math.sqrt(2.0 / fan_in)
        b = torch.randn(b_shape, generator=g, device=device) * 0.01
        params[name] = {"w": w, "b": b}
    return params


@dataclass
class TissueModels:
    W: np.ndarray  # (features, models) float32
    bias: np.ndarray  # (models,) float32, without base_score
    base_score: float


def make_models(seed: int, n_features: int, n_models: int, base_score: float, device) -> TissueModels:
    """Seeded gblinear tissue models: weights N(0, 0.01^2), biases N(0, 0.1^2)."""
    g = torch_generator(seed, "models", device)
    W = torch.randn((n_features, n_models), generator=g, device=device) * 0.01
    b = torch.randn((n_models,), generator=g, device=device) * 0.1
    return TissueModels(W.cpu().numpy(), b.cpu().numpy(), float(base_score))


_LEARNER_PARAM = struct.Struct("<fIiii29i")
_GBLINEAR_PARAM = struct.Struct("<Ii32i")


def write_xgb07(path: str, weight: np.ndarray, bias: float, base_score: float) -> None:
    """One gblinear model in xgboost 0.7's binary ``.save`` layout: the
    learner parameters (base_score, num_feature), the objective and booster
    names, the gblinear parameters, then the weights [feature] and the bias
    as one float32 vector."""
    n = int(weight.shape[0])
    with open(path, "wb") as f:
        f.write(_LEARNER_PARAM.pack(np.float32(base_score), n, 0, 0, 0, *([0] * 29)))
        for name in (b"reg:linear", b"gblinear"):
            f.write(struct.pack("<Q", len(name)) + name)
        f.write(_GBLINEAR_PARAM.pack(n, 1, *([0] * 32)))
        vec = np.concatenate([np.asarray(weight, np.float32), [np.float32(bias)]]).astype("<f4")
        f.write(struct.pack("<Q", vec.size) + vec.tobytes())


def write_models(models: TissueModels, directory: str) -> list[str]:
    os.makedirs(directory, exist_ok=True)
    paths = []
    for k in range(models.W.shape[1]):
        path = os.path.join(directory, f"tissue{k:03d}.save")
        write_xgb07(path, models.W[:, k], float(models.bias[k]), models.base_score)
        paths.append(path)
    return paths


# ---- training matrices -----------------------------------------------------------


def make_training(seed: int, rows: int, features: int, models: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(X, Y) on ``device``: X (rows, features) N(0, 1), Y (rows, models)
    N(2, 1), as ``expecto_tpu_torch/bench.py``'s training workload draws
    them, here from one generator on the device."""
    g = torch_generator(seed, "training", device)
    X = torch.randn((rows, features), generator=g, device=device)
    Y = torch.randn((rows, models), generator=g, device=device) + 2.0
    return X, Y
