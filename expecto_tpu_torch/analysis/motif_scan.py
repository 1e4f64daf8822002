"""Built-in FIMO-compatible PWM scanner (port of
expecto_tpu/analysis/motif_scan.py).

The reference shells out to the MEME-suite ``fimo`` binary
(query_fimo_for_predictions.py:44-47), an external dependency that many
installations lack. This module implements the same published scoring
model natively:

- per-motif log-odds scores ``sum_j log2(p'(j, base) / bg(base))`` over a
  0-order background, with MEME's pseudocount smoothing
  ``p' = (p * nsites + pseudo * bg) / (nsites + pseudo)`` (pseudo = 0.1,
  FIMO's default);
- exact p-values from the quantized-score null distribution via dynamic
  programming over positions weighted by the background (Staden 1989, the
  algorithm FIMO itself uses; Grant, Bailey & Noble 2011);
- both strands, every window (FIMO's ``--thresh 1 --text`` behavior), with
  the MEME>=5 ``--text`` TSV layout so every downstream consumer
  (:func:`expecto_tpu_torch.analysis.fimo.filter_fimo_results`, the cluster
  enrichment chain) runs unmodified. ``--text`` mode computes no q-values
  (matching FIMO), so that column is empty.

:func:`expecto_tpu_torch.analysis.fimo.run_fimo` prefers the real binary
when it is on PATH (bit parity with MEME) and falls back here; p-values can
differ from the binary's in the last quantization digit (different integer
scaling), which the rank-based downstream (best-p dedup, hypergeometric
counts) is insensitive to. The text this module writes equals the JAX
package's scanner's byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: FIMO's default motif pseudocount (--motif-pseudo)
MOTIF_PSEUDO = 0.1
#: integer quantization scale for the p-value DP (score resolution 1e-3 bits)
SCORE_SCALE = 1000

_BASES = "ACGT"
_COMP = str.maketrans("ACGT", "TGCA")


@dataclass
class MemeMotif:
    motif_id: str
    alt_id: str
    probs: np.ndarray  # (w, 4) letter probabilities, ACGT order
    nsites: float

    @property
    def width(self) -> int:
        return self.probs.shape[0]


def parse_meme(path: str) -> tuple[list[MemeMotif], np.ndarray]:
    """Parse a minimal MEME motif file -> (motifs, background (4,)).

    Handles the standard text layout: optional ``Background letter
    frequencies`` block, then per motif a ``MOTIF <id> [alt]`` line, a
    ``letter-probability matrix: alength= 4 w= W nsites= N ...`` line and W
    rows of 4 probabilities (the subset the reference's motif DBs — JASPAR
    / HOCOMOCO exports — and get_enriched_motif_set.py's writer use)."""
    background = np.full(4, 0.25)
    motifs: list[MemeMotif] = []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.lower().startswith("background letter frequencies"):
            # next non-empty line: "A 0.25 C 0.25 G 0.25 T 0.25"
            i += 1
            while i < len(lines) and not lines[i]:
                i += 1
            parts = lines[i].split()
            freq = {parts[j].upper(): float(parts[j + 1]) for j in range(0, len(parts) - 1, 2)}
            background = np.array([freq.get(b, 0.25) for b in _BASES])
            background = background / background.sum()
        elif line.startswith("MOTIF"):
            parts = line.split()
            motif_id = parts[1]
            alt_id = parts[2] if len(parts) > 2 else ""
            # find the letter-probability header
            j = i + 1
            while j < len(lines) and not lines[j].startswith("letter-probability matrix"):
                j += 1
            if j >= len(lines):
                raise ValueError(f"MOTIF {motif_id}: missing letter-probability matrix")
            header = lines[j]
            fields = header.replace("=", " = ").split()

            def field(name, default):
                return float(fields[fields.index(name) + 2]) if name in fields else default

            w = int(field("w", 0))
            nsites = field("nsites", 20.0)
            rows = []
            j += 1
            while len(rows) < w:
                if lines[j]:
                    rows.append([float(x) for x in lines[j].split()[:4]])
                j += 1
            probs = np.asarray(rows, dtype=np.float64)
            if probs.shape != (w, 4):
                raise ValueError(f"MOTIF {motif_id}: expected ({w}, 4) matrix, got {probs.shape}")
            motifs.append(MemeMotif(motif_id, alt_id, probs, nsites))
            i = j - 1
        i += 1
    if not motifs:
        raise ValueError(f"no MOTIF blocks found in {path}")
    return motifs, background


def log_odds(motif: MemeMotif, background: np.ndarray, pseudo: float = MOTIF_PSEUDO) -> np.ndarray:
    """(w, 4) log2 odds with MEME pseudocount smoothing."""
    p = (motif.probs * motif.nsites + pseudo * background[None, :]) / (motif.nsites + pseudo)
    return np.log2(p / background[None, :])


def pvalue_lookup(lo: np.ndarray, background: np.ndarray, scale: int = SCORE_SCALE):
    """Exact null p-values for quantized log-odds scores.

    Returns ``(q, lookup)``: ``q`` the (w, 4) integer score matrix and
    ``lookup(scores_int)`` mapping integer window scores (sums of ``q``
    entries) to ``P(random window score >= s)`` under the 0-order
    background — the Staden DP FIMO uses."""
    q = np.round(lo * scale).astype(np.int64)
    offs = q.min(axis=1)
    q0 = q - offs[:, None]  # nonnegative per position
    dist = np.zeros(1, dtype=np.float64)
    dist[0] = 1.0
    for j in range(q.shape[0]):
        m = int(q0[j].max())
        new = np.zeros(dist.size + m)
        for b in range(4):
            new[q0[j, b] : q0[j, b] + dist.size] += dist * background[b]
        dist = new
    # survival function over shifted scores
    sf = np.cumsum(dist[::-1])[::-1]
    base = int(offs.sum())

    def lookup(scores_int: np.ndarray) -> np.ndarray:
        s = np.asarray(scores_int, dtype=np.int64) - base
        s = np.clip(s, 0, sf.size - 1)
        return sf[s]

    return q, lookup


def _encode(seq: str) -> np.ndarray:
    out = np.full(len(seq), -1, dtype=np.int64)
    arr = np.frombuffer(seq.upper().encode("latin-1"), np.uint8)
    for i, b in enumerate(_BASES):
        out[arr == ord(b)] = i
    return out


def _window_scores(codes: np.ndarray, mat: np.ndarray):
    """(n_windows,) integer/float window scores + validity mask (windows
    containing non-ACGT letters are skipped, as FIMO does)."""
    w = mat.shape[0]
    if codes.size < w:
        return np.zeros(0, mat.dtype), np.zeros(0, bool)
    wins = np.lib.stride_tricks.sliding_window_view(codes, w)  # (n, w)
    valid = (wins >= 0).all(axis=1)
    safe = np.where(wins >= 0, wins, 0)
    scores = mat[np.arange(w)[None, :], safe].sum(axis=1)
    return scores, valid


def scan_to_text(motif_file: str, fasta_path: str, out_path: str, *, thresh: float = 1.0) -> None:
    """Scan every motif over every FASTA record, both strands, and write
    FIMO's MEME>=5 ``--text`` TSV (uncommented header, empty q-value)."""
    from ..pipeline.consensus import parse_fasta

    motifs, background = parse_meme(motif_file)
    records = list(parse_fasta(fasta_path))
    with open(out_path, "w") as out:
        print(
            "motif_id\tmotif_alt_id\tsequence_name\tstart\tstop\tstrand\tscore\tp-value\tq-value\tmatched_sequence",
            file=out,
        )
        for motif in motifs:
            lo = log_odds(motif, background)
            q, lookup = pvalue_lookup(lo, background)
            w = motif.width
            for name, seq in records:
                seq = seq.upper()
                for strand in "+-":
                    s = seq if strand == "+" else seq.translate(_COMP)[::-1]
                    codes = _encode(s)
                    int_scores, valid = _window_scores(codes, q)
                    if not valid.any():
                        continue
                    real_scores, _ = _window_scores(codes, lo)
                    pvals = lookup(int_scores)
                    for i in np.nonzero(valid & (pvals <= thresh))[0]:
                        if strand == "+":
                            start, stop = i + 1, i + w
                        else:  # map the rc-scan index back to + coordinates
                            start, stop = len(seq) - i - w + 1, len(seq) - i
                        print(
                            f"{motif.motif_id}\t{motif.alt_id}\t{name}\t{start}\t{stop}\t{strand}"
                            f"\t{real_scores[i]:.4g}\t{pvals[i]:.3g}\t\t{s[i : i + w]}",
                            file=out,
                        )
