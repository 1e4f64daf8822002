"""Window math: variant-centered and TSS-centered genome windows.

Variant path (reference fetchSeqs, chromatin.py:175-209): a window of
``inputsize + 100`` bp centered at ``pos + shift`` is fetched, the ref/alt
allele spliced in at ``mutpos = windowsize/2 - 1 - shift`` (0-based offset in
the window), and ref/alt genome-match booleans recorded for diagnostics.
Indels are absorbed by the 100 bp slack and removed later by the center crop.

Gene path (compute_expecto_features.py:107-110): 200 windows of ``windowsize``
bp at strand-oriented shifts ``range(-20000, 20000, 200)`` around the TSS:
``start = tss + shift*strand - (w/2 - 1)``, ``stop = tss + shift*strand + w/2``
(1-based inclusive).
"""

from __future__ import annotations

from dataclasses import dataclass

from .fasta import FastaIndex


def variant_shifts(maxshift: int = 800, step: int = 200) -> list[int]:
    """The reference's shift enumeration [0, -200..-maxshift, 200..maxshift]
    (chromatin.py:243)."""
    return [0] + list(range(-step, -maxshift - 1, -step)) + list(range(step, maxshift + 1, step))


@dataclass
class VariantWindow:
    ref_seq: str
    alt_seq: str
    ref_matched: bool
    alt_matched: bool


def fetch_variant_window(
    genome: FastaIndex,
    chrom: str,
    pos: int,
    ref: str,
    alt: str,
    shift: int = 0,
    inputsize: int = 2000,
) -> VariantWindow:
    """Fetch ref/alt window strings for one variant at one shift
    (reference chromatin.py:175-209)."""
    windowsize = inputsize + 100
    mutpos = int(windowsize / 2 - 1 - shift)
    seq = genome.sequence(
        chrom,
        pos + shift - int(windowsize / 2 - 1),
        pos + shift + int(windowsize / 2),
    )
    window_ref = seq[mutpos : mutpos + len(ref)].upper()
    return VariantWindow(
        ref_seq=seq[:mutpos] + ref + seq[mutpos + len(ref) :],
        alt_seq=seq[:mutpos] + alt + seq[mutpos + len(ref) :],
        ref_matched=window_ref == ref.upper(),
        alt_matched=window_ref == alt.upper(),
    )


def gene_shift_window_bounds(tss: int, strand: int, shift: int, windowsize: int = 2000) -> tuple[int, int]:
    """1-based inclusive (start, stop) of one strand-oriented TSS shift window
    (reference compute_expecto_features.py:108-110)."""
    center = tss + shift * strand
    return center - int(windowsize / 2 - 1), center + int(windowsize / 2)


def gene_shifts(span: int = 20000, step: int = 200) -> list[int]:
    """Gene-path shift enumeration ``range(-20000, 20000, 200)``
    (compute_expecto_features.py:88)."""
    return list(range(-span, span, step))
