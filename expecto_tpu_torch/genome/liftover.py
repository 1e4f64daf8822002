"""Chain-file genome liftover (replacement for the ``liftover`` pip package;
port of expecto_tpu/genome/liftover.py, plain numpy).

The reference lifts hg38 variants to hg19 via ``liftover.get_lifter('hg38',
'hg19').convert_coordinate(chrom, pos)`` (chromatin.py:50,120-135) which
downloads a UCSC over.chain file. This module implements the same conversion
from a local UCSC chain file (no network): parse chains into per-source-contig
block tables and answer point queries with a numpy binary search.

UCSC chain format: header ``chain score tName tSize tStrand tStart tEnd qName
qSize qStrand qStart qEnd id`` followed by alignment lines ``size [dt dq]``;
all coordinates 0-based half-open; negative-strand q coordinates count from
the contig end.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class _ChromBlocks:
    t_starts: list[int] = field(default_factory=list)
    t_ends: list[int] = field(default_factory=list)
    q_starts: list[int] = field(default_factory=list)  # forward-strand block start on q
    q_names: list[int] = field(default_factory=list)  # index into name table
    q_strands: list[bool] = field(default_factory=list)  # True = '-'
    q_sizes: list[int] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)


class ChainLiftover:
    """Point-coordinate liftover from a UCSC chain file.

    ``convert_coordinate(chrom, pos)`` takes/returns **1-based** positions and
    yields ``[(chrom, pos, strand)]`` sorted by descending chain score — the
    same call surface the reference consumes (chromatin.py:126-133).
    """

    def __init__(self, chain_path: str | os.PathLike):
        blocks: dict[str, _ChromBlocks] = {}
        self._names: list[str] = []
        name_ids: dict[str, int] = {}

        opener = gzip.open if str(chain_path).endswith(".gz") else open
        with opener(chain_path, "rt") as f:
            header = None
            t_cursor = q_cursor = 0
            for line in f:
                line = line.strip()
                if not line:
                    header = None
                    continue
                parts = line.split()
                if parts[0] == "chain":
                    (_, score, t_name, _t_size, _t_strand, t_start, _t_end,
                     q_name, q_size, q_strand, q_start, _q_end) = parts[:12]
                    if q_name not in name_ids:
                        name_ids[q_name] = len(self._names)
                        self._names.append(q_name)
                    header = (
                        float(score), t_name, name_ids[q_name],
                        q_strand == "-", int(q_size),
                    )
                    t_cursor, q_cursor = int(t_start), int(q_start)
                    continue
                if header is None:
                    continue
                size = int(parts[0])
                score, t_name, q_id, q_neg, q_size = header
                cb = blocks.setdefault(t_name, _ChromBlocks())
                cb.t_starts.append(t_cursor)
                cb.t_ends.append(t_cursor + size)
                cb.q_starts.append(q_cursor)
                cb.q_names.append(q_id)
                cb.q_strands.append(q_neg)
                cb.q_sizes.append(q_size)
                cb.scores.append(score)
                if len(parts) == 3:
                    t_cursor += size + int(parts[1])
                    q_cursor += size + int(parts[2])
                else:  # terminal block of the chain
                    header = None

        self._tables: dict[str, dict[str, np.ndarray]] = {}
        for name, cb in blocks.items():
            order = np.argsort(np.asarray(cb.t_starts, dtype=np.int64), kind="stable")
            tbl = {
                "t_starts": np.asarray(cb.t_starts, dtype=np.int64)[order],
                "t_ends": np.asarray(cb.t_ends, dtype=np.int64)[order],
                "q_starts": np.asarray(cb.q_starts, dtype=np.int64)[order],
                "q_names": np.asarray(cb.q_names, dtype=np.int64)[order],
                "q_strands": np.asarray(cb.q_strands, dtype=bool)[order],
                "q_sizes": np.asarray(cb.q_sizes, dtype=np.int64)[order],
                "scores": np.asarray(cb.scores, dtype=np.float64)[order],
            }
            lengths = tbl["t_ends"] - tbl["t_starts"]
            tbl["max_len"] = int(lengths.max()) if lengths.size else 0
            self._tables[name] = tbl

    def convert_coordinate(self, chrom: str, pos: int) -> list[tuple[str, int, str]]:
        """Lift one 1-based position; [] if unmapped."""
        tbl = self._tables.get(chrom) or self._tables.get("chr" + str(chrom).replace("chr", ""))
        if tbl is None:
            return []
        p0 = int(pos) - 1
        starts = tbl["t_starts"]
        hi = int(np.searchsorted(starts, p0, side="right"))
        lo = int(np.searchsorted(starts, p0 - tbl["max_len"], side="left"))
        results = []
        for i in range(lo, hi):
            if tbl["t_starts"][i] <= p0 < tbl["t_ends"][i]:
                q0 = int(tbl["q_starts"][i]) + (p0 - int(tbl["t_starts"][i]))
                if tbl["q_strands"][i]:
                    q0 = int(tbl["q_sizes"][i]) - 1 - q0
                    strand = "-"
                else:
                    strand = "+"
                results.append((float(tbl["scores"][i]), self._names[int(tbl["q_names"][i])], q0 + 1, strand))
        results.sort(key=lambda r: -r[0])
        return [(name, q, s) for _, name, q, s in results]


FAILED_LIFTOVER_VALUE = -1


def liftover_vcf(vcf, converter: ChainLiftover, *, strict: bool = False):
    """Lift a VCF DataFrame's coordinates; failed rows get -1/-1
    (reference chromatin.py:120-135,217-229).

    ``strict=False`` (default) resolves positions with multiple overlapping
    chain mappings to the top-scoring chain with a warning — a documented
    improvement over the reference, which ``assert``s there and dies
    (chromatin.py:128). ``strict=True`` selects parity mode: the reference's
    abort is reproduced as an AssertionError naming the offending position.

    Returns (lifted_df, failed_mask).
    """
    vcf = vcf.copy()
    # failed rows get the integer sentinel in the (string) chrom column, as
    # the reference does — force object dtype for pandas >= 2 strictness.
    vcf.isetitem(0, vcf.iloc[:, 0].astype(object))
    chroms, positions = [], []
    warned_multi = False
    for chrom, pos in zip(vcf.iloc[:, 0], vcf.iloc[:, 1]):
        coords = converter.convert_coordinate(str(chrom), int(pos))
        if len(coords) > 1:
            if strict:
                # reference parity: chromatin.py:128 asserts
                # len(coords) <= 1 and aborts the run
                raise AssertionError(
                    f"Liftover of variant {chrom}:{pos} returned {len(coords)} "
                    "mappings (strict/parity mode reproduces the reference's "
                    "abort; rerun without --strict_liftover to take the "
                    "top-scoring chain instead)"
                )
            # overlapping chains (main + alt mappings) are legitimate in real
            # UCSC chain files; take the top-scoring mapping (the list is
            # score-sorted) rather than aborting the whole chunk — the
            # reference asserts here (chromatin.py:128) and dies instead
            if not warned_multi:
                import warnings

                warnings.warn(
                    f"multiple liftover mappings for {chrom}:{pos} (and possibly "
                    "others) — using the top-scoring chain for each",
                    stacklevel=2,
                )
                warned_multi = True
            coords = coords[:1]
        if not coords:
            chroms.append(FAILED_LIFTOVER_VALUE)
            positions.append(FAILED_LIFTOVER_VALUE)
        else:
            chroms.append(coords[0][0])
            positions.append(coords[0][1])
    vcf.iloc[:, 0] = chroms
    vcf.iloc[:, 1] = positions
    failed = vcf.iloc[:, 1] == FAILED_LIFTOVER_VALUE
    return vcf, failed
