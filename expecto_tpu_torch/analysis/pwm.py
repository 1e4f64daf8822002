"""PWM collection for motif clustering (port of expecto_tpu/analysis/pwm.py;
reference cluster_by_pwm.py:42-102).

Self-contained JASPAR-format motif parsing/writing (the reference uses
Bio.motifs): collects JASPAR + HOCOMOCO motifs whose TF name appears in the
Lambert-curated Beluga TF assays, skipping heterodimers ('::' names).
"""

from __future__ import annotations

import glob
import re
from dataclasses import dataclass

import numpy as np


@dataclass
class Motif:
    matrix_id: str
    name: str
    counts: dict[str, list[float]]  # base -> per-position counts

    @property
    def length(self) -> int:
        return len(self.counts["A"])

    def pwm(self) -> np.ndarray:
        """(4, L) column-normalized probability matrix (ACGT rows)."""
        m = np.array([self.counts[b] for b in "ACGT"], dtype=np.float64)
        return m / m.sum(axis=0, keepdims=True)


def parse_jaspar(text: str) -> list[Motif]:
    """Parse JASPAR-format motifs:

        >MA0004.1 Arnt
        A  [ 4 19 0 0 0 0 ]
        C  [16 0 20 0 0 0 ]
        ...
    """
    motifs: list[Motif] = []
    current = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            parts = line[1:].split(None, 1)
            current = Motif(matrix_id=parts[0], name=parts[1] if len(parts) > 1 else parts[0], counts={})
            motifs.append(current)
        elif current is not None:
            m = re.match(r"^([ACGT])\s*\[?\s*([\d.\s\-eE+]*?)\s*\]?\s*$", line)
            if m:
                base = m.group(1)
                current.counts[base] = [float(x) for x in m.group(2).split()]
    return [mo for mo in motifs if set(mo.counts) == set("ACGT")]


def write_jaspar(motifs: list[Motif]) -> str:
    out = []
    for mo in motifs:
        out.append(f">{mo.matrix_id} {mo.name}")
        for base in "ACGT":
            vals = " ".join(f"{v:6.2f}" for v in mo.counts[base])
            out.append(f"{base} [{vals} ]")
    return "\n".join(out) + "\n"


def collect_cluster_motifs(
    included_tf_names: set[str],
    jaspar_motif_dir: str | None = None,
    hocomoco_jaspar_file: str | None = None,
) -> tuple[list[Motif], set[str]]:
    """Collect motifs whose TF name is in ``included_tf_names``
    (cluster_by_pwm.py:54-72): JASPAR per-file motifs (heterodimers with '::'
    skipped, exact name match) plus HOCOMOCO motifs (name before '_')."""
    included = {n.upper() for n in included_tf_names}
    found: set[str] = set()
    cluster_motifs: list[Motif] = []

    if jaspar_motif_dir:
        for motif_file in glob.glob(f"{jaspar_motif_dir}/*.jaspar"):
            with open(motif_file) as f:
                parsed = parse_jaspar(f.read())
            if len(parsed) != 1:
                raise AssertionError(f"more than one motif found in {motif_file}")
            motif = parsed[0]
            if len(motif.name.split("::")) > 1:
                continue
            if motif.name.upper() in included:
                found.add(motif.name.upper())
                cluster_motifs.append(motif)

    if hocomoco_jaspar_file:
        with open(hocomoco_jaspar_file) as f:
            for motif in parse_jaspar(f.read()):
                tf_name = motif.name.split("_")[0].upper()
                if tf_name in included:
                    found.add(tf_name)
                    cluster_motifs.append(motif)

    return cluster_motifs, found
