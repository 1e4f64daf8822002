"""Base-code encoding with the exact reference channel semantics.

The reference encodes bases in **AGCT** channel order (A->ch0, G->ch1,
C->ch2, T->ch3; N/H/'-'/lowercase handled; everything else zero), center-crops
each sequence to the model input size, and appends the reverse complement as
extra batch rows (reference: expecto_utils.py:5-39, chromatin.py:138-172).

Under the AGCT ordering, reverse complement == flip both the channel axis and
the position axis (A<->T is 0<->3, G<->C is 1<->2), which is the reference's
``seqsnp[:, ::-1, ::-1]`` trick.

The serving path ships compact int8 *base codes* (N, L) to the device and
one-hots there (parallel/runner.py). The per-character Python loop of the
reference is replaced by a 256-entry byte lookup table applied with numpy.
"""

from __future__ import annotations

import numpy as np

# Channel order AGCT (reference expecto_utils.py:22-27).
BASE_CODES = {"A": 0, "G": 1, "C": 2, "T": 3}
#: Code used for any base that one-hots to the zero vector (N, H, '-', other).
N_CODE = 4

#: Complement map under codes [A,G,C,T,N] -> [T,C,G,A,N].
_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.int8)

# byte -> code lookup table; unknown bytes map to N_CODE (zero one-hot).
_BYTE_LUT = np.full(256, N_CODE, dtype=np.int8)
for _base, _code in BASE_CODES.items():
    _BYTE_LUT[ord(_base)] = _code
    _BYTE_LUT[ord(_base.lower())] = _code


def center_crop_slice(length: int, inputsize: int) -> slice:
    """The reference's center-crop: line[floor((len-n)/2) : floor(len-(len-n)/2)].

    (expecto_utils.py:31). For odd overhang the extra base is dropped from
    the *right* end: length=2101, inputsize=2000 gives [50:2050] — 50 bases
    dropped left, 51 right (floor on both bounds, matching the reference's
    int() truncation).
    """
    lo = int(np.floor((length - inputsize) / 2.0))
    hi = int(np.floor(length - (length - inputsize) / 2.0))
    return slice(lo, hi)


def seqs_to_codes(seqs, inputsize: int = 2000) -> np.ndarray:
    """Encode an iterable of sequence strings to int8 base codes (N, inputsize).

    Sequences are center-cropped (or zero-padded on the right if shorter than
    ``inputsize``, which encodes as Ns — reference pads with 'N' explicitly in
    the consensus path, geuvadis_predict_ref_all_genes.py:109-144).
    """
    seqs = list(seqs)
    out = np.full((len(seqs), inputsize), N_CODE, dtype=np.int8)
    for n, line in enumerate(seqs):
        raw = np.frombuffer(line.encode("ascii"), dtype=np.uint8)
        if raw.shape[0] >= inputsize:
            raw = raw[center_crop_slice(raw.shape[0], inputsize)]
            out[n] = _BYTE_LUT[raw]
        else:
            out[n, : raw.shape[0]] = _BYTE_LUT[raw]
    return out


def alleles_to_flat_codes(alleles) -> tuple[np.ndarray, np.ndarray]:
    """Variable-length allele strings -> (concatenated int8 codes, per-allele
    lengths). One encode pass for a whole VCF column (the splice-scatter
    companion of :func:`seqs_to_codes`'s fixed-width windows)."""
    alleles = list(alleles)
    cat = np.frombuffer("".join(alleles).encode("latin-1"), dtype=np.uint8)
    lens = np.fromiter((len(a) for a in alleles), np.int64, len(alleles))
    return _BYTE_LUT[cat], lens


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement base codes along the last (position) axis."""
    return _COMPLEMENT[codes][..., ::-1]
