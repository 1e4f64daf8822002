"""ExPecto's variant scoring and gene features in plain PyTorch and NumPy,
one 2,000-bp window at a time, as FunctionLab/ExPecto's chromatin.py,
predict.py and compute_expecto_features.py define them. Imports nothing of
the program.

Variant (chromatin.py fetchSeqs): for each shift s in 0, -200 .. -maxshift,
200 .. maxshift, fetch the 2,100 bp centred at pos + s, splice REF or ALT in
at column 1,049 - s, crop the centre 2,000 bp (floor on both bounds), run
Beluga on it and on its reverse complement and average. predict.py: the
strand-signed distance d = (pos - TSS + s) * strand gives 10 weights
exp(-rate * floor(|d| / 200)) for d <= 0 and for d >= 0 at rates 0.01,
0.02, 0.05, 0.1, 0.2; a variant's 20,020 features are the weighted sums of
its 9 windows' 2,002 tracks (basis-major); a tissue model predicts
base_score + bias + features . w; SED = ALT - REF.

Gene (compute_expecto_features.py): the 200 windows starting at
TSS + s * strand - 999 for s in range(-20000, 20000, 200), the same
averaging, weights exp(-rate * |s| / 200) for s <= 0 and s >= 0 (no floor).
"""

from __future__ import annotations

import numpy as np
import torch

from .beluga import Beluga, precision_mode, rounding

DECAY_RATES = (0.01, 0.02, 0.05, 0.1, 0.2)
INPUT = 2000

_LUT = np.full(256, 4, np.int8)
for _code, _base in enumerate(b"AGCT"):
    _LUT[_base] = _code
    _LUT[_base + 32] = _code


def encode(seq: np.ndarray) -> np.ndarray:
    """ASCII bytes -> codes in ExPecto's AGCT channel order, N (anything
    else) 4."""
    return _LUT[seq]


def variant_shifts(maxshift: int, step: int = 200) -> list[int]:
    return [0] + list(range(-step, -maxshift - 1, -step)) + list(range(step, maxshift + 1, step))


def _crop(seq: np.ndarray) -> np.ndarray:
    lo = int(np.floor((len(seq) - INPUT) / 2.0))
    return seq[lo : lo + INPUT]


def variant_window_codes(contig: np.ndarray, pos: int, ref: str, alt: str, shifts) -> tuple[np.ndarray, np.ndarray]:
    """(S, 2000) REF and ALT window codes of one variant (1-based ``pos``)."""
    half = (INPUT + 100) // 2 - 1  # 1,049
    ref_b = np.frombuffer(ref.encode(), np.uint8)
    alt_b = np.frombuffer(alt.encode(), np.uint8)
    out_ref, out_alt = [], []
    for s in shifts:
        seq = contig[pos + s - half - 1 : pos + s + half + 1]
        cut = half - s
        tail = seq[cut + len(ref_b) :]
        out_ref.append(encode(_crop(np.concatenate([seq[:cut], ref_b, tail]))))
        out_alt.append(encode(_crop(np.concatenate([seq[:cut], alt_b, tail]))))
    return np.stack(out_ref), np.stack(out_alt)


def variant_basis(dist_to_tss: np.ndarray, strand_sign: np.ndarray, shifts) -> np.ndarray:
    """(S, N, 10) weights; ``dist_to_tss`` = pos - TSS."""
    out = []
    for s in shifts:
        d = (dist_to_tss + s) * strand_sign
        mag = np.floor(np.abs(d) / 200.0)
        cols = [np.exp(-r * mag) * (d <= 0) for r in DECAY_RATES] + [np.exp(-r * mag) * (d >= 0) for r in DECAY_RATES]
        out.append(np.stack(cols, axis=-1))
    return np.stack(out)


def gene_weights(shifts) -> np.ndarray:
    """(10, S) weights of the gene path."""
    s = np.asarray(shifts, np.float64)
    mag = np.abs(s) / 200.0
    return np.stack([np.exp(-r * mag) * (s <= 0) for r in DECAY_RATES]
                    + [np.exp(-r * mag) * (s >= 0) for r in DECAY_RATES])


def score_variants(net: Beluga, genome, chrom, pos, ref, alt, tss, strand, W: torch.Tensor, bias: torch.Tensor,
                   base_score: float, *, maxshift: int = 800, batch: int = 8, head: str = "fp64"):
    """(REF, ALT, SED), each (N, K) float64 numpy, of N variants against the
    stacked models ``W`` (features, K) and ``bias`` (K,) on W's device.
    ``head``: the projection and model product in float64 ("fp64"), float32
    ("fp32") or on TF32 operands ("tf32")."""
    shifts = variant_shifts(maxshift)
    dev = W.device
    sign = np.where(np.asarray(strand) == "+", 1, -1)
    basis = variant_basis(np.asarray(pos, np.int64) - np.asarray(tss, np.int64), sign, shifts)
    hdt = torch.float64 if head == "fp64" else torch.float32
    q = rounding("tf32" if head == "tf32" else "fp32")
    Wh, bh = q(W.to(hdt)), bias.to(hdt)
    refs, alts = [], []
    for i0 in range(0, len(pos), batch):
        codes = []
        for i in range(i0, min(i0 + batch, len(pos))):
            r, a = variant_window_codes(genome.contigs[chrom[i]], int(pos[i]), ref[i], alt[i], shifts)
            codes += [r, a]
        preds = net.predict(torch.from_numpy(np.concatenate(codes)).to(dev))
        preds = preds.view(-1, 2, len(shifts), preds.shape[-1])
        refs.append(preds[:, 0])
        alts.append(preds[:, 1])
    p_ref, p_alt = torch.cat(refs), torch.cat(alts)  # (N, S, tracks)
    b = q(torch.from_numpy(basis).to(dev, hdt))  # (S, N, 10)
    with precision_mode():
        f_ref = torch.einsum("snb,nsm->nbm", b, q(p_ref.to(hdt))).reshape(len(pos), -1)
        f_alt = torch.einsum("snb,nsm->nbm", b, q(p_alt.to(hdt))).reshape(len(pos), -1)
        REF = q(f_ref) @ Wh + bh + base_score
        ALT = q(f_alt) @ Wh + bh + base_score
    return (REF.double().cpu().numpy(), ALT.double().cpu().numpy(), (ALT - REF).double().cpu().numpy())


def gene_features(net: Beluga, genome, chrom, tss, strand, *, head: str = "fp64") -> np.ndarray:
    """(N, 10 * tracks) float64 features of N genes (``strand`` +1 / -1)."""
    shifts = list(range(-20000, 20000, 200))
    weights = gene_weights(shifts)
    out = []
    for c, t, s in zip(chrom, tss, strand):
        contig = genome.contigs[c]
        starts = np.array([int(t) + sh * int(s) - (INPUT // 2 - 1) for sh in shifts]) - 1
        codes = encode(contig[starts[:, None] + np.arange(INPUT)])
        preds = net.predict(torch.from_numpy(codes).to(net.fc2[0].device))  # (200, tracks)
        hdt = torch.float64 if head == "fp64" else torch.float32
        q = rounding("tf32" if head == "tf32" else "fp32")
        with precision_mode():
            w = q(torch.from_numpy(weights).to(preds.device, hdt))
            out.append((w @ q(preds.to(hdt))).reshape(-1).double().cpu().numpy())
    return np.stack(out)
