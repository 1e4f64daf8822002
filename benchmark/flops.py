"""Operations and bytes of the least work each call needs, whatever
implements it, and the peaks they are held against (``peaks.json``).

Convolutions: a window's layer outputs are placed on a grid that windows
sharing a span share: conv0 and conv1 outputs on the span's positions, the
first pool and conv2-conv3 on a grid of 4, the second pool and conv4-conv5
on a grid of 16 for each of the 4 phases that a window's offset can take.
The least work of a span's windows is the union over its windows of the
outputs each needs, each computed once; a changed base needs only the
outputs that it reaches (its cone). Counted per output position: 2 * width
* Cin * Cout operations. A window's fc1 is 2 * (C6 * frames) * fc1_out, or,
for an ALT allele that only changes some conv5 frames, 2 * (changed frames)
* C6 * fc1_out (fc1 is linear: ALT's product is REF's plus the changed
frames'). Nothing here imports the program.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
POOL = 4


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


@dataclass
class Work:
    """Operations and bytes of one call, by stage ("conv", "fc1", "head",
    "block", ...); ``total_flops`` is the whole model's."""

    flops: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)

    def add(self, stage: str, flops: float = 0.0, nbytes: float = 0.0) -> None:
        self.flops[stage] = self.flops.get(stage, 0.0) + float(flops)
        self.bytes[stage] = self.bytes.get(stage, 0.0) + float(nbytes)

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def _interval_mask(lo: int, hi: int, size: int) -> np.ndarray:
    m = np.zeros(size, bool)
    m[max(lo, 0) : max(min(hi, size), 0)] = True
    return m


def span_conv_outputs(span_len: int, offsets, cfg: dict, changed: tuple[int, int] | None = None):
    """Per conv layer, the number of distinct output positions that the
    windows at ``offsets`` of one span need (all of them, or with
    ``changed`` = [a, b) only those the changed span positions reach);
    and per window, its conv5 frames among them."""
    width = int(cfg["conv_width"])
    win = int(cfg["input_len"])
    n_conv = len(cfg["conv_channels"])
    pools_after = set(cfg["pool_after"])
    if any(o % POOL for o in offsets):
        raise ValueError("window offsets must be multiples of the pool width")
    a, b = changed if changed is not None else (-10**9, 10**9)
    # walk the layers: each window's first index and length on the current
    # grid; the grid's phase (which windows share it) splits at the second
    # pool; the affected interval follows the same arithmetic
    starts = {o: o for o in offsets}  # window -> first index on the current grid
    phase_of = {o: 0 for o in offsets}  # window -> grid id
    length = win
    counts = []
    frames = {}
    pools_seen = 0
    aff = {0: (a, b)}  # grid id -> affected [lo, hi)
    size = span_len + 1
    for layer in range(n_conv):
        length -= width - 1
        aff = {g: (lo - (width - 1), hi) for g, (lo, hi) in aff.items()}
        n = 0
        last = layer == n_conv - 1
        for g in set(phase_of.values()):
            need = np.zeros(size, bool)
            for o, ph in phase_of.items():
                if ph == g:
                    need |= _interval_mask(starts[o], starts[o] + length, size)
            hit = need & _interval_mask(*aff[g], size)
            n += int(hit.sum())
            if last:
                for o, ph in phase_of.items():
                    if ph == g:
                        frames[o] = int(hit[starts[o] : starts[o] + length].sum())
        counts.append(n)
        if layer in pools_after:
            pools_seen += 1
            length //= POOL
            new_aff = {}
            new_phase = {}
            for o in offsets:
                g = phase_of[o]
                if pools_seen == 1:
                    ph, key = 0, g
                else:
                    ph = starts[o] % POOL
                    key = (g, ph)
                starts[o] = (starts[o] - ph) // POOL
                new_phase[o] = key
                lo, hi = aff[g]
                new_aff[key] = ((lo - ph) // POOL, -((ph - hi) // POOL))
            phase_of, aff = new_phase, new_aff
    return counts, frames


def conv_layer_flops(cfg: dict) -> list[float]:
    chans = [4, *cfg["conv_channels"]]
    w = int(cfg["conv_width"])
    return [2.0 * w * chans[i] * chans[i + 1] for i in range(len(chans) - 1)]


def beluga_weight_elems(cfg: dict) -> dict:
    chans = [4, *cfg["conv_channels"]]
    w = int(cfg["conv_width"])
    conv = sum(w * chans[i] * chans[i + 1] for i in range(len(chans) - 1))
    fc1_in = chans[-1] * int(cfg["conv6_frames"])
    return {"conv": conv, "fc1": fc1_in * int(cfg["fc1_out"]), "fc2": int(cfg["fc1_out"]) * int(cfg["tracks"])}


def _span_work(cfg: dict, span_len: int, offsets, changed=None) -> tuple[float, float, dict]:
    """(conv flops, conv5 outputs, frames) of one orientation of one span."""
    counts, frames = span_conv_outputs(span_len, offsets, cfg, changed)
    flops = sum(c * f for c, f in zip(counts, conv_layer_flops(cfg)))
    return flops, counts[-1], frames


def score_call_work(cfg: dict, traffic: dict) -> Work:
    """One score call: ``variants_per_call`` variants, the traffic's share
    of indels, against the configuration's tissue models, both
    orientations."""
    n = int(traffic["variants_per_call"])
    n_ind = int(round(n * traffic["indel_share"]))
    n_snv = n - n_ind
    maxshift = int(cfg["maxshift"])
    n_models = int(cfg["tissue_models"])
    win = int(cfg["input_len"])
    span = 2 * maxshift + win
    offsets = [maxshift + s for s in range(-maxshift, maxshift + 1, 200)]
    n_win = len(offsets)
    rc_offsets = [span - win - o for o in offsets]
    mut = maxshift + win // 2 - 1  # the variant's column in the span
    c6 = int(cfg["conv_channels"][-1])
    frames6 = int(cfg["conv6_frames"])
    fc1_out, tracks = int(cfg["fc1_out"]), int(cfg["tracks"])
    dt = int(cfg["bytes_per_value"])
    weights = beluga_weight_elems(cfg)
    fc1_win = 2.0 * c6 * frames6 * fc1_out

    full_f, full_c5, _ = _span_work(cfg, span, offsets)
    full_r, full_c5r, _ = _span_work(cfg, span, rc_offsets)
    cone_f, cone_c5, fr_f = _span_work(cfg, span, offsets, (mut, mut + 1))
    cone_r, cone_c5r, fr_r = _span_work(cfg, span, rc_offsets, (span - 1 - mut, span - mut))
    delta_frames = sum(fr_f.values()) + sum(fr_r.values())

    work = Work()
    spans_full = n + n_ind  # REF of every variant, ALT of every indel
    # conv: codes in, weights once, conv5 outputs out
    work.add("conv", spans_full * (full_f + full_r) + n_snv * (cone_f + cone_r),
             spans_full * 2 * span + weights["conv"] * dt
             + (spans_full * (full_c5 + full_c5r) + n_snv * (cone_c5 + cone_c5r)) * c6 * dt)
    # fc1 over the conv6 buffers: every REF window and every indel ALT window
    fc1_windows = spans_full * 2 * n_win
    work.add("fc1", fc1_windows * fc1_win,
             (spans_full * (full_c5 + full_c5r)) * c6 * dt + weights["fc1"] * dt + fc1_windows * fc1_out * dt)
    # the SNV ALT's fc1 on its changed frames, fc2 and the sigmoid of every
    # window, the projection and the model product of both alleles
    work.add("fc1_delta", n_snv * delta_frames * 2.0 * c6 * fc1_out)
    work.add("fc2", n * 2 * 2 * n_win * 2.0 * fc1_out * tracks)
    n_feat = 10 * tracks
    work.add("head", n * 2 * (2.0 * n_win * 10 * tracks + 2.0 * n_feat * n_models))
    return work


def gene_call_work(cfg: dict, traffic: dict) -> Work:
    """One gene call: ``genes_per_call`` spans of 200 windows, both
    orientations, fc1, fc2, the projection."""
    n = int(traffic["genes_per_call"])
    win = int(cfg["input_len"])
    offsets = list(range(0, 200 * 200, 200))
    span = offsets[-1] + win
    rc_offsets = [span - win - o for o in offsets]
    c6 = int(cfg["conv_channels"][-1])
    frames6 = int(cfg["conv6_frames"])
    fc1_out, tracks = int(cfg["fc1_out"]), int(cfg["tracks"])
    dt = int(cfg["bytes_per_value"])
    weights = beluga_weight_elems(cfg)
    f_f, c5_f, _ = _span_work(cfg, span, offsets)
    f_r, c5_r, _ = _span_work(cfg, span, rc_offsets)
    work = Work()
    work.add("conv", n * (f_f + f_r), n * 2 * span + weights["conv"] * dt + n * (c5_f + c5_r) * c6 * dt)
    n_windows = n * 2 * len(offsets)
    work.add("fc1", n_windows * 2.0 * c6 * frames6 * fc1_out,
             n * (c5_f + c5_r) * c6 * dt + weights["fc1"] * dt + n_windows * fc1_out * dt)
    work.add("fc2", n_windows * 2.0 * fc1_out * tracks)
    work.add("head", n * 2.0 * len(offsets) * 10 * tracks)
    return work


def train_call_work(cfg: dict, traffic: dict) -> Work:
    """One training call: the hessian product once, then per round the
    gradient and residual products over every feature (4 n K F)."""
    n, f, k = int(traffic["rows"]), 10 * int(cfg["tracks"]), int(cfg["tissue_models"])
    rounds = int(cfg["gblinear"]["num_round"])
    work = Work()
    work.add("hessian", 2.0 * n * f * k)
    # per round X is read once, the residual read and written once
    work.add("block", rounds * 4.0 * n * f * k, rounds * (n * f * 4 + 2 * n * k * 4 + 2 * f * k * 4))
    return work
