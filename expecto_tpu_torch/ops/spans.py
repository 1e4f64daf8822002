"""Span-amortized Beluga forward: share convolution work across overlapping
shift windows (port of the serving half of expecto_tpu/ops/spans.py).

The variant path evaluates Beluga on windows taken at 200-bp strides from
one contiguous span (9 shifts over 3.6 kb at ``maxshift`` 800). Valid
convolutions are shift-covariant, so conv0..conv3 run **once over the whole
span** and each window's activation is a slice. The two 4-wide max-pools
constrain alignment:

- pool1 (stride 4): window offsets are multiples of 200 ≡ 0 (mod 4) — one
  shared pooled span.
- pool2 (stride 16 in base coords): offsets/4 are multiples of 50 ≡ {0, 2}
  (mod 4) — two pooling phases; conv4/conv5 run once per phase.

After conv5 each window is a 106-frame slice of its phase buffer; fc1 runs
as a strided product over those buffers.

Incremental alt scoring: conv6 frame ``f`` of phase ``ph`` depends only on
span inputs ``[16f + 4ph, 16f + 4ph + 310)``, so a substitution perturbs
~20 frames. :func:`conv6_phases_patch` recomputes just those frames from a
short 16-aligned sub-span and splices them into the reference allele's
buffers; :func:`fc1_delta_from_phases` then adds the fc1 change of only
those frames.

Every conv goes through ops/conv8.py (the CUDA kernel on the card). All
indices are Python ints: the serving path centres every variant at the same
``mutpos``.
"""

from __future__ import annotations

import torch

from ..models.beluga import BelugaParams, _conv_relu

#: conv6 frame f (phase ph) reads span inputs [16f + 4ph, 16f + 4ph + RF)
CONV6_RF = 310
CONV6_STRIDE = 16
FC1_FRAMES = 106


def _pool4_from(x: torch.Tensor, phase: int) -> torch.Tensor:
    """Max-pool width/stride 4 starting at ``phase`` (floor remainder drop)."""
    n, l, c = x.shape
    usable = ((l - phase) // 4) * 4
    return x[:, phase : phase + usable, :].reshape(n, usable // 4, 4, c).amax(dim=2)


def conv1_acts(params: BelugaParams, spans: torch.Tensor) -> torch.Tensor:
    """conv0+conv1 activations of (N, L, 4) spans -> (N, L-14, 320)."""
    h = _conv_relu(spans, params["conv0"])
    return _conv_relu(h, params["conv1"])


def conv6_from_conv1(params: BelugaParams, h: torch.Tensor, phases) -> dict[int, torch.Tensor]:
    """conv2..conv6 from conv1 activations aligned at span position 0 (the
    pooling lattice is anchored there) -> {phase: (N, n_frames, 640)}."""
    p1 = _pool4_from(h, 0)
    h = _conv_relu(p1, params["conv2"])
    h = _conv_relu(h, params["conv3"])
    out = {}
    for ph in sorted(set(int(p) for p in phases)):
        g = _conv_relu(_pool4_from(h, ph), params["conv4"])
        out[ph] = _conv_relu(g, params["conv5"])
    return out


def conv6_phases(params: BelugaParams, spans: torch.Tensor, phases) -> dict[int, torch.Tensor]:
    """conv1..conv6 over full spans, once per pool2 phase.

    Returns {phase: (N, n_frames, 640)}; the window at span offset ``o``
    occupies frames [(o//4 - ph)//4 : +106] of phase ``ph = (o//4) % 4``."""
    return conv6_from_conv1(params, conv1_acts(params, spans), phases)


def conv6_frame_range(mutpos: int, ph: int) -> tuple[int, int]:
    """[f_lo, f_hi) conv6 frames of phase ``ph`` whose receptive field
    contains span position ``mutpos``."""
    f_lo = max(0, -(-(mutpos - CONV6_RF + 1 - 4 * ph) // CONV6_STRIDE))
    f_hi = (mutpos - 4 * ph) // CONV6_STRIDE + 1
    return f_lo, max(f_hi, f_lo)


def conv6_patch_ranges(mutpos: int, mut_len: int, phases, frame_counts: dict[int, int]) -> dict[int, tuple[int, int]]:
    """{phase: [f_lo, f_hi)} conv6 frames affected by a mutation at
    ``[mutpos, mutpos + mut_len)``."""
    ranges = {}
    for ph in sorted(set(int(p) for p in phases)):
        f_lo, _ = conv6_frame_range(mutpos, ph)
        _, f_hi = conv6_frame_range(mutpos + mut_len - 1, ph)
        ranges[ph] = (f_lo, min(f_hi, frame_counts[ph]))
    return ranges


def conv6_patch_subspan(ranges: dict[int, tuple[int, int]], span_len: int) -> tuple[int, int]:
    """[s0, s1): the 16-aligned sub-span whose conv stack recomputes the
    conv6 frames of ``ranges`` ({phase: [f_lo, f_hi)})."""
    in_lo = min(CONV6_STRIDE * f_lo + 4 * ph for ph, (f_lo, _) in ranges.items())
    in_hi = max(CONV6_STRIDE * (f_hi - 1) + 4 * ph + CONV6_RF for ph, (_, f_hi) in ranges.items())
    return max(0, (in_lo // CONV6_STRIDE) * CONV6_STRIDE), min(span_len, in_hi)


def conv6_phases_patch(
    params: BelugaParams,
    ref_phases: dict[int, torch.Tensor],
    alt_spans: torch.Tensor,
    mutpos: int,
    mut_len: int,
    phases,
) -> dict[int, torch.Tensor]:
    """Phase buffers for the alt allele by recomputing only the conv6 frames
    whose receptive field overlaps ``[mutpos, mutpos + mut_len)``.

    A 16-aligned sub-span covering those frames' receptive fields runs
    through the conv stack; its pool phases align with the full span's, so
    sub-frame ``f'`` is span frame ``f' + s0/16``. The ref buffers are not
    modified: each patched phase is a copy."""
    phases = sorted(set(int(p) for p in phases))
    ranges = conv6_patch_ranges(mutpos, mut_len, phases, {ph: ref_phases[ph].shape[1] for ph in phases})
    s0, s1 = conv6_patch_subspan(ranges, alt_spans.shape[1])
    sub_phases = conv6_phases(params, alt_spans[:, s0:s1], phases)

    out = {}
    for ph in phases:
        f_lo, f_hi = ranges[ph]
        buf = ref_phases[ph]
        if f_hi <= f_lo:
            out[ph] = buf
            continue
        sub_lo = f_lo - s0 // CONV6_STRIDE
        patched = buf.clone()
        patched[:, f_lo:f_hi] = sub_phases[ph][:, sub_lo : sub_lo + f_hi - f_lo].to(buf.dtype)
        out[ph] = patched
    return out


def _window_starts_by_phase(offsets) -> dict[int, list[tuple[int, int]]]:
    """{phase: [(output_index, start_frame), ...]} for the shift windows."""
    per_phase: dict[int, list[tuple[int, int]]] = {}
    for i, o in enumerate(int(o) for o in offsets):
        ph = (o // 4) % 4
        per_phase.setdefault(ph, []).append((i, (o // 4 - ph) // 4))
    return per_phase


def _fc1_kernel(params: BelugaParams, dtype) -> torch.Tensor:
    """fc1 as a (106, 640, 2003) kernel: the length-major matrix reshaped."""
    return params["fc1"]["w"].to(dtype).reshape(FC1_FRAMES, -1, params["fc1"]["b"].shape[0])


def fc1_pre_from_phases(params: BelugaParams, phase_conv6: dict[int, torch.Tensor], offsets) -> torch.Tensor:
    """fc1 pre-activations (no bias/relu) per window: (N, n_offsets, 2003).

    When the window starts within a phase are uniformly strided (the
    standard 200-bp shift grids) the windows are one strided ``unfold`` of
    the phase buffer and fc1 is one matmul over them; other offsets take
    one matmul per window."""
    offsets = [int(o) for o in offsets]
    first = next(iter(phase_conv6.values()))
    n, dtype = first.shape[0], first.dtype
    fc1_w = params["fc1"]["w"].to(dtype)

    h1_cols = [None] * len(offsets)
    for ph, items in _window_starts_by_phase(offsets).items():
        starts = [s for _, s in items]
        order = sorted(range(len(starts)), key=lambda j: starts[j])
        s_sorted = [starts[j] for j in order]
        strides = {s_sorted[j + 1] - s_sorted[j] for j in range(len(s_sorted) - 1)}
        buf = phase_conv6[ph]
        if len(s_sorted) > 1 and len(strides) == 1 and min(strides) > 0:
            stride = strides.pop()
            # (N, n_win, C, 106) windows -> length-major (N, n_win, 106*C)
            wins = buf[:, s_sorted[0] :].unfold(1, FC1_FRAMES, stride)[:, : len(s_sorted)]
            frames = wins.transpose(2, 3).reshape(n, len(s_sorted), -1) @ fc1_w
            for rank, j in enumerate(order):
                h1_cols[items[j][0]] = frames[:, rank, :]
        else:
            for i, s in items:
                h1_cols[i] = buf[:, s : s + FC1_FRAMES].reshape(n, -1) @ fc1_w
    return torch.stack(h1_cols, dim=1)


def fc1_delta_from_phases(
    params: BelugaParams,
    ref_phases: dict[int, torch.Tensor],
    alt_phases: dict[int, torch.Tensor],
    patch_ranges: dict[int, tuple[int, int]],
    offsets,
) -> torch.Tensor:
    """Incremental fc1: the (N, n_offsets, 2003) pre-activation *delta*
    between alt and ref phase buffers that differ only inside
    ``patch_ranges`` (fc1 is linear before relu, so
    ``fc1_pre(alt) == fc1_pre(ref) + delta``)."""
    offsets = [int(o) for o in offsets]
    first = next(iter(ref_phases.values()))
    n, dtype = first.shape[0], first.dtype
    fc1_kernel = _fc1_kernel(params, dtype)

    cols = [None] * len(offsets)
    for ph, items in _window_starts_by_phase(offsets).items():
        f_lo, f_hi = patch_ranges[ph]
        if f_hi <= f_lo:
            continue
        diff = alt_phases[ph][:, f_lo:f_hi] - ref_phases[ph][:, f_lo:f_hi]  # (N, P, 640)
        for i, s in items:
            a = max(f_lo, s)
            b = min(f_hi, s + FC1_FRAMES)
            if b <= a:
                continue
            d = diff[:, a - f_lo : b - f_lo].reshape(n, -1)
            cols[i] = d @ fc1_kernel[a - s : b - s].reshape(-1, fc1_kernel.shape[-1])
    zero = torch.zeros((n, fc1_kernel.shape[-1]), dtype=dtype, device=first.device)
    return torch.stack([c if c is not None else zero for c in cols], dim=1)


def fc_head(params: BelugaParams, h1_pre: torch.Tensor) -> torch.Tensor:
    """bias + relu + fc2 + sigmoid over (N, n_offsets, 2003) fc1 pre-acts."""
    dtype = h1_pre.dtype
    h = torch.relu(h1_pre + params["fc1"]["b"].to(dtype))
    return torch.sigmoid(h @ params["fc2"]["w"].to(dtype) + params["fc2"]["b"].to(dtype))


def fc_from_phases(params: BelugaParams, phase_conv6: dict[int, torch.Tensor], offsets) -> torch.Tensor:
    """Dense layers per window from the conv6 phase buffers."""
    return fc_head(params, fc1_pre_from_phases(params, phase_conv6, offsets))


def beluga_forward_spans(params: BelugaParams, spans: torch.Tensor, offsets) -> torch.Tensor:
    """Forward over 2,000-bp windows ``spans[:, o : o+2000, :]`` per offset.

    ``spans``: (N, span_len, 4) one-hot; ``offsets``: window starts, each a
    multiple of 4. Returns (N, n_offsets, 2002) track probabilities matching
    ``beluga_forward`` applied per window."""
    offsets = [int(o) for o in offsets]
    for o in offsets:
        if o % 4 != 0:
            raise ValueError(f"offset {o} not aligned to pool1 stride 4")
    phase_conv6 = conv6_phases(params, spans, {(o // 4) % 4 for o in offsets})
    return fc_from_phases(params, phase_conv6, offsets)


def span_offsets_for_shifts(shifts) -> tuple[list[int], int]:
    """Map a shift enumeration to (window offsets within the span, span_len
    extra) — offset of shift s = s - min(shifts)."""
    shifts = [int(s) for s in shifts]
    lo = min(shifts)
    return [s - lo for s in shifts], max(shifts) - lo
