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

Backbone patching (the consensus cohort path): personal genomes of one gene
share a backbone span and differ from it at a few sites each.
:func:`conv6_patch_sites_plan` merges a sample's diff positions into at most
K 16-aligned sub-spans on the host, and :func:`conv6_phases_patch_sites`
runs the conv stack over those (N·K, 704) sub-spans only and splices their
frames into copies of the backbone's phase buffers.

Every conv runs on a CUDA kernel on the card: conv0 on ops/conv0.py when
the spans are int8 base codes (the serving path), every other conv on
ops/conv8.py, where conv1 and conv3 pool in their kernel's epilogue
(``conv8_relu_pool4``): no pool runs on its own, but for the first pool of
:func:`conv6_phases_patch_sites_c1`, whose conv1 activations are given
(:func:`conv6_from_conv1`); fc1 over uniformly strided windows on
ops/fc1.py. The span functions take (N, L, 4) one-hot spans, as the JAX
package's do, or (N, L) int8 codes of them. All indices are Python ints:
the serving path centres every variant at the same ``mutpos``.
"""

from __future__ import annotations

import torch

from ..models.beluga import BelugaParams, _conv0, _conv_relu, _conv_relu_pool4
from .fc1 import FC1_FRAMES, fc1_strided

#: conv6 frame f (phase ph) reads span inputs [16f + 4ph, 16f + 4ph + RF)
CONV6_RF = 310
CONV6_STRIDE = 16


def _pool4_from(x: torch.Tensor, phase: int) -> torch.Tensor:
    """Max-pool width/stride 4 starting at ``phase`` (floor remainder drop)."""
    n, l, c = x.shape
    usable = ((l - phase) // 4) * 4
    return x[:, phase : phase + usable, :].reshape(n, usable // 4, 4, c).amax(dim=2)


def conv1_acts(params: BelugaParams, spans: torch.Tensor) -> torch.Tensor:
    """conv0+conv1 activations of (N, L, 4) one-hot spans, or of (N, L) int8
    codes of them, -> (N, L-14, 320), unpooled."""
    h = _conv0(spans, params["conv0"])
    return _conv_relu(h, params["conv1"])


def _conv6_from_pool1(params: BelugaParams, p1: torch.Tensor, phases) -> dict[int, torch.Tensor]:
    """conv2..conv6 from pool-1 output -> {phase: (N, n_frames, 640)}; conv3
    pools each pool-2 phase in its kernel's epilogue."""
    h = _conv_relu(p1, params["conv2"])
    pooled = _conv_relu_pool4(h, params["conv3"], sorted(set(int(p) for p in phases)))
    return {ph: _conv_relu(_conv_relu(g, params["conv4"]), params["conv5"]) for ph, g in pooled.items()}


def conv6_from_conv1(params: BelugaParams, h: torch.Tensor, phases) -> dict[int, torch.Tensor]:
    """conv2..conv6 from conv1 activations aligned at span position 0 (the
    pooling lattice is anchored there) -> {phase: (N, n_frames, 640)}. Its
    first pool is the one that runs on its own: conv1 ran elsewhere."""
    return _conv6_from_pool1(params, _pool4_from(h, 0), phases)


def conv6_phases(params: BelugaParams, spans: torch.Tensor, phases) -> dict[int, torch.Tensor]:
    """conv1..conv6 over full spans ((N, L, 4) one-hot or (N, L) int8
    codes), once per pool2 phase; both pools run in the conv kernels'
    epilogues.

    Returns {phase: (N, n_frames, 640)}; the window at span offset ``o``
    occupies frames [(o//4 - ph)//4 : +106] of phase ``ph = (o//4) % 4``."""
    h = _conv0(spans, params["conv0"])
    return _conv6_from_pool1(params, _conv_relu_pool4(h, params["conv1"], (0,))[0], phases)


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
    sub-frame ``f'`` is span frame ``f' + s0/16``. ``alt_spans`` is (N, L, 4)
    one-hot or (N, L) int8 codes. The ref buffers are not modified: each
    patched phase is a copy."""
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


#: default sub-span length for multi-site patching: covers all conv6 frames
#: whose receptive field (310 bp) touches a diff range of width <=
#: PATCH_SUB_LEN - 672 after 16-alignment slack on both ends
PATCH_SUB_LEN = 704


def conv6_covering_start(a: int, b: int, span_len: int, phases, frame_counts) -> int | None:
    """16-aligned sub-span start ``s0`` such that the :data:`PATCH_SUB_LEN`-long
    sub-span's conv6 frames cover EVERY frame (of every phase in ``phases``)
    whose receptive field touches span positions ``[a, b]`` — or None when no
    aligned start covers them (range too wide for the sub-span, or the span's
    unaligned tail). Host-side planning helper for
    :func:`conv6_phases_patch_sites`."""
    s0 = 16 * ((a - CONV6_RF) // CONV6_STRIDE)
    s0 = max(0, min(s0, 16 * ((span_len - PATCH_SUB_LEN) // CONV6_STRIDE)))
    if s0 + PATCH_SUB_LEN > span_len:
        return None
    f0 = s0 // CONV6_STRIDE
    for ph in sorted(set(int(p) for p in phases)):
        f_lo, _ = conv6_frame_range(a, ph)
        _, f_hi = conv6_frame_range(b, ph)
        f_hi = min(f_hi, frame_counts[ph])  # exclusive
        cnt = (PATCH_SUB_LEN - 4 * ph - CONV6_RF) // CONV6_STRIDE + 1
        if f0 > max(f_lo, 0) or f0 + cnt < f_hi:
            return None
    return s0


#: conv1-recompute geometry for the layered patch: a diff range [a, b]
#: (width <= PATCH_SUB_LEN-672) perturbs conv1 activations [a-14, b]; a
#: C1_PATCH_BASES-wide base slice at d0 = clip(a-14, 0, L-C1_PATCH_BASES)
#: yields C1_PATCH_BASES-14 conv1 outputs covering them in every clip case
C1_PATCH_BASES = 80


def conv6_patch_sites_plan(
    diff_positions, span_len: int, phases, *, max_ranges: int = 32
) -> list[tuple[int, int]] | None:
    """Greedy plan: merge sorted ``diff_positions`` (span coords where a
    sample differs from its backbone) into <= ``max_ranges`` covering
    ranges. Each entry is ``(w0, d0)``: the 16-aligned sub-span start whose
    conv6 frames cover the range (:func:`conv6_phases_patch_sites` uses w0
    alone) and the base start of the :data:`C1_PATCH_BASES`-wide
    conv1-recompute slice (:func:`conv6_phases_patch_sites_c1`). Returns
    None when the record is not patchable (too many scattered sites, or an
    uncoverable alignment corner)."""
    pos = sorted(int(p) for p in diff_positions)
    if not pos:
        return []
    frame_counts = {
        ph: (span_len - 4 * ph - CONV6_RF) // CONV6_STRIDE + 1
        for ph in sorted(set(int(p) for p in phases))
    }
    width_max = PATCH_SUB_LEN - 672
    starts: list[tuple[int, int]] = []
    a = b = pos[0]
    for p in pos[1:] + [None]:
        if p is not None and p - a <= width_max:
            b = p
            continue
        s0 = conv6_covering_start(a, b, span_len, phases, frame_counts)
        if s0 is None or len(starts) >= max_ranges:
            return None
        d0 = max(0, min(a - 14, span_len - C1_PATCH_BASES))
        starts.append((s0, d0))
        if p is not None:
            a = b = p
    return starts


def _slices(x: torch.Tensor, starts: torch.Tensor, length: int) -> torch.Tensor:
    """(N, K, length, ...) slices ``x[i, s : s + length]`` of an (N, L, ...)
    tensor at each of the (N, K) ``starts``, each start clamped to
    [0, L - length] as ``lax.dynamic_slice_in_dim`` clamps it."""
    n, span_len = x.shape[:2]
    if length > span_len:
        raise ValueError(f"slices of {length} from spans of {span_len}")
    s = starts.to(device=x.device, dtype=torch.long).clamp(0, span_len - length)
    idx = s[:, :, None] + torch.arange(length, device=x.device)
    return x[torch.arange(n, device=x.device)[:, None, None], idx]


def _splice_rows(base: torch.Tensor, patches: torch.Tensor, starts: torch.Tensor, n: int) -> torch.Tensor:
    """(N, F, C) copies of ``base`` ((1 or N, F, C)) with ``patches`` (N, K,
    cnt, C) written at rows ``starts[i, k] + j``. Rows outside [0, F) are
    dropped, as the JAX scatter's ``mode="drop"`` drops them: they land on a
    spare row past the end that the result leaves out, so no index reaches
    ``index_put_`` out of range and none wraps around. The K slots are
    written one after another, the last one winning where ranges overlap,
    so a call gives the same bits every time."""
    f, c = base.shape[-2:]
    k, cnt = patches.shape[1:3]
    buf = torch.empty((n, f + 1, c), dtype=base.dtype, device=base.device)
    buf[:, :f] = base  # a copy per row: writing into an expanded view would alias every row
    rows = torch.arange(n, device=base.device)[:, None]
    idx = starts.to(device=base.device, dtype=torch.long)[:, :, None] + torch.arange(cnt, device=base.device)
    idx = torch.where((idx >= 0) & (idx < f), idx, f)
    patches = patches.to(base.dtype)
    for slot in range(k):
        buf[rows, idx[:, slot]] = patches[:, slot]
    return buf[:, :f]


def _splice_patch_frames(base_phases, sub_ph, f0: torch.Tensor, n: int, k: int, phases) -> dict[int, torch.Tensor]:
    """Scatter per-range conv6 frames (``sub_ph``: {phase: (N*K, cnt, C)})
    into copies of the backbone phase buffers at frame starts ``f0`` (N, K);
    frames past a buffer's end are dropped (:func:`_splice_rows`)."""
    out = {}
    for ph in phases:
        buf = base_phases[ph]
        patches = sub_ph[ph].reshape(n, k, -1, buf.shape[-1])
        out[ph] = _splice_rows(buf, patches, f0, n)
    return out


def conv6_phases_patch_sites(
    params: BelugaParams,
    base_phases: dict[int, torch.Tensor],
    alt_spans: torch.Tensor,
    range_starts: torch.Tensor,
    phases,
) -> dict[int, torch.Tensor]:
    """Per-sample conv6 phase buffers built from a shared BACKBONE span's
    buffers by recomputing only the frames around each sample's K diff
    ranges (the consensus cohort's features-only path).

    Args:
        base_phases: {phase: (1 or N, F_ph, C)} backbone conv6 buffers
            (not modified).
        alt_spans: (N, span_len) int8 codes of the samples, or (N,
            span_len, 4) one-hot; the (N·K, PATCH_SUB_LEN) sub-spans are gathered
            from them, so codes never become a float one-hot.
        range_starts: (N, K) integer 16-aligned sub-span starts from
            :func:`conv6_patch_sites_plan`. Every frame whose receptive
            field touches a backbone/sample difference must be covered by
            some range; inactive slots may point anywhere in the span (a
            superfluous patch recomputes frames from the sample's own bases).

    Returns {phase: (N, F_ph, C)} buffers equal (to fp reduction order) to
    ``conv6_phases(params, alt_spans, phases)``."""
    n = alt_spans.shape[0]
    k = range_starts.shape[1]
    phases = sorted(set(int(p) for p in phases))
    subs = _slices(alt_spans, range_starts, PATCH_SUB_LEN)  # (N, K, PATCH_SUB_LEN[, 4])
    sub_ph = conv6_phases(params, subs.reshape(n * k, PATCH_SUB_LEN, *subs.shape[3:]), phases)
    return _splice_patch_frames(base_phases, sub_ph, torch.div(range_starts, CONV6_STRIDE, rounding_mode="floor"),
                                n, k, phases)


def conv6_phases_patch_sites_c1(
    params: BelugaParams,
    base_c1: torch.Tensor,
    base_phases: dict[int, torch.Tensor],
    alt_spans: torch.Tensor,
    w0s: torch.Tensor,
    d0s: torch.Tensor,
    phases,
) -> dict[int, torch.Tensor]:
    """Layered variant of :func:`conv6_phases_patch_sites` that reuses the
    backbone's conv1 activations: conv0+conv1 are recomputed only on a
    :data:`C1_PATCH_BASES`-wide slice around each diff range, spliced into a
    per-sample copy of the backbone's conv1 buffer, and conv2..conv6 then
    run on (PATCH_SUB_LEN-14)-wide windows gathered from the patched buffer (after
    ALL conv1 patches are written, so a window overlapping a neighbour's
    mutated bases reads the recomputed values). The production path uses
    :func:`conv6_phases_patch_sites`.

    Args:
        base_c1: (1 or N, span_len-14, C1) backbone conv1 activations
            (:func:`conv1_acts` of the backbone span).
        base_phases: {phase: (1 or N, F_ph, C)} backbone conv6 buffers.
        alt_spans: (N, span_len) int8 codes or (N, span_len, 4) one-hot.
        w0s / d0s: (N, K) ``(w0, d0)`` columns of
            :func:`conv6_patch_sites_plan`'s ranges; inactive slots 0.

    Returns {phase: (N, F_ph, C)} buffers equal (to fp reduction order) to
    ``conv6_phases(params, alt_spans, phases)``."""
    n = alt_spans.shape[0]
    k = w0s.shape[1]
    phases = sorted(set(int(p) for p in phases))
    win = PATCH_SUB_LEN - 14
    slices = _slices(alt_spans, d0s, C1_PATCH_BASES)
    c1_patch = conv1_acts(params, slices.reshape(n * k, C1_PATCH_BASES, *slices.shape[3:]))
    c1 = _splice_rows(base_c1, c1_patch.reshape(n, k, C1_PATCH_BASES - 14, -1), d0s, n)
    wins = _slices(c1, w0s, win)  # (N, K, win, C1)
    sub_ph = conv6_from_conv1(params, wins.reshape(n * k, win, wins.shape[-1]), phases)
    return _splice_patch_frames(base_phases, sub_ph, torch.div(w0s, CONV6_STRIDE, rounding_mode="floor"), n, k, phases)


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
    standard 200-bp shift grids) fc1 is one strided product over the phase
    buffer (ops/fc1.py: the tensor-core kernel in bf16 on the card, which
    reads the windows in place); other offsets take one matmul per window."""
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
            frames = fc1_strided(buf, fc1_w, s_sorted[0], strides.pop(), len(s_sorted))
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

    ``spans``: (N, span_len, 4) one-hot or (N, span_len) int8 codes;
    ``offsets``: window starts, each a
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
