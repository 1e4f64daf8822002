"""fc1 of Beluga as a strided product over a conv6 phase buffer.

    y[n, w, :] = buf[n, s0 + w*stride : + 106, :].reshape(-1) @ W

buf (N, F, C) channels last, W (106*C, Nout) the length-major fc1 matrix ->
y (N, n_win, Nout): the pre-activations (no bias or ReLU) of n_win windows
106 frames long, ``stride`` frames apart from frame ``s0``. It is the
strided valid convolution ``lax.conv_general_dilated`` of
``expecto_tpu/ops/spans.py::fc1_pre_from_phases`` (:421), an XLA step of
the JAX package. :func:`fc1_strided` picks an implementation by
:func:`_route`, a pure function of device, dtype and M = N * n_win:

- ``"tc"``: ``csrc/fc1_strided_tc.cu``, CUDA bf16 on the tensor cores
  (wgmma), the production dtype of every CLI;
- CUDA fp32 (parity mode) on the TF32 tensor cores in three passes: each
  operand split into a TF32 hi and lo (:func:`split_tf32`), lo*hi + hi*lo
  + hi*hi summed in fp32, held to fp32's limits, as the JAX package runs
  the product at ``Precision.HIGHEST``. ``"tf32x3_swap"`` for M <=
  :data:`SWAP_MAX_M` (bound by W's bytes): the windows split once a call by
  ``csrc/fc1_split_tf32.cu`` (:func:`split_planes`), then
  ``csrc/fc1_strided_tf32x3_swap.cu``, W^T x windows^T with fp32 W
  streamed once and split in the kernel; ``"tf32x3"`` above it (bound by
  the operations): ``csrc/fc1_strided_tf32x3.cu``, W split once per weight
  tensor, the windows split in the kernel;
- ``"cpu"``: :func:`fc1_strided_plain`, only for tensors on the CPU.

The kernels read the windows (or their split planes) in place, never
copied out, take W packed once per weight tensor, frame walk and route
(:func:`pack_weights_fc1`, :func:`pack_weights_tf32x3`,
:func:`pack_weights_tf32x3_swap`), and walk the fixed persistent schedule
of :func:`fc1_schedule` at their own tile constants (:data:`TILES`). A CUDA
tensor launches its route's kernels or raises (any other CUDA dtype
raises): nothing falls back to a matmul.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_build

FC1_FRAMES = 106
ROUTES = ("tc", "tf32x3", "tf32x3_swap")
#: the largest M (windows a call) that fp32 takes to the swapped kernel: one
#: window tile of at most 64, where streaming fp32 W once beats the tf32x3
#: kernel (PERF.md, section 6)
SWAP_MAX_M = 64
_MAX_ROWS = 2**31 - 1  # N * n_win: the kernels index rows with an int


class Tiles(NamedTuple):
    """A kernel's tile constants, which its packing and schedule follow."""

    bn: int  # columns per tile; W's columns are zero-padded to a multiple of it
    kc: int  # K per stage (one 128-byte row); W's rows are zero-padded to a multiple of it
    min_chunks: int  # the fewest K chunks a group of the schedule walks
    tm: int  # the most rows (windows) a tile holds


#: each route's kernel instance: bf16 128 x 256 tiles 64 deep; fp32 128 x
#: 128 tiles 32 deep; the swapped fp32 kernel 128 W columns by at most 64
#: windows, 32 deep (a group walks at least 2,048 K in all three)
TILES = {"tc": Tiles(256, 64, 32, 128), "tf32x3": Tiles(128, 32, 64, 128), "tf32x3_swap": Tiles(128, 32, 64, 64)}
KERNELS = {"tc": "fc1_strided_tc", "tf32x3": "fc1_strided_tf32x3", "tf32x3_swap": "fc1_strided_tf32x3_swap"}
_KC, _MIN_CHUNKS = TILES["tc"].kc, TILES["tc"].min_chunks  # the bf16 kernel's


def _windows(buf: torch.Tensor, s0: int, stride: int, n_win: int) -> torch.Tensor:
    """(N, n_win, 106*C): the windows, length-major, as one copied tensor."""
    n = buf.shape[0]
    wins = buf[:, s0:].unfold(1, FC1_FRAMES, stride)[:, :n_win]  # (N, n_win, C, 106)
    if wins.shape[1] != n_win:
        raise ValueError(f"{n_win} windows of {FC1_FRAMES} frames {stride} apart from frame {s0} overrun "
                         f"{buf.shape[1]} frames")
    return wins.transpose(2, 3).reshape(n, n_win, -1)


def fc1_strided_plain(buf: torch.Tensor, w: torch.Tensor, s0: int, stride: int, n_win: int) -> torch.Tensor:
    """Plain PyTorch version: the windows ``unfold``-ed into one (N, n_win,
    106*C) tensor and one matmul, summed in fp32 and rounded once to
    buf's dtype."""
    a = _windows(buf, s0, stride, n_win)
    return (a.float() @ w.float()).to(buf.dtype)


def frame_order(frames: int, period: int) -> list[int]:
    """The order in which the kernel walks a window's frames: r, r +
    period, r + 2 period, ... for r = 0 .. period - 1 (period 1: in order).
    At period = stride, neighbouring windows read each buffer frame a few
    stages apart."""
    return [f for r in range(period) for f in range(r, frames, period)]


def walk_period(c: int, stride: int, kc: int = _KC) -> int:
    """The period of a kernel's frame walk for C channels and this stride:
    the stride where a ``kc``-deep K chunk lies inside one frame (C % kc ==
    0) and windows overlap, else 1 (K in order)."""
    return stride if c % kc == 0 and 1 < stride < FC1_FRAMES else 1


def _layout(w: torch.Tensor, period: int, tiles: Tiles) -> torch.Tensor:
    """W (K, Nout) as (Nout/bn, K/kc, bn, 8, kc/8), a view of a copy: K
    chunks in the walk order of :func:`frame_order` at ``period`` (1: in
    order), each output column of a (column tile, K chunk) a 128-byte K-major
    row of 8 16-byte pieces, piece g stored in slot g ^ (column % 8) (the
    128-byte swizzle of the wgmma descriptors), zero-padded to whole tiles
    and chunks."""
    k, n_out = w.shape
    bn, kc = tiles.bn, tiles.kc
    nt, chunks = -(-n_out // bn), -(-k // kc)
    if period > 1:
        c = k // FC1_FRAMES
        if k != FC1_FRAMES * c or c % kc:
            raise ValueError(f"a frame walk of period {period} needs K = {FC1_FRAMES} * C with C % {kc} == 0, "
                             f"got K = {k}")
        order = torch.tensor(frame_order(FC1_FRAMES, period), device=w.device)
        w = w.reshape(FC1_FRAMES, c, n_out).index_select(0, order).reshape(k, n_out)
    wp = F.pad(w, (0, nt * bn - n_out, 0, chunks * kc - k))
    wp = wp.reshape(chunks, 8, kc // 8, nt, bn // 8, 8)  # chunk, piece, e, tile, column / 8, column % 8
    wp = wp.permute(3, 0, 4, 5, 1, 2)  # tile, chunk, column / 8, column % 8, piece, e
    lo = torch.arange(8, device=w.device)
    wp = wp[:, :, :, lo[:, None], lo[None, :] ^ lo[:, None]]  # slot s of column % 8 = lo holds piece s ^ lo
    return wp.reshape(nt, chunks, bn, 8, kc // 8)


def pack_weights_fc1(w: torch.Tensor, period: int = 1) -> torch.Tensor:
    """W (K, Nout) bf16 in the tc kernel's layout: (Nout/256, K/64, 256, 8,
    8), one contiguous shared-memory stage per (column tile, K chunk) (see
    :func:`_layout`). Nout is zero-padded to a multiple of 256 (2,003 ->
    2,048) and K to one of 64 (Beluga's 67,840 is already)."""
    return _layout(w, period, TILES["tc"]).contiguous()


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``x``: hi = x rounded to TF32 and lo = (x - hi)
    rounded to TF32, both to nearest with ties away from zero (the kernel's
    ``cvt.rna.tf32.f32``), as fp32 tensors whose low 13 mantissa bits are
    zero; hi + lo is x within 2^-22 |x|. Integer ops on the bits: adding
    half a TF32 step (2^12) to the magnitude carries into the kept bits
    exactly when rounding goes up."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def pack_weights_tf32x3(w: torch.Tensor, period: int = 1) -> torch.Tensor:
    """W (K, Nout) fp32 split (:func:`split_tf32`) into the tf32x3 kernel's
    layout: (Nout/128, K/32, 2, 128, 8, 4), one contiguous shared-memory
    stage per (column tile, K chunk) holding hi, then lo, each in the layout
    of :func:`_layout`. Nout is zero-padded to a multiple of 128 (2,003 ->
    2,048) and K to one of 32. At Beluga's widths, 1.11 GB."""
    hi, lo = split_tf32(w)
    tiles = TILES["tf32x3"]
    return torch.stack((_layout(hi, period, tiles), _layout(lo, period, tiles)), dim=2).contiguous()


def pack_weights_tf32x3_swap(w: torch.Tensor, period: int = 1) -> torch.Tensor:
    """W (K, Nout) fp32 in the swapped kernel's layout: (Nout/128, K/32,
    128, 8, 4), one contiguous 16 KB stage per (column tile, K chunk), each
    output column a 128-byte K-major row (:func:`_layout`): the form of
    wgmma's A operand. Not split: the kernel splits it in registers. Nout
    is zero-padded to a multiple of 128 and K to one of 32. At Beluga's
    widths, 0.556 GB (530 MiB)."""
    return _layout(w, period, TILES["tf32x3_swap"]).contiguous()


_PACKERS = {"tc": pack_weights_fc1, "tf32x3": pack_weights_tf32x3, "tf32x3_swap": pack_weights_tf32x3_swap}


def streamed_bytes(route: str, n: int, n_win: int, stride: int, c: int, n_out: int) -> int:
    """The bytes that ``route``'s launches for one call move at the least:
    its packed W read once (bf16; fp32 split: hi and lo; swapped: fp32),
    the frames the windows cover (swapped: read by the split pass, written
    as two planes and read back by the kernel) and y written once."""
    tiles = TILES[route]
    k, span = FC1_FRAMES * c, (n_win - 1) * stride + FC1_FRAMES
    w_elems = -(-k // tiles.kc) * tiles.kc * -(-n_out // tiles.bn) * tiles.bn
    size = 2 if route == "tc" else 4
    frames = n * span * c * size * (5 if route == "tf32x3_swap" else 1)
    return w_elems * size * (2 if route == "tf32x3" else 1) + frames + n * n_win * n_out * size


_PACKED: dict[tuple[int, int, str], tuple] = {}  # (id(W), period, route) -> (weakref to W, W._version, packed W)


def _packed(w: torch.Tensor, period: int = 1, route: str = "tc") -> torch.Tensor:
    """W packed for ``route``'s kernel at ``period``, kept while w lives and
    is not written to: a runner's fc1 weight is packed once, not at every
    launch."""
    key = (id(w), period, route)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    wp = _PACKERS[route](w, period)
    _PACKED[key] = (weakref.ref(w, lambda _ref: _PACKED.pop(key, None)), w._version, wp)
    return wp


def _route(device_type: str, dtype: torch.dtype, m: int) -> str:
    """Which implementation runs a buffer of this device type and dtype for
    M = ``m`` windows: "cpu", "tc" (CUDA bf16), "tf32x3_swap" (CUDA fp32, M
    <= SWAP_MAX_M) or "tf32x3" (CUDA fp32 above it; module docstring). No
    flow computes in another dtype on the card: such a buffer raises."""
    if device_type == "cpu":
        return "cpu"
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "tf32x3_swap" if m <= SWAP_MAX_M else "tf32x3"
    raise TypeError(f"fc1's kernels take bfloat16 or float32 on {device_type}, got {dtype}")


class Schedule(NamedTuple):
    """The kernel's persistent schedule (see :func:`fc1_schedule`)."""

    tile_rows: int  # rows of A a CTA's tile holds (at most 128)
    rows: int  # CTAs of a group along the row tiles (row tiles ``rows`` apart past that)
    cols: int  # column tiles a group's block: CTAs of a group along the columns
    groups: int  # equal ranges of (column block, K chunk) positions


def fc1_schedule(m: int, n_out: int, k: int, ctas: int, *, tiles: Tiles = TILES["tc"], groups: int | None = None,
                 cols: int | None = None, tile_rows: int | None = None) -> Schedule:
    """A kernel's persistent schedule for M = ``m`` rows on a card that
    holds ``ctas`` CTAs of it at once (one an SM), at the kernel's
    ``tiles``: ``groups`` x ``rows`` x ``cols`` CTAs. The rows are cut into
    balanced row tiles of ``tile_rows`` (at most ``tiles.tm``); the (column block, K
    chunk) positions, P = (Nout/bn / cols) x K/kc, are cut into ``groups``
    equal ranges, and each CTA of a
    group takes one row tile and one column tile of each block of ``cols``
    over its group's range, in step with the others (see
    :func:`schedule_units`). Picks the ``cols`` (a divisor of the column
    tiles) and ``groups`` that keep the most CTAs busy, with at least
    ``tiles.min_chunks`` K chunks a group; on a tie the larger ``cols`` (the
    windows read by fewer CTAs). ``groups``, ``cols`` or ``tile_rows`` given
    are kept (the probe's knobs). A pure function of the shape and the
    card's CTAs, so a shape gives the same bits every call."""
    if tile_rows is None:
        tile_rows = -(-m // -(-m // tiles.tm))
    elif not 0 < tile_rows <= tiles.tm:
        raise ValueError(f"tile_rows = {tile_rows}: a tile holds 1 to {tiles.tm} rows")
    tiles_n, kt = -(-n_out // tiles.bn), -(-k // tiles.kc)
    rows = min(-(-m // tile_rows), ctas)
    if cols is not None and (cols <= 0 or tiles_n % cols):
        raise ValueError(f"cols = {cols} does not divide {tiles_n} column tiles")
    best = None
    for c in ([cols] if cols is not None else [c for c in range(1, tiles_n + 1) if tiles_n % c == 0]):
        if cols is None and c > 1 and rows * c > ctas:
            continue
        positions = tiles_n // c * kt
        q = groups if groups is not None else min(max(1, ctas // (rows * c)), max(1, positions // tiles.min_chunks))
        q = max(1, min(q, positions))
        key = (min(q * rows * c, ctas), c)
        if best is None or key > best[0]:
            best = (key, Schedule(tile_rows, rows, c, q))
    return best[1]


def schedule_units(m: int, n_out: int, k: int, sched: Schedule, tiles: Tiles = TILES["tc"]) -> list[tuple]:
    """The kernel's work list, as its CTAs walk it: (CTA, row tile, column
    tile, first K chunk, end K chunk, slot), slot None where the CTA stores
    the whole tile and 2q or 2q + 1 (group q's first or last column block)
    where it writes an fp32 part for the second pass; in the order that
    each CTA takes them. Row tile i holds rows i * tile_rows .. + tile_rows
    - 1 below M."""
    tile_rows, rows, cols, groups = sched
    tiles_m = -(-m // tile_rows)
    tiles_n, kt = -(-n_out // tiles.bn), -(-k // tiles.kc)
    positions = tiles_n // cols * kt
    units = []
    for cta in range(groups * rows * cols):
        q, idx = divmod(cta, rows * cols)
        cc, i0 = divmod(idx, rows)
        start, end = q * positions // groups, (q + 1) * positions // groups
        for i in range(i0, tiles_m, rows):
            x = start
            while x < end:
                cb = x // kt
                xe = min(end, (cb + 1) * kt)
                k0, k1 = x - cb * kt, xe - cb * kt
                slot = None if (k0, k1) == (0, kt) else 2 * q + (x != start)
                units.append((cta, i, cb * cols + cc, k0, k1, slot))
                x = xe
    return units


def resident_ctas(device: torch.device) -> int:
    """How many CTAs of the kernel ``device`` runs at once: one an SM (its
    shared memory and registers fill one)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(buf: torch.Tensor, w: torch.Tensor, s0: int, stride: int, n_win: int) -> None:
    """Raises on an input the kernels do not take: dtype (bf16 or fp32, buf
    and W alike), shape, window range, layout, alignment (16-byte rows:
    C % 8 == 0 in bf16, C % 4 == 0 in fp32), then device."""
    if buf.dtype not in (torch.bfloat16, torch.float32) or w.dtype != buf.dtype:
        raise TypeError(f"the fc1 kernels take bfloat16 or float32 buf and W of one dtype, got {buf.dtype}, "
                        f"{w.dtype}")
    if buf.dim() != 3 or w.dim() != 2:
        raise ValueError(f"the fc1 kernel takes buf (N, F, C) and W (106*C, Nout), got {tuple(buf.shape)}, "
                         f"{tuple(w.shape)}")
    n, f, c = buf.shape
    if w.shape[0] != FC1_FRAMES * c or w.shape[1] <= 0:
        raise ValueError(f"W {tuple(w.shape)} does not match {FC1_FRAMES} frames of {c} channels")
    per = 16 // buf.element_size()  # elements in 16 bytes
    if c % per:
        raise ValueError(f"the {buf.dtype} fc1 kernel takes C % {per} == 0 (16-byte rows), got C = {c}")
    if n <= 0 or n_win <= 0 or stride <= 0 or s0 < 0 or s0 + (n_win - 1) * stride + FC1_FRAMES > f:
        raise ValueError(f"{n_win} windows of {FC1_FRAMES} frames {stride} apart from frame {s0} do not fit "
                         f"{n} samples of {f} frames")
    if n * n_win > _MAX_ROWS:
        raise ValueError(f"the fc1 kernel takes N * n_win <= {_MAX_ROWS}, got {n * n_win}")
    if buf.stride(2) != 1 or buf.stride(1) != c or buf.stride(0) % per or not w.is_contiguous():
        raise ValueError(f"the fc1 kernel takes buf with contiguous rows of C channels and samples a multiple of "
                         f"{per} elements apart, and contiguous W; got strides {buf.stride()}")
    if buf.data_ptr() % 16:
        raise ValueError(f"the fc1 kernel takes a 16-byte-aligned buf, got data pointer {buf.data_ptr():#x}")
    if buf.device.type != "cuda" or w.device != buf.device:
        raise ValueError(f"the fc1 kernel takes buf and W on one CUDA device, got {buf.device}, {w.device}")


def split_planes_plain(buf: torch.Tensor, s0: int, span: int) -> torch.Tensor:
    """Plain PyTorch version of the split pass: frames s0 .. s0 + span - 1
    of fp32 ``buf`` (N, F, C) as (2, N, span, C), :func:`split_tf32`'s hi
    then lo."""
    return torch.stack(split_tf32(buf[:, s0 : s0 + span]))


def split_planes(buf: torch.Tensor, s0: int, span: int) -> torch.Tensor:
    """The swapped fp32 kernel's split pass (``csrc/fc1_split_tf32.cu``): frames s0
    .. s0 + span - 1 of each sample of fp32 ``buf`` (N, F, C) cut once into
    TF32 hi and lo planes, (2, N, span, C) contiguous, equal bit for bit to
    :func:`split_planes_plain`, which a CPU tensor takes. buf is read in
    place (a splice view too): rows of C % 4 == 0 channels, samples a
    multiple of 4 elements apart, 16-byte aligned."""
    if buf.device.type == "cpu":
        return split_planes_plain(buf, s0, span)
    n, f, c = buf.shape
    if (buf.dtype != torch.float32 or c % 4 or buf.stride(2) != 1 or buf.stride(1) != c or buf.stride(0) % 4
            or buf.data_ptr() % 16 or not 0 <= s0 < s0 + span <= f):
        raise ValueError(f"the split pass takes fp32 buf (N, F, C) with contiguous 16-byte rows, samples a multiple "
                         f"of 4 elements apart, and frames {s0} .. {s0 + span - 1} inside its {f}; got {buf.dtype}, "
                         f"strides {buf.stride()}, data pointer {buf.data_ptr():#x}")
    planes = torch.empty((2, n, span, c), device=buf.device, dtype=torch.float32)
    with torch.cuda.device(buf.device):
        err = cuda_build.launcher("fc1_split_tf32", 6, n_ptrs=3)(
            buf.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(), n, buf.stride(0), c, s0, span,
            8 * resident_ctas(buf.device), torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fc1 split pass launch failed: error {err}")
    split_planes.launches += 1
    return planes


def fc1_strided(buf: torch.Tensor, w: torch.Tensor, s0: int, stride: int, n_win: int) -> torch.Tensor:
    """fc1's pre-activations of ``n_win`` windows of 106 frames ``stride``
    frames apart from frame ``s0`` of each sample of ``buf`` (N, F, C):
    (N, n_win, Nout) in buf's dtype. CPU tensors take the plain version;
    CUDA bf16 the tc kernel; CUDA fp32 the split pass and the swapped
    kernel (M <= SWAP_MAX_M), or the tf32x3 kernel (each raising on
    anything it does not take, and if a launch fails)."""
    s0, stride, n_win = int(s0), int(stride), int(n_win)
    n, f, c = buf.shape
    route = _route(buf.device.type, buf.dtype, n * n_win)
    if route == "cpu":
        return fc1_strided_plain(buf, w, s0, stride, n_win)
    _check(buf, w, s0, stride, n_win)
    y = _launch(route, buf, w, s0, stride, n_win)
    fc1_strided.launches += 1
    fc1_strided.launches_by_route[route] += 1
    fc1_strided.launches_by_shape[(str(buf.dtype).removeprefix("torch."), n, f, c, s0, stride, n_win, w.shape[1])] += 1
    return y


def _launch(route: str, buf: torch.Tensor, w: torch.Tensor, s0: int, stride: int, n_win: int) -> torch.Tensor:
    """Launches ``route``'s kernel (after the split pass for the swapped
    kernel) on a checked CUDA input; counts nothing. :func:`fc1_strided` calls it with
    the route of :func:`_route`; ``scripts/probe_fc1_torch.py`` times both
    fp32 routes through it at each M."""
    n, _f, c = buf.shape
    tiles = TILES[route]
    n_out = w.shape[1]
    m, k = n * n_win, FC1_FRAMES * c
    period = walk_period(c, stride, tiles.kc)
    y = torch.empty((n, n_win, n_out), device=buf.device, dtype=buf.dtype)
    with torch.cuda.device(buf.device):
        sched = fc1_schedule(m, n_out, k, resident_ctas(buf.device), tiles=tiles)
        ws = (torch.empty((2 * sched.groups, sched.cols, m, tiles.bn), device=buf.device, dtype=torch.float32)
              if sched.groups > 1 else None)
        if route == "tf32x3_swap":
            # the windows' frames split once; the kernel reads both planes from frame 0
            span = (n_win - 1) * stride + FC1_FRAMES
            planes = split_planes(buf, s0, span)
            a, ld, a0 = (planes[0].data_ptr(), planes[1].data_ptr()), span * c, 0
        else:
            a, ld, a0 = (buf.data_ptr(),), buf.stride(0), s0
        err = cuda_build.launcher(KERNELS[route], 13, n_ptrs=3 + len(a))(
            *a, _packed(w, period, route).data_ptr(), y.data_ptr(), 0 if ws is None else ws.data_ptr(),
            n, ld, c, a0, stride, n_win, FC1_FRAMES, n_out, period, *sched,
            torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fc1_strided {route} kernel launch failed: error {err}")
    return y


def reset_launch_counts() -> None:
    """Zero every launch count of :func:`fc1_strided` and :func:`split_planes`."""
    fc1_strided.launches = 0
    fc1_strided.launches_by_route = Counter()
    fc1_strided.launches_by_shape = Counter()
    split_planes.launches = 0


#: kernel launches since the last reset (CPU calls do not count): all of
#: them, by route ("tc", "tf32x3", "tf32x3_swap") and by (dtype, N, F, C,
#: s0, stride, n_win, Nout), dtype "bfloat16" or "float32"; and the split
#: pass's, one a launch of the swapped kernel
reset_launch_counts()
