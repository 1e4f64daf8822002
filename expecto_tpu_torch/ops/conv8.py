"""Width-8 valid 1-D convolution + bias + ReLU, the op under every Beluga conv.

    y[:, l, :] = relu( sum_k  x[:, l+k, :] @ W[k]  + b ),   k < 8

x (N, L, Cin), W (8, Cin, Cout), b (Cout) -> (N, L-7, Cout), channels last
as in the JAX package. Three hand-written CUDA kernels port the TPU kernel
``expecto_tpu/ops/pallas_conv.py::conv8_relu``; :func:`conv8_relu` picks one
by :func:`_route`, a pure function of device, dtype, Cin and alignment:

- ``"tc"``: ``csrc/conv8_relu_tc.cu``, bf16 on the tensor cores (wgmma, TMA),
  for bf16 x with Cin % 16 == 0 and a 16-byte-aligned data pointer (TMA's
  rule): Beluga's conv1-conv5 on the main path;
- ``"tf32x3"``: ``csrc/conv8_relu_tf32x3.cu``, fp32 on the TF32 tensor cores
  in three passes (each operand split into TF32 hi and lo, lo*hi + hi*lo +
  hi*hi, each stage's products promoted into an fp32 sum), for fp32 x with
  Cin % 4 == 0 and a 16-byte-aligned data pointer: parity mode's
  conv1-conv5 in every fp32 flow;
- ``"simt"``: ``csrc/conv8_relu.cu``, fp32 FFMA on the CUDA cores, for the
  rest: fp32 views off a 16-byte boundary or with a Cin off 4, and every
  bf16 input off the tc rule, a bf16 one-hot at conv0 (Cin = 4) among
  them. No flow sends it input; it stays callable as ``route="simt"`` on
  any input, the tf32x3 kernel's yardstick;
- ``"cpu"``: :func:`conv8_relu_plain`, only for tensors on the CPU.

The kernels tile the conv over the N*L input rows as one sequence
(:func:`conv8_relu_flat_plain` is that indexing in plain PyTorch), in tiles
of 160 output channels, and read W packed once per weight tensor into their
own layout (:func:`pack_weights_tc`, :func:`pack_weights_tf32x3`,
:func:`pack_weights_simt`). Where a tf32x3 launch fills the SMs poorly (the
consensus patch's short rows) it splits K in :func:`tf32x3_splits` parts
and a second kernel adds them in a fixed order.

:func:`conv8_relu_pool4` is the same conv with Beluga's 4-wide max-pool
(the JAX package's XLA ``expecto_tpu/ops/spans.py::_pool4_from``) fused
into the kernels' epilogue: it returns the pooled buffer of each asked-for
phase and never writes the conv's own output to device memory
(:func:`conv8_relu_pool4_flat_plain` is the kernels' tile ownership in
plain PyTorch).

The serving path's conv0 takes int8 base codes instead, on ops/conv0.py.

A CUDA tensor launches its route's kernel or raises: no route falls back to
another on a failure.
"""

from __future__ import annotations

import weakref
from collections import Counter

import torch
import torch.nn.functional as F

from . import cuda_build
from .fc1 import split_tf32

KERNEL_W = 8
ROUTES = ("simt", "tc", "tf32x3")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TC_KC = 16  # input channels per stage of the tc kernel
_TF32_KC = 4  # input channels per stage of the tf32x3 kernel
_TF32_TM = 128  # flat rows per tile of the tf32x3 kernel
_TF32_MAX_SPLITS = 4  # parts of K at most (tf32x3_splits)
_TF32_MIN_STAGES = 16  # stages a part at least
_SIMT_KC = 4  # input channels per stage of the simt kernel
_BN = 160  # output channels per tile of the kernels
_MAX_ROWS = 2**31 - 1  # N * L: the kernels index the flat rows with an int
POOL_W = 4  # Beluga's max-pool: width and stride 4


def conv8_relu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the sum of 8 shifted matmuls, + b, ReLU."""
    if w.shape[0] != KERNEL_W:
        raise ValueError(f"kernel width {w.shape[0]} != {KERNEL_W}")
    l_out = x.shape[1] - KERNEL_W + 1
    if l_out <= 0:
        raise ValueError(f"input length {x.shape[1]} is shorter than the kernel width {KERNEL_W}")
    y = x[:, 0:l_out, :] @ w[0]
    for k in range(1, KERNEL_W):
        y = y + x[:, k : k + l_out, :] @ w[k]
    return torch.relu(y + b)


def conv8_relu_flat_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Both kernels' indexing in plain PyTorch: the conv over x as one
    (N*L, Cin) sequence, of which flat row n*L + l is kept for l < L-7 (the
    7 rows a span that straddle two spans are dropped)."""
    n, l, _cin = x.shape
    y = conv8_relu_plain(x.reshape(1, n * l, -1), w, b)[0]
    y = F.pad(y, (0, 0, 0, KERNEL_W - 1))  # back to N*L rows
    return y.reshape(n, l, -1)[:, : l - KERNEL_W + 1]


def pool4_frames(l_out: int, phase: int) -> int:
    """Frames of the 4-wide max-pool from ``phase`` over ``l_out`` rows
    (floor remainder drop): frame j covers rows [phase + 4j, phase + 4j + 4)."""
    return max(0, (l_out - phase) // POOL_W)


def _pool4(y: torch.Tensor, phase: int) -> torch.Tensor:
    """The plain versions' own 4-wide max-pool from ``phase`` over (N, L', C)
    (ops/spans._pool4_from's job; kept apart so that the plain versions do
    not depend on the span module)."""
    n, l, c = y.shape
    frames = pool4_frames(l, phase)
    return y[:, phase : phase + POOL_W * frames].reshape(n, frames, POOL_W, c).amax(dim=2)


def _pool_phases(phases) -> list[int]:
    """``phases`` as a sorted list, checked: 1-4 distinct ints in 0..3."""
    got = [int(p) for p in phases]
    if not got or len(set(got)) != len(got) or any(not 0 <= p < POOL_W for p in got):
        raise ValueError(f"conv8_relu_pool4 takes 1-4 distinct pool phases in 0..3, got {list(phases)}")
    return sorted(got)


def conv8_relu_pool4_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, phases) -> dict[int, torch.Tensor]:
    """Plain PyTorch version of :func:`conv8_relu_pool4`: the conv, then the
    4-wide max-pool from each phase -> {phase: (N, (L-7-phase)//4, Cout)}."""
    y = conv8_relu_plain(x, w, b)
    return {ph: _pool4(y, ph) for ph in _pool_phases(phases)}


def conv8_relu_pool4_flat_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, phases, *, route: str = "tc",
                                tm: int = 128) -> dict[int, torch.Tensor]:
    """The kernels' pooled epilogue in plain PyTorch, over tiles of ``tm``
    flat rows. Flat row n*L + l starts the group (l - ph) / 4 of phase
    ph = l % 4 when ph is asked for and the group's 4 rows lie below L-7.

    - ``route="tc"`` or ``"tf32x3"`` (128-row tiles): tiles step by ``tm``
      - 4, and a tile owns the groups whose first row lies in its first
      ``tm`` - 4 rows, so it takes each group's max from its own rows alone
      (a tf32x3 launch whose K is split pools in its second kernel, from
      the whole conv: the same values);
    - ``route="simt"`` (``tm`` 128 or 64): tiles step by ``tm``, each takes
      the max over its rows of every group with a row in it, and the parts
      of a group that straddles two tiles are merged by max into outputs
      that start at zero.

    The conv values come from :func:`conv8_relu_plain`; the rows that
    straddle two spans and the rows past N*L are NaN here, so a group that
    read such a row shows as NaN, as does (routes "tc", "tf32x3") one that
    no tile owned."""
    phases = _pool_phases(phases)
    if route not in ROUTES:
        raise ValueError(f"unknown conv8_relu route {route!r}")
    n, l, _cin = x.shape
    m, l_out = n * l, l - KERNEL_W + 1
    owned = route != "simt"
    step, first = (tm - POOL_W, 0) if owned else (tm, 1 - POOL_W)
    fill = float("nan") if owned else 0.0  # the outputs' start, and a group's rows outside the tile
    y = conv8_relu_plain(x, w, b)
    flat = torch.full((m + tm, y.shape[2]), float("nan"), dtype=y.dtype)
    flat[:m].view(n, l, -1)[:, :l_out] = y
    out = {ph: torch.full((n, pool4_frames(l_out, ph), y.shape[2]), fill, dtype=y.dtype) for ph in phases}
    s = torch.arange(first, step)  # the first rows of the groups a tile takes, from its own first row
    for m0 in range(0, m, step):
        tile = flat[m0 : m0 + tm]  # the tile's staged rows
        rows = m0 + s
        span, pos = rows.div(l, rounding_mode="floor"), rows % l
        ph, j = pos % POOL_W, pos // POOL_W
        for p in phases:
            take = (rows >= 0) & (rows < m) & (ph == p) & (j < pool4_frames(l_out, p))
            at = s[take]
            # each of a group's rows in the tile; a row outside it adds nothing (simt: max of values >= 0), or
            # shows as NaN (tc, tf32x3: a tile must own whole groups)
            part = torch.stack([torch.where(((at + r >= 0) & (at + r < tm))[:, None], tile[(at + r).clamp(0, tm - 1)],
                                            fill) for r in range(POOL_W)]).amax(dim=0)
            idx = (span[take], j[take])
            out[p][idx] = part if owned else torch.maximum(out[p][idx], part)
    return out


def pack_weights_tc(w: torch.Tensor) -> torch.Tensor:
    """W (8, Cin, Cout) in the tc kernel's layout: (Cout/160, Cin/16, 8 taps,
    2, 160, 8), one contiguous shared-memory stage per (Cout tile, Cin
    chunk), each tap two K-major 8-channel columns of 160 output channels;
    Cout is zero-padded to a multiple of 160."""
    kw, cin, cout = w.shape
    if kw != KERNEL_W or cin % _TC_KC:
        raise ValueError(f"the tc kernel packs W (8, Cin % {_TC_KC} == 0, Cout), got {tuple(w.shape)}")
    tiles = -(-cout // _BN)
    wp = F.pad(w, (0, tiles * _BN - cout))
    wp = wp.reshape(KERNEL_W, cin // _TC_KC, 2, 8, tiles, _BN)  # tap, chunk, group, e, tile, n
    return wp.permute(4, 1, 0, 2, 5, 3).contiguous()


def pack_weights_tf32x3(w: torch.Tensor) -> torch.Tensor:
    """W (8, Cin, Cout) fp32 split (ops/fc1.py::split_tf32: TF32 hi and lo,
    both rounded to nearest) into the tf32x3 kernel's layout: (Cout/160,
    Cin/4, 2, 8 taps, 160, 4), one contiguous 40 KB shared-memory stage per
    (Cout tile, 4-channel chunk) holding hi, then lo, each tap a K-major
    column of 160 outputs x 4 channels (16 bytes a row); Cout is
    zero-padded to a multiple of 160."""
    kw, cin, cout = w.shape
    if kw != KERNEL_W or cin % _TF32_KC or w.dtype != torch.float32:
        raise ValueError(f"the tf32x3 kernel packs fp32 W (8, Cin % {_TF32_KC} == 0, Cout), got {w.dtype} "
                         f"{tuple(w.shape)}")
    tiles = -(-cout // _BN)
    hi, lo = split_tf32(F.pad(w, (0, tiles * _BN - cout)))
    planes = torch.stack((hi, lo))  # plane, tap, Cin, Cout
    planes = planes.reshape(2, KERNEL_W, cin // _TF32_KC, _TF32_KC, tiles, _BN)  # plane, tap, chunk, c, tile, n
    return planes.permute(4, 2, 0, 1, 5, 3).contiguous()


def tf32x3_splits(m: int, cin: int, cout: int, sms: int) -> int:
    """Parts of K (input-channel stages) a tf32x3 launch of ``m`` flat rows
    takes on a card of ``sms`` SMs (one CTA an SM): 1 from two waves of
    tiles up (there the parts' round trip through device memory and the
    second kernel cost more than the fuller last wave gains: measured on
    the H100 at 436-1,485 tiles, 3-20 % slower split); below, the count up
    to _TF32_MAX_SPLITS, each part at least _TF32_MIN_STAGES stages, whose
    (tiles x parts) CTAs fill the waves best, the fewest parts unless one
    more fills them by 5 % more. A pure function of the shape, so a pooled
    launch and the unpooled one of the same x split alike."""
    tiles = -(-m // _TF32_TM) * -(-cout // _BN)
    if tiles >= 2 * sms:
        return 1
    most = max(1, min(_TF32_MAX_SPLITS, cin // _TF32_KC // _TF32_MIN_STAGES))

    def fill(s: int) -> float:
        ctas = tiles * s
        return ctas / (sms * -(-ctas // sms))

    best = 1
    for s in range(2, most + 1):
        if fill(s) > fill(best) + 0.05:
            best = s
    return best


def pack_weights_simt(w: torch.Tensor) -> torch.Tensor:
    """W (8, Cin, Cout) in the simt kernel's layout: fp32 (Cout/160, Cin/4,
    8 taps, 4, 160), one contiguous shared-memory stage per (Cout tile,
    4-channel chunk), each row the 160 output channels of one (tap, input
    channel); Cin is zero-padded to a multiple of 4 and Cout to one of 160.
    bf16 weights are widened to fp32 here, once, not in the kernel."""
    kw, cin, cout = w.shape
    if kw != KERNEL_W:
        raise ValueError(f"the simt kernel packs W (8, Cin, Cout), got {tuple(w.shape)}")
    chunks, tiles = -(-cin // _SIMT_KC), -(-cout // _BN)
    wp = F.pad(w.float(), (0, tiles * _BN - cout, 0, chunks * _SIMT_KC - cin))
    wp = wp.reshape(KERNEL_W, chunks, _SIMT_KC, tiles, _BN)  # tap, chunk, c, tile, n
    return wp.permute(3, 1, 0, 2, 4).contiguous()


_PACKERS = {"tc": pack_weights_tc, "tf32x3": pack_weights_tf32x3, "simt": pack_weights_simt}
_PACKED: dict[tuple, tuple] = {}  # (id(W), route) -> (weakref to W, W._version, packed W)


def _packed(w: torch.Tensor, route: str) -> torch.Tensor:
    """W packed for ``route``'s kernel, kept while w lives and is not written
    to: the weights of a runner are packed once, not at every launch."""
    key = (id(w), route)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    _PACKED[key] = (weakref.ref(w, lambda _ref: _PACKED.pop(key, None)), w._version, _PACKERS[route](w))
    return _PACKED[key][2]


def _route(device_type: str, dtype: torch.dtype, cin: int, data_ptr: int) -> str:
    """Which implementation runs x of this device type, dtype, channel count
    and data pointer: "cpu", "simt", "tc" or "tf32x3" (module docstring)."""
    if device_type == "cpu":
        return "cpu"
    if dtype == torch.bfloat16 and cin % _TC_KC == 0 and data_ptr % 16 == 0:
        return "tc"
    if dtype == torch.float32 and cin % _TF32_KC == 0 and data_ptr % 16 == 0:
        return "tf32x3"
    return "simt"


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"conv8_relu takes float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"conv8_relu needs x, W and b of one dtype, got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (w.device == x.device and b.device == x.device):
        raise ValueError(f"conv8_relu needs x, W and b on one device, got {x.device}, {w.device}, {b.device}")
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"conv8_relu takes x (N, L, Cin), W (8, Cin, Cout), b (Cout); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    n, l, cin = x.shape
    if w.shape[0] != KERNEL_W or w.shape[1] != cin or b.shape[0] != w.shape[2]:
        raise ValueError(f"conv8_relu shape mismatch: x {tuple(x.shape)}, W {tuple(w.shape)}, b {tuple(b.shape)}")
    if l < KERNEL_W:
        raise ValueError(f"input length {l} is shorter than the kernel width {KERNEL_W}")
    if n <= 0:
        raise ValueError("conv8_relu takes at least one row")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv8_relu needs contiguous x, W and b")


def _cuda_route(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, route: str | None, what: str) -> str:
    """The route that runs CUDA x: :func:`_route`'s, or ``route`` if it takes
    x. Raises on anything the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w, b)
    n, l, cin = x.shape
    auto = _route(x.device.type, x.dtype, cin, x.data_ptr())
    route = auto if route is None else route
    if route not in ROUTES:
        raise ValueError(f"unknown conv8_relu route {route!r}")
    if route == "tc" and auto != "tc":
        raise ValueError(f"the tc kernel takes 16-byte-aligned bf16 x with Cin % {_TC_KC} == 0, got {x.dtype}, "
                         f"Cin {cin}, data pointer {x.data_ptr():#x}")
    if route == "tf32x3" and auto != "tf32x3":
        raise ValueError(f"the tf32x3 kernel takes 16-byte-aligned fp32 x with Cin % {_TF32_KC} == 0, got "
                         f"{x.dtype}, Cin {cin}, data pointer {x.data_ptr():#x}")
    if n * l > _MAX_ROWS:
        raise ValueError(f"the {route} kernel takes N * L <= {_MAX_ROWS}, got {n * l}")
    return route


def _tf32x3_parts(x: torch.Tensor, cout: int) -> tuple[int, torch.Tensor | None]:
    """The parts of K of a tf32x3 launch on CUDA x (:func:`tf32x3_splits`)
    and their workspace (splits, N*L, Cout) fp32, None for one part. The
    caller holds it until the launch is enqueued: PyTorch's caching
    allocator then reuses it only in the current stream's order."""
    n, l, cin = x.shape
    splits = tf32x3_splits(n * l, cin, cout, torch.cuda.get_device_properties(x.device).multi_processor_count)
    if splits == 1:
        return 1, None
    return splits, torch.empty((splits, n * l, cout), device=x.device, dtype=torch.float32)


def _count(route: str, x: torch.Tensor, cout: int) -> None:
    n, l, cin = x.shape
    dtype = str(x.dtype).removeprefix("torch.")
    conv8_relu.launches += 1
    conv8_relu.launches_by_route[route] += 1
    conv8_relu.launches_by_kind[(route, dtype, cin)] += 1
    conv8_relu.launches_by_shape[(route, dtype, n, l, cin, cout)] += 1


def conv8_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, route: str | None = None) -> torch.Tensor:
    """relu(conv_valid_w8(x, W) + b): a CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``route`` ("simt", "tc" or "tf32x3")
    overrides :func:`_route` for CUDA tensors, for timing one kernel against
    another; a route that does not take the input raises. Each kernel reads
    W packed for it, once per weight tensor while the tensor lives
    unwritten, and takes up to 2**31 - 1 flat rows N * L (any N). Raises on
    anything the kernels do not take (dtype, device, shape, contiguity,
    rows) and if a launch fails."""
    if x.device.type == "cpu":
        if route not in (None, "cpu"):
            raise ValueError(f"route {route!r} needs CUDA tensors")
        return conv8_relu_plain(x, w, b)
    route = _cuda_route(x, w, b, route, "conv8_relu")
    n, l, cin = x.shape
    cout = w.shape[2]
    y = torch.empty((n, l - KERNEL_W + 1, cout), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        wp = _packed(w, route).data_ptr()
        if route == "tc":
            err = cuda_build.launcher("conv8_relu_tc", 4)(x.data_ptr(), wp, b.data_ptr(), y.data_ptr(), n, l, cin,
                                                          cout, stream)
        elif route == "tf32x3":
            splits, ws = _tf32x3_parts(x, cout)
            err = cuda_build.launcher("conv8_relu_tf32x3", 5, n_ptrs=5)(
                x.data_ptr(), wp, b.data_ptr(), y.data_ptr(), 0 if ws is None else ws.data_ptr(), n, l, cin, cout,
                splits, stream)
        else:
            err = cuda_build.launcher("conv8_relu", 5)(x.data_ptr(), wp, b.data_ptr(), y.data_ptr(), n, l, cin, cout,
                                                       _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv8_relu {route} kernel launch failed: error {err}")
    _count(route, x, cout)
    return y


def conv8_relu_pool4(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, phases, *,
                     route: str | None = None) -> dict[int, torch.Tensor]:
    """The conv of :func:`conv8_relu`, then the 4-wide max-pool from each of
    ``phases`` (1-4 distinct ints in 0..3), in one launch whose epilogue
    pools before it stores: {phase: (N, (L-7-phase)//4, Cout)}, each phase
    a contiguous tensor of its own. The conv's own output never reaches
    device memory. Route rule (:func:`_route`), ``route`` override, checks
    and packed weights as :func:`conv8_relu`, but the SIMT kernel pools fp32
    alone: bf16 off the tc rule raises. CPU tensors take :func:`conv8_relu_pool4_plain`. A
    phase with no full pool frame gives an (N, 0, Cout) tensor, and no
    launch when no phase has one. Counts a launch in :func:`conv8_relu`'s
    counts and in its own ``launches``, ``launches_by_route``."""
    phases = _pool_phases(phases)
    if x.device.type == "cpu":
        if route not in (None, "cpu"):
            raise ValueError(f"route {route!r} needs CUDA tensors")
        return conv8_relu_pool4_plain(x, w, b, phases)
    route = _cuda_route(x, w, b, route, "conv8_relu_pool4")
    if route == "simt" and x.dtype != torch.float32:
        raise ValueError(f"conv8_relu_pool4 pools {x.dtype} only on the tc kernel (16-byte-aligned x, Cin % "
                         f"{_TC_KC} == 0), got Cin {x.shape[2]}, data pointer {x.data_ptr():#x}")
    n, l, cin = x.shape
    cout = w.shape[2]
    out = {ph: torch.empty((n, pool4_frames(l - KERNEL_W + 1, ph), cout), device=x.device, dtype=x.dtype)
           for ph in phases}
    live = {ph: y for ph, y in out.items() if y.shape[1]}
    if not live:
        return out
    mask = sum(1 << ph for ph in live)
    ys = [live[ph].data_ptr() if ph in live else 0 for ph in range(POOL_W)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        wp = _packed(w, route).data_ptr()
        if route == "tc":
            err = cuda_build.launcher("conv8_relu_tc", 5, n_ptrs=7, entry="conv8_relu_tc_pool4_launch")(
                x.data_ptr(), wp, b.data_ptr(), *ys, n, l, cin, cout, mask, stream)
        elif route == "tf32x3":
            splits, ws = _tf32x3_parts(x, cout)
            err = cuda_build.launcher("conv8_relu_tf32x3", 6, n_ptrs=8, entry="conv8_relu_tf32x3_pool4_launch")(
                x.data_ptr(), wp, b.data_ptr(), *ys, 0 if ws is None else ws.data_ptr(), n, l, cin, cout, splits,
                mask, stream)
        else:
            err = cuda_build.launcher("conv8_relu", 6, n_ptrs=7, entry="conv8_relu_pool4_launch")(
                x.data_ptr(), wp, b.data_ptr(), *ys, n, l, cin, cout, _DTYPE_CODES[x.dtype], mask, stream)
    if err != 0:
        raise RuntimeError(f"conv8_relu_pool4 {route} kernel launch failed: error {err}")
    _count(route, x, cout)
    conv8_relu_pool4.launches += 1
    conv8_relu_pool4.launches_by_route[route] += 1
    return out


def reset_launch_counts() -> None:
    """Zero every launch count of :func:`conv8_relu` and :func:`conv8_relu_pool4`."""
    conv8_relu.launches = 0
    conv8_relu.launches_by_route = dict.fromkeys(ROUTES, 0)
    conv8_relu.launches_by_kind = Counter()
    conv8_relu.launches_by_shape = Counter()
    conv8_relu_pool4.launches = 0
    conv8_relu_pool4.launches_by_route = dict.fromkeys(ROUTES, 0)


#: kernel launches since the last reset (CPU calls do not count): all of
#: them, by route, by (route, dtype, Cin) and by (route, dtype, N, L, Cin,
#: Cout), pooled launches among them; and the pooled launches alone, all
#: and by route
reset_launch_counts()
