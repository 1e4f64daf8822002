"""Width-8 valid 1-D convolution + bias + ReLU, the op under every Beluga conv.

    y[:, l, :] = relu( sum_k  x[:, l+k, :] @ W[k]  + b ),   k < 8

x (N, L, Cin), W (8, Cin, Cout), b (Cout) -> (N, L-7, Cout), channels last
as in the JAX package. Two hand-written CUDA kernels port the TPU kernel
``expecto_tpu/ops/pallas_conv.py::conv8_relu``; :func:`conv8_relu` picks one
by :func:`_route`, a pure function of device, dtype, Cin and alignment:

- ``"tc"``: ``csrc/conv8_relu_tc.cu``, bf16 on the tensor cores (wgmma, TMA),
  for bf16 x with Cin % 16 == 0 and a 16-byte-aligned data pointer (TMA's
  rule): Beluga's conv1-conv5 on the main path;
- ``"simt"``: ``csrc/conv8_relu.cu``, fp32 FFMA on the CUDA cores, for fp32
  (parity mode: conv1-conv5) and every other bf16 input, a float one-hot at
  conv0 (Cin = 4) among them;
- ``"cpu"``: :func:`conv8_relu_plain`, only for tensors on the CPU.

Both kernels tile the conv over the N*L input rows as one sequence
(:func:`conv8_relu_flat_plain` is that indexing in plain PyTorch), in tiles
of 160 output channels, and read W packed once per weight tensor into their
own layout (:func:`pack_weights_tc`, :func:`pack_weights_simt`).

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

KERNEL_W = 8
ROUTES = ("simt", "tc")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TC_KC = 16  # input channels per stage of the tc kernel
_SIMT_KC = 4  # input channels per stage of the simt kernel
_BN = 160  # output channels per tile of both kernels
_MAX_ROWS = 2**31 - 1  # N * L: both kernels index the flat rows with an int


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


_PACKERS = {"tc": pack_weights_tc, "simt": pack_weights_simt}
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
    and data pointer: "cpu", "simt" or "tc" (module docstring)."""
    if device_type == "cpu":
        return "cpu"
    if dtype == torch.bfloat16 and cin % _TC_KC == 0 and data_ptr % 16 == 0:
        return "tc"
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


def conv8_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, route: str | None = None) -> torch.Tensor:
    """relu(conv_valid_w8(x, W) + b): a CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``route`` ("simt" or "tc") overrides
    :func:`_route` for CUDA tensors, for timing one kernel against the other;
    a route that does not take the input raises. Either kernel reads W packed
    for it, once per weight tensor while the tensor lives unwritten, and
    takes up to 2**31 - 1 flat rows N * L (any N). Raises on anything the
    kernels do not take (dtype, device, shape, contiguity, rows) and if a
    launch fails."""
    if x.device.type == "cpu":
        if route not in (None, "cpu"):
            raise ValueError(f"route {route!r} needs CUDA tensors")
        return conv8_relu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv8_relu runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w, b)
    n, l, cin = x.shape
    cout = w.shape[2]
    auto = _route(x.device.type, x.dtype, cin, x.data_ptr())
    route = auto if route is None else route
    if route not in ROUTES:
        raise ValueError(f"unknown conv8_relu route {route!r}")
    if route == "tc" and auto != "tc":
        raise ValueError(f"the tc kernel takes 16-byte-aligned bf16 x with Cin % {_TC_KC} == 0, got {x.dtype}, "
                         f"Cin {cin}, data pointer {x.data_ptr():#x}")
    if n * l > _MAX_ROWS:
        raise ValueError(f"the {route} kernel takes N * L <= {_MAX_ROWS}, got {n * l}")
    y = torch.empty((n, l - KERNEL_W + 1, cout), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        wp = _packed(w, route).data_ptr()
        if route == "tc":
            err = cuda_build.launcher("conv8_relu_tc", 4)(x.data_ptr(), wp, b.data_ptr(), y.data_ptr(), n, l, cin,
                                                          cout, stream)
        else:
            err = cuda_build.launcher("conv8_relu", 5)(x.data_ptr(), wp, b.data_ptr(), y.data_ptr(), n, l, cin, cout,
                                                       _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv8_relu {route} kernel launch failed: error {err}")
    conv8_relu.launches += 1
    conv8_relu.launches_by_route[route] += 1
    conv8_relu.launches_by_kind[(route, str(x.dtype).removeprefix("torch."), cin)] += 1
    conv8_relu.launches_by_shape[(route, str(x.dtype).removeprefix("torch."), n, l, cin, cout)] += 1
    return y


def reset_launch_counts() -> None:
    """Zero every launch count of :func:`conv8_relu`."""
    conv8_relu.launches = 0
    conv8_relu.launches_by_route = dict.fromkeys(ROUTES, 0)
    conv8_relu.launches_by_kind = Counter()
    conv8_relu.launches_by_shape = Counter()


#: kernel launches since the last reset (CPU calls do not count): all of
#: them, by route, by (route, dtype, Cin) and by (route, dtype, N, L, Cin,
#: Cout)
reset_launch_counts()
