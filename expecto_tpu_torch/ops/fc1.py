"""fc1 of Beluga as a strided product over a conv6 phase buffer.

    y[n, w, :] = buf[n, s0 + w*stride : + 106, :].reshape(-1) @ W

buf (N, F, C) channels last, W (106*C, Nout) the length-major fc1 matrix ->
y (N, n_win, Nout): the pre-activations (no bias or ReLU) of n_win windows
106 frames long, ``stride`` frames apart from frame ``s0``. It is the
strided valid convolution ``lax.conv_general_dilated`` of
``expecto_tpu/ops/spans.py::fc1_pre_from_phases`` (:421), an XLA step of
the JAX package. :func:`fc1_strided` picks an implementation by
:func:`_route`, a pure function of device and dtype:

- ``"tc"``: ``csrc/fc1_strided_tc.cu``, bf16 on the tensor cores (wgmma),
  the production dtype of every CLI: the windows are read straight from the
  buffer, never copied, and W is packed once per weight tensor
  (:func:`pack_weights_fc1`);
- ``"cublas"``: fp32 on the card (parity mode, TF32 off): the windows
  ``unfold``-ed and one ``torch.matmul``, as the JAX package leaves the
  product to XLA;
- ``"cpu"``: :func:`fc1_strided_plain`, only for tensors on the CPU.

A CUDA bf16 tensor launches the kernel or raises: nothing falls back to the
matmul on a failure.
"""

from __future__ import annotations

import math
import weakref
from collections import Counter

import torch
import torch.nn.functional as F

from . import cuda_build

FC1_FRAMES = 106
ROUTES = ("tc", "cublas")
_TM = 128  # rows (windows) per tile of the kernel
_BN = 256  # columns per tile; W's columns are zero-padded to a multiple of it
_KC = 64  # K per stage; W's rows are zero-padded to a multiple of it
_MIN_SPLITS, _MAX_SPLITS = 4, 16
_MAX_ROWS = 2**31 - 1  # N * n_win: the kernel indexes rows with an int
# H100 SXM peaks, dense bf16 and HBM3: the split plan's model of the card
_PEAK_OPS = 989e12
_PEAK_BYTES = 3.35e12


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


def pack_weights_fc1(w: torch.Tensor) -> torch.Tensor:
    """W (K, Nout) in the kernel's layout: (Nout/256, K/64, 8, 256, 8), one
    contiguous shared-memory stage per (column tile, K chunk), each of its 8
    K groups a K-major column of 256 output columns; Nout is zero-padded to
    a multiple of 256 (2,003 -> 2,048) and K to one of 64 (Beluga's 67,840
    is already)."""
    k, n_out = w.shape
    tiles, chunks = -(-n_out // _BN), -(-k // _KC)
    wp = F.pad(w, (0, tiles * _BN - n_out, 0, chunks * _KC - k))
    wp = wp.reshape(chunks, 8, 8, tiles, _BN)  # chunk, group, e, tile, n
    return wp.permute(3, 0, 1, 4, 2).contiguous()


_PACKED: dict[int, tuple] = {}  # id(W) -> (weakref to W, W._version, packed W)


def _packed(w: torch.Tensor) -> torch.Tensor:
    """W packed for the kernel, kept while w lives and is not written to: a
    runner's fc1 weight is packed once, not at every launch."""
    key = id(w)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    _PACKED[key] = (weakref.ref(w, lambda _ref: _PACKED.pop(key, None)), w._version, pack_weights_fc1(w))
    return _PACKED[key][2]


def _route(device_type: str, dtype: torch.dtype) -> str:
    """Which implementation runs a buffer of this device type and dtype:
    "cpu", "tc" (CUDA bf16) or "cublas" (CUDA, any other dtype; module
    docstring)."""
    if device_type == "cpu":
        return "cpu"
    return "tc" if dtype == torch.bfloat16 else "cublas"


def fc1_splits(m: int, n_out: int, k: int, sms: int) -> int:
    """The kernel's split-K count for M = ``m`` rows on ``sms`` SMs: the
    slice count that minimises the waves of (row tile, column tile, slice)
    blocks per slice, plus the split-sum pass's bytes, each in units of one
    block's whole-K time at the card's peak; at least :data:`_MIN_SPLITS`
    slices where K has the stages (on the H100 fewer, longer slices never
    beat four or more at an fc1 shape of the bf16 flows:
    scripts/probe_fc1_torch.py). A pure function of the shape and the SM
    count, so a shape gives the same bits every call."""
    tiles = -(-m // _TM) * -(-n_out // _BN)
    tile_s = 2.0 * _TM * _BN * k / (_PEAK_OPS / sms)
    sum_s = m * -(-n_out // _BN) * _BN * 8 / _PEAK_BYTES  # one slice written and read again, fp32
    most = min(_MAX_SPLITS, -(-k // _KC))
    best, best_cost = 1, math.inf
    for s in range(min(_MIN_SPLITS, most), most + 1):
        cost = math.ceil(tiles * s / sms) / s + (s > 1) * s * sum_s / tile_s
        if cost < best_cost - 1e-12:
            best, best_cost = s, cost
    return best


def _check(buf: torch.Tensor, w: torch.Tensor, s0: int, stride: int, n_win: int) -> None:
    """Raises on an input the kernel does not take: dtype, shape, window
    range, layout, alignment, then device."""
    if buf.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the fc1 kernel takes bfloat16 buf and W, got {buf.dtype}, {w.dtype}")
    if buf.dim() != 3 or w.dim() != 2:
        raise ValueError(f"the fc1 kernel takes buf (N, F, C) and W (106*C, Nout), got {tuple(buf.shape)}, "
                         f"{tuple(w.shape)}")
    n, f, c = buf.shape
    if w.shape[0] != FC1_FRAMES * c or w.shape[1] <= 0:
        raise ValueError(f"W {tuple(w.shape)} does not match {FC1_FRAMES} frames of {c} channels")
    if c % 8:
        raise ValueError(f"the fc1 kernel takes C % 8 == 0 (16-byte rows), got C = {c}")
    if n <= 0 or n_win <= 0 or stride <= 0 or s0 < 0 or s0 + (n_win - 1) * stride + FC1_FRAMES > f:
        raise ValueError(f"{n_win} windows of {FC1_FRAMES} frames {stride} apart from frame {s0} do not fit "
                         f"{n} samples of {f} frames")
    if n * n_win > _MAX_ROWS:
        raise ValueError(f"the fc1 kernel takes N * n_win <= {_MAX_ROWS}, got {n * n_win}")
    if buf.stride(2) != 1 or buf.stride(1) != c or buf.stride(0) % 8 or not w.is_contiguous():
        raise ValueError(f"the fc1 kernel takes buf with contiguous rows of C channels and samples a multiple of "
                         f"8 elements apart, and contiguous W; got strides {buf.stride()}")
    if buf.data_ptr() % 16:
        raise ValueError(f"the fc1 kernel takes a 16-byte-aligned buf, got data pointer {buf.data_ptr():#x}")
    if buf.device.type != "cuda" or w.device != buf.device:
        raise ValueError(f"the fc1 kernel takes buf and W on one CUDA device, got {buf.device}, {w.device}")


def fc1_strided(buf: torch.Tensor, w: torch.Tensor, s0: int, stride: int, n_win: int) -> torch.Tensor:
    """fc1's pre-activations of ``n_win`` windows of 106 frames ``stride``
    frames apart from frame ``s0`` of each sample of ``buf`` (N, F, C):
    (N, n_win, Nout) in buf's dtype. CPU tensors take the plain version;
    CUDA bf16 the kernel (raising on anything it does not take, and if a
    launch fails); CUDA fp32 the cuBLAS product."""
    s0, stride, n_win = int(s0), int(stride), int(n_win)
    route = _route(buf.device.type, buf.dtype)
    if route == "cpu":
        return fc1_strided_plain(buf, w, s0, stride, n_win)
    if route == "cublas":
        return _windows(buf, s0, stride, n_win) @ w
    _check(buf, w, s0, stride, n_win)
    n, _f, c = buf.shape
    n_out = w.shape[1]
    m, k = n * n_win, FC1_FRAMES * c
    y = torch.empty((n, n_win, n_out), device=buf.device, dtype=buf.dtype)
    with torch.cuda.device(buf.device):
        splits = fc1_splits(m, n_out, k, torch.cuda.get_device_properties(buf.device).multi_processor_count)
        ws = (torch.empty((splits, m, -(-n_out // _BN) * _BN), device=buf.device, dtype=torch.float32)
              if splits > 1 else None)
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = cuda_build.launcher("fc1_strided_tc", 9)(
            buf.data_ptr(), _packed(w).data_ptr(), y.data_ptr(), 0 if ws is None else ws.data_ptr(), n,
            buf.stride(0), c, s0, stride, n_win, FC1_FRAMES, n_out, splits, stream)
    if err != 0:
        raise RuntimeError(f"fc1_strided kernel launch failed: error {err}")
    fc1_strided.launches += 1
    fc1_strided.launches_by_shape[(n, buf.shape[1], c, s0, stride, n_win, n_out)] += 1
    return y


def reset_launch_counts() -> None:
    """Zero every launch count of :func:`fc1_strided`."""
    fc1_strided.launches = 0
    fc1_strided.launches_by_shape = Counter()


#: kernel launches since the last reset (CPU and cuBLAS calls do not count):
#: all of them and by (N, F, C, s0, stride, n_win, Nout)
reset_launch_counts()
