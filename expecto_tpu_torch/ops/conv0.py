"""Beluga's conv0 over int8 base codes: a table gather-sum, no float one-hot.

    y[n, l, c] = relu( b[c] + sum_{k<8} W0[k, code[n, l+k], c] )

codes (N, L) int8, W0 (8, 4, Cout) and b (Cout) in fp32 or bf16 -> (N, L-7,
Cout) in the weights' dtype, channels last. A code outside 0..3 (N is 4)
adds nothing. This is ``conv8_relu`` (the TPU kernel
``expecto_tpu/ops/pallas_conv.py::conv8_relu``) on
:func:`onehot_from_codes` of the codes, the only input Beluga's conv0 ever
sees, with the one-hot never built. :func:`conv0_codes_relu` launches the
hand-written CUDA kernel ``csrc/conv0_codes.cu`` for CUDA tensors and takes
:func:`conv0_codes_relu_plain` for CPU tensors; a CUDA tensor launches the
kernel or raises.

The reverse complement stays in code space (:func:`rc_codes`), so the
kernel needs no orientation flag.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import cuda_build
from .conv8 import KERNEL_W, conv8_relu_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 512  # the kernel's pair tables (400 * Cout bytes) live in shared memory
MAX_POSITIONS = 2**31 - 1 - 2**16  # N * L: the kernel's flat positions are ints


def onehot_from_codes(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, L) int codes -> (N, L, 4) in AGCT channel order; every code
    outside 0..3 (N is 4) one-hots to zeros, as ``jax.nn.one_hot`` does."""
    return (codes.unsqueeze(-1) == torch.arange(4, device=codes.device)).to(dtype)


def rc_codes(codes: torch.Tensor) -> torch.Tensor:
    """Reverse complement in code space: flip along L and map c -> 3 - c for
    c in 0..3, leaving every other code as it is. Under AGCT channel order
    ``onehot_from_codes(rc_codes(c))`` is the one-hot flipped in positions
    and channels, exactly."""
    c = codes.flip(1)
    return torch.where((c >= 0) & (c <= 3), 3 - c, c)


def conv0_codes_relu_plain(codes: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: conv8_relu_plain on the one-hot of the codes."""
    return conv8_relu_plain(onehot_from_codes(codes, w.dtype), w, b)


def _check(codes: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if codes.dtype != torch.int8:
        raise TypeError(f"conv0_codes_relu takes int8 base codes, got {codes.dtype}")
    if w.dtype not in _DTYPE_CODES or b.dtype != w.dtype:
        raise TypeError(f"conv0_codes_relu takes W and b of one dtype, float32 or bfloat16; got {w.dtype}, {b.dtype}")
    if not (w.device == codes.device and b.device == codes.device):
        raise ValueError(f"conv0_codes_relu needs codes, W and b on one device, got {codes.device}, {w.device}, "
                         f"{b.device}")
    if codes.dim() != 2 or w.dim() != 3 or b.dim() != 1 or tuple(w.shape[:2]) != (KERNEL_W, 4) \
            or b.shape[0] != w.shape[2]:
        raise ValueError(f"conv0_codes_relu takes codes (N, L), W (8, 4, Cout), b (Cout); got {tuple(codes.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    n, l = codes.shape
    if l < KERNEL_W:
        raise ValueError(f"input length {l} is shorter than the kernel width {KERNEL_W}")
    if n <= 0:
        raise ValueError("conv0_codes_relu takes at least one row")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv0_codes_relu needs contiguous W and b")


def conv0_codes_relu(codes: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(b + sum_k W[k, codes[:, l+k]]): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Codes that are not contiguous are
    copied (they are 1/640 of the output's bytes). Raises on anything the
    kernel does not take (dtype, device, shape, contiguity of W and b, Cout
    above 512) and if a launch fails."""
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv0_codes_relu runs on CUDA or CPU tensors, got {codes.device}")
    _check(codes, w, b)
    if codes.device.type == "cpu":
        return conv0_codes_relu_plain(codes, w, b)
    n, l = codes.shape
    cout = w.shape[2]
    if cout > MAX_COUT:
        raise ValueError(f"the conv0 kernel takes Cout <= {MAX_COUT}, got {cout}")
    if n * l > MAX_POSITIONS:
        raise ValueError(f"the conv0 kernel takes N * L <= {MAX_POSITIONS}, got {n * l}")
    codes = codes.contiguous()
    y = torch.empty((n, l - KERNEL_W + 1, cout), device=codes.device, dtype=w.dtype)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = cuda_build.launcher("conv0_codes", 4)(codes.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                                                    n, l, cout, _DTYPE_CODES[w.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv0_codes kernel launch failed: error {err}")
    conv0_codes_relu.launches += 1
    conv0_codes_relu.launches_by_kind[str(w.dtype).removeprefix("torch.")] += 1
    return y


def reset_launch_counts() -> None:
    """Zero every launch count of :func:`conv0_codes_relu`."""
    conv0_codes_relu.launches = 0
    conv0_codes_relu.launches_by_kind = Counter()


#: kernel launches since the last reset (CPU calls do not count): all of
#: them, and by dtype ("float32", "bfloat16")
reset_launch_counts()
