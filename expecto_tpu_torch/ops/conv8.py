"""Width-8 valid 1-D convolution + bias + ReLU, the op under every Beluga conv.

    y[:, l, :] = relu( sum_k  x[:, l+k, :] @ W[k]  + b ),   k < 8

x (N, L, Cin), W (8, Cin, Cout), b (Cout) -> (N, L-7, Cout), channels last
as in the JAX package. :func:`conv8_relu` launches the hand-written CUDA
kernel ``csrc/conv8_relu.cu`` for CUDA tensors (the port of the TPU kernel
``expecto_tpu/ops/pallas_conv.py::conv8_relu``) and runs
:func:`conv8_relu_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

KERNEL_W = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535  # the launcher puts the batch on grid.z


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


def _lib():
    lib = cuda_build.load("conv8_relu")
    if lib.conv8_relu_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.conv8_relu_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.conv8_relu_launch.restype = ctypes.c_int
    return lib


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
    if not 0 < n <= _MAX_BATCH:
        raise ValueError(f"conv8_relu takes 1..{_MAX_BATCH} rows, got {n}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv8_relu needs contiguous x, W and b")


def conv8_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(conv_valid_w8(x, W) + b): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Raises on anything the kernel does not
    take (dtype, device, shape, contiguity) and if its launch fails."""
    if x.device.type == "cpu":
        return conv8_relu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv8_relu runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w, b)
    n, l, cin = x.shape
    cout = w.shape[2]
    y = torch.empty((n, l - KERNEL_W + 1, cout), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        err = _lib().conv8_relu_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            n, l, cin, cout, _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv8_relu kernel launch failed: CUDA error {err}")
    conv8_relu.launches += 1
    return y


#: kernel launches since the last reset (CPU calls do not count)
conv8_relu.launches = 0
