"""gblinear's coordinate update, the elementwise step of each block of the
block coordinate-descent sweep (models/gblinear.py).

    dw = eta * coord_delta(g, h, w; lam, alpha),   w += dw

g, h and w are (B, K) fp32 (or (B,) for one model): the block's gradient
sums, hessian sums and weights. ``coord_delta`` is xgboost 0.7's elastic-net
coordinate solution, zero where the hessian is below 1e-5 (a padded feature
row has h = 0). The JAX package leaves it to XLA to fuse
(``expecto_tpu/models/gblinear.py::_coord_delta`` and its block steps);
:func:`coord_update` launches the hand-written CUDA kernel
``csrc/gblinear_cd.cu`` for CUDA tensors and takes :func:`coord_update_plain`
for CPU tensors. A CUDA tensor launches the kernel or raises.

:func:`coord_update_planes` is the K-model sweep's update on its split
route (ops/gblinear_block.py: the gradient summed over the ranks between the
block's two products): the same step, with dw written as the residual
kernel's operand, TF32 hi and lo planes, in place of a (B, K) tensor.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import cuda_build
from .fc1 import split_tf32


def coord_update_plain(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor, eta: float, lam: float,
                       alpha: float) -> torch.Tensor:
    """Plain PyTorch version, one op at a time in the JAX function's order:
    updates ``w`` in place and returns dw."""
    gl2 = g + lam * w
    hl2 = h + lam
    tmp = w - gl2 / hl2
    pos = torch.maximum(-(gl2 + alpha) / hl2, -w)
    neg = torch.minimum(-(gl2 - alpha) / hl2, -w)
    delta = torch.where(tmp >= 0, pos, neg)
    dw = eta * torch.where(h < 1e-5, 0.0, delta)
    w += dw
    return dw


def coord_update(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor, eta: float, lam: float,
                 alpha: float) -> torch.Tensor:
    """dw = eta * coord_delta(g, h, w), w += dw in place; returns dw. The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. Raises
    on anything the kernel does not take (dtype, device, shape, contiguity)
    and if a launch fails."""
    for name, t in (("g", g), ("h", h), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"coord_update takes fp32 tensors, got {name} {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"coord_update needs g, h and w on one device, got {g.device}, {h.device}, {w.device}")
        if t.shape != w.shape:
            raise ValueError(f"coord_update needs g, h and w of one shape, got {tuple(g.shape)}, {tuple(h.shape)}, "
                             f"{tuple(w.shape)}")
    if w.device.type == "cpu":
        return coord_update_plain(g, h, w, eta, lam, alpha)
    if w.device.type != "cuda":
        raise ValueError(f"coord_update runs on CUDA or CPU tensors, got {w.device}")
    if not (g.is_contiguous() and h.is_contiguous() and w.is_contiguous()):
        raise ValueError("coord_update needs contiguous g, h and w")
    if not 0 < w.numel() < 2**31:
        raise ValueError(f"coord_update takes 1 to 2**31 - 1 elements, got {w.numel()}")
    dw = torch.empty_like(w)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = cuda_build.launcher("gblinear_cd", 1, 3)(g.data_ptr(), h.data_ptr(), w.data_ptr(), dw.data_ptr(),
                                                        w.numel(), eta, lam, alpha, stream)
    if err != 0:
        raise RuntimeError(f"gblinear_cd kernel launch failed: error {err}")
    coord_update.launches += 1
    coord_update.launches_by_shape[tuple(w.shape)] += 1
    return dw


def coord_update_planes_plain(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, eta: float,
                              lam: float, alpha: float) -> torch.Tensor:
    """Plain PyTorch version of the planes entry: :func:`coord_update_plain`
    (w updated in place), then dw (B, K) split into TF32 hi and lo
    (``ops/fc1.py::split_tf32``) and written transposed into ``planes`` (2,
    n_pad, b_pad) as planes[0, k, f] and planes[1, k, f]; returns planes."""
    b, k = w.shape
    hi, lo = split_tf32(coord_update_plain(g, h, w, eta, lam, alpha).T.contiguous())
    planes[0, :k, :b] = hi
    planes[1, :k, :b] = lo
    return planes


def coord_update_planes(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor, planes: torch.Tensor, eta: float,
                        lam: float, alpha: float) -> torch.Tensor:
    """w += eta * coord_delta(g, h, w) in place, dw written into ``planes``
    (2, n_pad, b_pad) fp32 as its TF32 hi and lo, each model's features
    contiguous (the rest of ``planes`` left as it is); returns planes. g, h,
    w (B, K) fp32 contiguous. The CUDA kernel's second entry for CUDA
    tensors (counted in :func:`coord_update`'s counts), the plain version
    for CPU tensors. Raises on anything the kernel does not take and if the
    launch fails."""
    for name, t in (("g", g), ("h", h), ("w", w), ("planes", planes)):
        if t.dtype != torch.float32:
            raise TypeError(f"coord_update_planes takes fp32 tensors, got {name} {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"coord_update_planes needs its tensors on one device, got {g.device}, {h.device}, "
                             f"{w.device}, {planes.device}")
    if w.dim() != 2 or g.shape != w.shape or h.shape != w.shape:
        raise ValueError(f"coord_update_planes needs g, h and w of one (B, K) shape, got {tuple(g.shape)}, "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    b, k = w.shape
    if planes.dim() != 3 or planes.shape[0] != 2 or planes.shape[1] < k or planes.shape[2] < b:
        raise ValueError(f"coord_update_planes writes (2, >= {k}, >= {b}) planes, got {tuple(planes.shape)}")
    if w.device.type == "cpu":
        return coord_update_planes_plain(g, h, w, planes, eta, lam, alpha)
    if w.device.type != "cuda":
        raise ValueError(f"coord_update_planes runs on CUDA or CPU tensors, got {w.device}")
    if not (g.is_contiguous() and h.is_contiguous() and w.is_contiguous() and planes.is_contiguous()):
        raise ValueError("coord_update_planes needs contiguous g, h, w and planes")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = cuda_build.launcher("gblinear_cd", 4, 3, entry="gblinear_cd_planes_launch")(
            g.data_ptr(), h.data_ptr(), w.data_ptr(), planes.data_ptr(), b, k, planes.shape[1], planes.shape[2], eta,
            lam, alpha, stream)
    if err != 0:
        raise RuntimeError(f"gblinear_cd planes launch failed: error {err}")
    coord_update.launches += 1
    coord_update.launches_by_shape[(b, k)] += 1
    return planes


def reset_launch_counts() -> None:
    """Zero the launch counts of :func:`coord_update`."""
    coord_update.launches = 0
    coord_update.launches_by_shape = Counter()


#: kernel launches since the last reset (CPU calls do not count): all of
#: them, and by the shape of w
reset_launch_counts()
