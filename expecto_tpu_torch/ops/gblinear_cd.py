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
"""

from __future__ import annotations

import torch

from . import cuda_build


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
    return dw


def reset_launch_counts() -> None:
    """Zero the launch count of :func:`coord_update`."""
    coord_update.launches = 0


#: kernel launches since the last reset (CPU calls do not count)
reset_launch_counts()
