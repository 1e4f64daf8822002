"""One round of gblinear's single-model block coordinate-descent sweep
(models/gblinear.py::train_gblinear), the port of the JAX package's jitted
round (``expecto_tpu/models/gblinear.py::_round_body``'s ``one_round``):

    db = eta * (-sum(r) / denom);  bias += db;  r += db
    for each block b in order:
        g = Xt[b] @ r;  dw = eta * coord_delta(g, h[b], w[b]);  w[b] += dw;  r += dw @ Xt[b]

Xt is (n_blocks, B, n) fp32 (the feature rows zero-padded to a multiple of
B), ``col_hess`` and ``w_blocks`` (n_blocks, B), ``bias`` (1,) and ``r``
(n,); ``w_blocks``, ``bias`` and ``r`` are updated in place.
:func:`gblinear_round` launches the hand-written CUDA kernel
``csrc/gblinear_round.cu`` (one cooperative launch a round, in place of two
GEMVs, the coordinate-update kernel and an add a block) for CUDA tensors and
takes :func:`gblinear_round_plain` for CPU tensors. A CUDA tensor launches
the kernel or raises. The kernel picks one of two shared-memory plans from
(n, B) and the card (:func:`round_plan`): "shared" keeps each CTA's rows of
r in shared memory, "streamed" (past about 3.8 million rows at B = 512 on an
H100) advances them in global memory.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from .gblinear_cd import coord_update_plain


def gblinear_round_plain(Xt: torch.Tensor, col_hess: torch.Tensor, w_blocks: torch.Tensor, bias: torch.Tensor,
                         r: torch.Tensor, scratch: torch.Tensor | None, denom: float, eta: float, lam: float,
                         alpha: float, *, update=coord_update_plain) -> None:
    """Plain PyTorch version: the bias step, then per block two
    ``torch.matmul`` products and ``update`` (the coordinate update,
    ``ops/gblinear_cd.py``'s signature). ``scratch`` is the kernel's and is
    not used here, so the two functions are interchangeable."""
    db = eta * (-r.sum() / denom)
    bias += db
    r += db
    for Xb, hb, wb in zip(Xt, col_hess, w_blocks):
        dw = update(Xb @ r, hb, wb, eta, lam, alpha)
        r += dw @ Xb


def row_plan(n: int, ctas: int) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of each CTA's rows of r in the kernel: CTA c owns
    [c n // ctas, (c + 1) n // ctas), so the CTAs cover [0, n) once, in
    order, each with at most ceil(n / ctas) rows (the kernel's ``row_lo``)."""
    bounds = np.arange(ctas + 1, dtype=np.int64) * n // ctas
    return bounds[:-1], bounds[1:]


def scratch_floats(ctas: int, b: int) -> int:
    """Floats of the kernel's scratch: each CTA's partial gradients of a
    block, each CTA's partial sum of r, and the block's updates."""
    return ctas * (b + 1) + b


@functools.lru_cache(maxsize=None)
def round_ctas(device_index: int, n: int, b: int) -> int:
    """CTAs of the kernel's cooperative grid on card ``device_index`` for n
    rows and blocks of ``b`` features: the occupancy query's co-resident
    CTAs an SM (at most one) times the SMs."""
    fn = cuda_build.load("gblinear_round").gblinear_round_ctas
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    with torch.cuda.device(device_index):
        ctas = fn(n, b)
    if ctas <= 0:
        raise RuntimeError(f"gblinear_round cannot launch {n} rows x blocks of {b} cooperatively: CUDA error {-ctas}")
    return ctas


@functools.lru_cache(maxsize=None)
def round_plan(device_index: int, n: int, b: int) -> str:
    """The kernel's shared-memory plan on card ``device_index`` for n rows
    and blocks of ``b`` features: "shared" while one CTA's rows of r fit its
    opt-in shared memory, else "streamed" (csrc/gblinear_round.cu's
    ``plan``)."""
    fn = cuda_build.load("gblinear_round").gblinear_round_streamed
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    with torch.cuda.device(device_index):
        streamed = fn(n, b)
    if streamed < 0:
        raise RuntimeError(f"gblinear_round cannot plan {n} rows x blocks of {b}: CUDA error {-streamed}")
    return "streamed" if streamed else "shared"


def round_scratch(Xt: torch.Tensor) -> torch.Tensor | None:
    """The kernel's scratch for a (n_blocks, B, n) ``Xt`` on its device,
    allocated once a training call; None for a CPU tensor (the plain
    version needs none)."""
    if Xt.device.type != "cuda":
        return None
    _, b, n = Xt.shape
    ctas = round_ctas(Xt.device.index, n, b)
    return torch.empty(scratch_floats(ctas, b), dtype=torch.float32, device=Xt.device)


def gblinear_round(Xt: torch.Tensor, col_hess: torch.Tensor, w_blocks: torch.Tensor, bias: torch.Tensor,
                   r: torch.Tensor, scratch: torch.Tensor | None, denom: float, eta: float, lam: float, alpha: float,
                   *, update=coord_update_plain) -> None:
    """One round in place: the CUDA kernel for CUDA tensors (one launch;
    ``scratch`` from :func:`round_scratch`), :func:`gblinear_round_plain`
    with ``update`` for CPU tensors. Raises on anything the kernel does not
    take (dtype, device, shape, contiguity) and if a launch fails."""
    named = (("Xt", Xt), ("col_hess", col_hess), ("w_blocks", w_blocks), ("bias", bias), ("r", r))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"gblinear_round takes fp32 tensors, got {name} {t.dtype}")
        if t.device != Xt.device:
            raise ValueError(f"gblinear_round needs every tensor on one device, got {name} on {t.device}, Xt on "
                             f"{Xt.device}")
        if not t.is_contiguous():
            raise ValueError(f"gblinear_round needs contiguous tensors, got {name} with strides {t.stride()}")
    if Xt.dim() != 3 or 0 in Xt.shape:
        raise ValueError(f"gblinear_round needs Xt of shape (n_blocks, B, n), got {tuple(Xt.shape)}")
    n_blocks, b, n = Xt.shape
    for name, t, shape in (("col_hess", col_hess, (n_blocks, b)), ("w_blocks", w_blocks, (n_blocks, b)),
                           ("bias", bias, (1,)), ("r", r, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"gblinear_round needs {name} of shape {shape} for Xt {tuple(Xt.shape)}, got "
                             f"{tuple(t.shape)}")
    if Xt.device.type == "cpu":
        gblinear_round_plain(Xt, col_hess, w_blocks, bias, r, scratch, denom, eta, lam, alpha, update=update)
        return
    if Xt.device.type != "cuda":
        raise ValueError(f"gblinear_round runs on CUDA or CPU tensors, got {Xt.device}")
    if max(n, n_blocks * b) >= 2**31:
        raise ValueError(f"gblinear_round takes fewer than 2**31 rows and features, got Xt {tuple(Xt.shape)}")
    ctas = round_ctas(Xt.device.index, n, b)
    if (scratch is None or scratch.dtype != torch.float32 or scratch.device != Xt.device
            or not scratch.is_contiguous() or scratch.numel() < scratch_floats(ctas, b)):
        raise ValueError(f"gblinear_round needs a contiguous fp32 scratch of {scratch_floats(ctas, b)} floats on "
                         f"{Xt.device} (round_scratch)")
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        err = cuda_build.launcher("gblinear_round", 4, 4, n_ptrs=6)(
            Xt.data_ptr(), col_hess.data_ptr(), w_blocks.data_ptr(), bias.data_ptr(), r.data_ptr(),
            scratch.data_ptr(), n_blocks, b, n, ctas, denom, eta, lam, alpha, stream)
    if err != 0:
        raise RuntimeError(f"gblinear_round kernel launch failed: CUDA error {err}")
    gblinear_round.launches += 1
    gblinear_round.launches_by_plan[round_plan(Xt.device.index, n, b)] += 1


def reset_launch_counts() -> None:
    """Zero the launch counts of :func:`gblinear_round`: in all and by
    shared-memory plan."""
    gblinear_round.launches = 0
    gblinear_round.launches_by_plan = {"shared": 0, "streamed": 0}


#: kernel launches since the last reset (CPU calls do not count)
reset_launch_counts()
