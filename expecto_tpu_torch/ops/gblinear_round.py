"""One round of gblinear's single-model block coordinate-descent sweep
(models/gblinear.py::train_gblinear), the port of the JAX package's jitted
round (``expecto_tpu/models/gblinear.py::_round_body``'s ``one_round``):

    db = eta * (-sum(r) / denom);  bias += db;  r += db
    for each block b in order:
        g = Xt[b] @ r;  dw = eta * coord_delta(g, h[b], w[b]);  w[b] += dw;  r += dw @ Xt[b]

Xt is (n_blocks, B, n) fp32 (the feature rows zero-padded to a multiple of
B), a view whose feature rows lie :func:`feature_stride` (n) floats apart
(models/gblinear.py::_pad_blocks), ``col_hess`` and ``w_blocks`` (n_blocks,
B), ``bias`` (1,) and ``r`` (n,); ``w_blocks``, ``bias`` and ``r`` are
updated in place. :func:`gblinear_round` launches the hand-written CUDA
kernel ``csrc/gblinear_round.cu`` (one cooperative launch a round, in place
of two GEMVs, the coordinate-update kernel and an add a block) for CUDA
tensors and takes :func:`gblinear_round_plain` for CPU tensors. A CUDA
tensor launches the kernel or raises. The kernel's plan
(:func:`device_geometry` reads it) cuts each CTA's rows on 16-byte
boundaries (:func:`row_plan`) into tiles and stages, and picks one of two
plans from (n, B) and the card (:func:`round_plan`): "shared" keeps each
CTA's rows of r in shared memory, "streamed" (past 8,192 rows a CTA:
about 1.08 million rows on an H100) keeps them in global memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


def feature_stride(n: int) -> int:
    """Floats between two feature rows of X in the kernel's layout: n
    rounded up to a multiple of 4, so that every CTA's slice of a row starts
    on 16 bytes."""
    return -(-n // 4) * 4


def row_plan(n: int, ctas: int) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) of each CTA's rows of r in the kernel: CTA c owns the rows of
    the 4-row quads [c nq // ctas, (c + 1) nq // ctas), nq = ceil(n / 4)
    (the last quad cut at n), so the CTAs cover [0, n) once, in order, each
    slice starting on a multiple of 4 with at most 4 ceil(nq / ctas) rows
    (the kernel's ``row_lo``)."""
    quads = np.arange(ctas + 1, dtype=np.int64) * (-(-n // 4)) // ctas
    bounds = np.minimum(4 * quads, n)
    return bounds[:-1], bounds[1:]


class RoundGeometry(NamedTuple):
    """The kernel's plan for n rows and blocks of B features on a card
    (csrc/gblinear_round.cu's ``Plan``, in its order): the CTAs, the most
    rows a CTA owns, the tile width and the most tiles a CTA walks, feature
    rows a stage and stages a tile, stage slots, the cache slots among them
    (a block's stages kept in shared memory for the residual update; the
    rest are the ring), the residual update's feature groups, the plan, the
    dynamic shared memory (bytes), the card's opt-in limit, and the floats
    of r in shared memory."""

    ctas: int
    rows_max: int
    tile: int
    tiles_max: int
    stage_rows: int
    stages: int
    slots: int
    cache: int
    groups: int
    streamed: bool
    smem: int
    optin: int
    r_floats: int


def scratch_floats(ctas: int, b: int) -> int:
    """Floats of the kernel's scratch: each CTA's partial gradients of a
    block, each CTA's partial sum of r and the block's updates, each value
    an 8-byte word with its tag."""
    return 2 * (ctas * (b + 1) + b)


#: the next tag of each scratch's memory, by (device, address of its storage)
_next_tag: dict[tuple[str, int], int] = {}


def _tags(scratch: torch.Tensor, n_blocks: int) -> int:
    """The first of the 2 n_blocks + 1 tags a launch on ``scratch`` uses:
    above every tag that a launch on any view of the same memory used (a
    count kept by the scratch's storage, from 1: a zeroed scratch holds tag
    0); the storage is zeroed again before the count would pass 2^31.
    Raises while the current stream is capturing a CUDA graph: each replay
    would repeat the captured tags, and the kernel would read the words of
    the replay before as this one's."""
    if scratch.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("gblinear_round cannot be captured in a CUDA graph: each launch needs new tags")
    storage = scratch.untyped_storage()
    key = (str(scratch.device), storage.data_ptr())
    tag0 = _next_tag.get(key, 1)
    if tag0 + 2 * n_blocks + 1 >= 2**31:
        storage.fill_(0)
        tag0 = 1
    _next_tag[key] = tag0 + 2 * n_blocks + 1
    return tag0


@functools.lru_cache(maxsize=None)
def device_geometry(device_index: int, n: int, b: int) -> RoundGeometry:
    """The kernel's plan on card ``device_index`` (csrc/gblinear_round.cu's
    ``gblinear_round_geometry``)."""
    fn = cuda_build.load("gblinear_round").gblinear_round_geometry
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * len(RoundGeometry._fields))()
    with torch.cuda.device(device_index):
        err = fn(n, b, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"gblinear_round cannot launch {n} rows x blocks of {b} cooperatively: CUDA error {err}")
    v = list(out)
    v[9] = bool(v[9])
    return RoundGeometry(*v)


def round_ctas(device_index: int, n: int, b: int) -> int:
    """CTAs of the kernel's cooperative grid on card ``device_index`` for n
    rows and blocks of ``b`` features: one an SM."""
    return device_geometry(device_index, n, b).ctas


def round_plan(device_index: int, n: int, b: int) -> str:
    """The kernel's plan on card ``device_index`` for n rows and blocks of
    ``b`` features: "shared" while one CTA's rows of r (at most 8,192)
    stay in shared memory, else "streamed"."""
    return "streamed" if device_geometry(device_index, n, b).streamed else "shared"


def round_scratch(Xt: torch.Tensor) -> torch.Tensor | None:
    """The kernel's scratch for a (n_blocks, B, n) ``Xt`` on its device,
    allocated (zeroed: no word holds a launch's tag) once a training call;
    None for a CPU tensor (the plain version needs none)."""
    if Xt.device.type != "cuda":
        return None
    _, b, n = Xt.shape
    ctas = round_ctas(Xt.device.index, n, b)
    return torch.zeros(scratch_floats(ctas, b), dtype=torch.float32, device=Xt.device)


def _check_layout(Xt: torch.Tensor) -> None:
    """Xt (n_blocks, B, n) as the kernel reads it: contiguous feature rows a
    multiple of 4 floats apart, and the blocks B rows apart."""
    n_blocks, b, n = Xt.shape
    ld = Xt.stride(1)
    if Xt.stride(2) != 1 or ld < n or ld % 4 or (n_blocks > 1 and Xt.stride(0) != b * ld):
        raise ValueError(f"gblinear_round needs Xt's feature rows contiguous and a multiple of 4 floats apart, "
                         f"its blocks B rows apart (models/gblinear.py::_pad_blocks), got strides {Xt.stride()} "
                         f"for shape {tuple(Xt.shape)}")


def gblinear_round(Xt: torch.Tensor, col_hess: torch.Tensor, w_blocks: torch.Tensor, bias: torch.Tensor,
                   r: torch.Tensor, scratch: torch.Tensor | None, denom: float, eta: float, lam: float, alpha: float,
                   *, update=coord_update_plain) -> None:
    """One round in place: the CUDA kernel for CUDA tensors (one launch;
    ``scratch`` from :func:`round_scratch`), :func:`gblinear_round_plain`
    with ``update`` for CPU tensors. Raises on anything the kernel does not
    take (dtype, device, shape, layout), under a CUDA-graph capture
    (:func:`_tags`) and if a launch fails."""
    named = (("Xt", Xt), ("col_hess", col_hess), ("w_blocks", w_blocks), ("bias", bias), ("r", r))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"gblinear_round takes fp32 tensors, got {name} {t.dtype}")
        if t.device != Xt.device:
            raise ValueError(f"gblinear_round needs every tensor on one device, got {name} on {t.device}, Xt on "
                             f"{Xt.device}")
        if t is not Xt and not t.is_contiguous():
            raise ValueError(f"gblinear_round needs contiguous tensors, got {name} with strides {t.stride()}")
    if Xt.dim() != 3 or 0 in Xt.shape:
        raise ValueError(f"gblinear_round needs Xt of shape (n_blocks, B, n), got {tuple(Xt.shape)}")
    _check_layout(Xt)
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
    if max(Xt.stride(1), n_blocks * b) >= 2**31:
        raise ValueError(f"gblinear_round takes fewer than 2**31 rows and features, got Xt {tuple(Xt.shape)}")
    if Xt.data_ptr() % 16:
        raise ValueError("gblinear_round needs Xt on a 16-byte boundary (models/gblinear.py::_pad_blocks)")
    ctas = round_ctas(Xt.device.index, n, b)
    if (scratch is None or scratch.dtype != torch.float32 or scratch.device != Xt.device
            or not scratch.is_contiguous() or scratch.numel() < scratch_floats(ctas, b) or scratch.data_ptr() % 8):
        raise ValueError(f"gblinear_round needs a contiguous fp32 scratch of {scratch_floats(ctas, b)} floats on "
                         f"{Xt.device} (round_scratch)")
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        err = cuda_build.launcher("gblinear_round", 6, 4, n_ptrs=6)(
            Xt.data_ptr(), col_hess.data_ptr(), w_blocks.data_ptr(), bias.data_ptr(), r.data_ptr(),
            scratch.data_ptr(), n_blocks, b, n, Xt.stride(1), ctas, _tags(scratch, n_blocks), denom, eta, lam, alpha,
            stream)
    if err != 0:
        raise RuntimeError(f"gblinear_round kernel launch failed: CUDA error {err}")
    gblinear_round.launches += 1
    gblinear_round.launches_by_plan[round_plan(Xt.device.index, n, b)] += 1


def reset_launch_counts() -> None:
    """Zero the launch counts of :func:`gblinear_round`: in all and by
    plan."""
    gblinear_round.launches = 0
    gblinear_round.launches_by_plan = {"shared": 0, "streamed": 0}


#: kernel launches since the last reset (CPU calls do not count)
reset_launch_counts()
