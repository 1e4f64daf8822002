"""The K-model trainer's block step (models/gblinear.py::multi_round), one
feature block of the block coordinate-descent sweep over K models:

    G = Xb @ (rw * r).T;  dw = eta * coord_delta(G, h, w);  w += dw;  r += dw.T @ Xb

Xb (B, n) fp32 the block's feature rows, rw and r (K, n) the row weights and
residuals of each model (the transpose of the JAX package's (n, K)), h and
w (B, K) the block's hessians and weights; w and r are updated in place.
X and the models' rows lie in the layouts of :func:`block_layout` and
:func:`transposed_rows`: rows :func:`row_stride` (n) floats apart. It is
the block step of the JAX package's
``expecto_tpu/models/gblinear.py::_multi_round_body`` (:246-251), an XLA
program (no Pallas kernel). On the card it is two hand-written kernels a
block:

- :func:`grad_update` → ``csrc/gblinear_block_grad.cu``: G in three TF32
  passes (rw * r made and split in shared memory from r and rw as they
  are) with the coordinate update in its epilogue, writing w in place and
  dw as the second kernel's operand (TF32 hi and lo planes);
- :func:`residual_update` → ``csrc/gblinear_block_resid.cu``: r += dw.T Xb
  in three TF32 passes, the add in its epilogue.

The route is :func:`block_route`, a pure function of
K and of the ranks of the process group: with one rank the update is fused
into the first kernel; with more the first kernel writes G, the group sums
it between the products, and ``csrc/gblinear_cd.cu``'s planes entry
(``ops/gblinear_cd.py::coord_update_planes``) applies the same step, so one
rank gives the fused route's bits. The kernels run three passes whatever
``GBLinearParams.precision`` says: that meets "highest" and is at least as
exact as "high" and "default".

The plain versions, :func:`grad_update_plain` and
:func:`residual_update_plain`, are the two torch statements the block step
was before the kernels; a wrapper takes them for CPU tensors. A CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import cuda_build
from .fc1 import resident_ctas
from .gblinear_cd import coord_update_plain, coord_update_planes

#: the kernels' constants (csrc/gblinear_block.cuh): rows of X's side a CTA
#: (two consumer warpgroups of 64), the contraction a stage, the widest
#: model tile (wgmma's N)
TILE_ROWS = 128
KC = 32
NT_MAX = 128


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class BlockRoute(NamedTuple):
    """How the card runs a block step of K models: ``fused`` (one rank: the
    coordinate update in the first kernel's epilogue) or the split route
    (G written, summed over the ranks, then updated); the models in
    ``tiles`` tiles of ``tile`` (a multiple of 8, at most 128), ``n_pad`` =
    tiles x tile rows of the operands' planes."""

    fused: bool
    tiles: int
    tile: int

    @property
    def n_pad(self) -> int:
        return self.tiles * self.tile


def block_route(k: int, ranks: int) -> BlockRoute:
    """The route of a block step of ``k`` models in a process group of
    ``ranks`` ranks (1 without a group): fused with one rank; the fewest
    model tiles of at most 128, each as narrow as they allow (K = 218: 2 of
    112). A pure function of (k, ranks), with no override."""
    if k <= 0 or ranks <= 0:
        raise ValueError(f"a block step needs K >= 1 models and ranks >= 1, got K = {k}, ranks = {ranks}")
    tiles = -(-k // NT_MAX)
    tile = -(-k // tiles)
    return BlockRoute(fused=ranks == 1, tiles=tiles, tile=-(-tile // 8) * 8)


def row_stride(n: int) -> int:
    """Floats between two rows of n values in :func:`block_layout` and
    :func:`transposed_rows`: n rounded up to a multiple of 8 (rows on
    32-byte sectors: the kernels' tensor maps take 16-byte multiples, and
    the residual kernel's epilogue writes whole sectors)."""
    return -(-n // 8) * 8


def block_layout(X: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n, f) -> the trainer's feature blocks (n_blocks, B, n): a view of a
    new zero (n_blocks, B, :func:`row_stride` (n)) tensor on X's device, the
    feature axis zero-padded to a multiple of B and each feature row padded
    to a 32-byte multiple."""
    n, f = X.shape
    n_blocks = -(-f // block_size)
    out = X.new_zeros((n_blocks, block_size, row_stride(n)))
    out.view(n_blocks * block_size, -1)[:f, :n] = X.T
    return out[..., :n]


def transposed_rows(A: torch.Tensor) -> torch.Tensor:
    """(n, K) -> its transpose (K, n): a view of a new zero (K,
    :func:`row_stride` (n)) tensor on A's device, each model's n values one
    row (the residuals' and row weights' layout of the K-model sweep)."""
    n, k = A.shape
    out = A.new_zeros((k, row_stride(n)))
    out[:, :n] = A.T
    return out[:, :n]


class GradSchedule(NamedTuple):
    """The first kernel's units on a card of ``ctas`` CTAs: ``feature_tiles``
    x model tiles x ``segments`` of the n rows' ``stages`` (32 rows each),
    ``units`` in all, on ``grid`` CTAs (every one resident)."""

    feature_tiles: int
    segments: int
    stages: int
    units: int
    grid: int


def grad_schedule(n: int, b: int, route: BlockRoute, ctas: int) -> GradSchedule:
    """Segments enough to fill ``ctas`` CTAs (at most one a 32-row stage):
    K = 218 at B = 512 takes 4 feature tiles x 2 model tiles x 16 segments
    on an H100's 132 SMs. A pure function of the shape and the card."""
    ft = -(-b // TILE_ROWS)
    stages = -(-n // KC)
    segments = max(1, min(stages, ctas // (ft * route.tiles)))
    units = ft * route.tiles * segments
    return GradSchedule(ft, segments, stages, units, min(units, ctas))


def grad_units(sched: GradSchedule, route: BlockRoute) -> list[list[tuple[int, int, int, int, int]]]:
    """The first kernel's walk: per CTA, its units in order as (feature
    tile, model tile, segment, first stage, end stage); feature tiles
    fastest, then model tiles, then segments, as the kernel's ``unit_of``."""
    walk = []
    for c in range(sched.grid):
        units = []
        for u in range(c, sched.units, sched.grid):
            ft, rest = u % sched.feature_tiles, u // sched.feature_tiles
            mt, s = rest % route.tiles, rest // route.tiles
            units.append((ft, mt, s, s * sched.stages // sched.segments, (s + 1) * sched.stages // sched.segments))
        walk.append(units)
    return walk


def resid_grid(n: int, route: BlockRoute, ctas: int) -> tuple[int, int]:
    """The second kernel's (units, grid): ceil(n / 128) row tiles x model
    tiles on at most ``ctas`` persistent CTAs."""
    units = -(-n // TILE_ROWS) * route.tiles
    return units, min(units, ctas)


@dataclass
class BlockScratch:
    """What the block step's kernels keep on the card for one sweep: the
    route, the first kernel's schedule, the second kernel's grid, the row
    stride ``ld`` of X, r and rw, dw's planes ``dw`` (2, n_pad, b_pad), the first kernel's ``parts``
    (segments, feature tiles x 128, n_pad), G (B, K) for the split route,
    and the grid barrier's two counters (``sync``)."""

    route: BlockRoute
    grad: GradSchedule
    resid_grid: int
    ld: int
    dw: torch.Tensor
    parts: torch.Tensor
    g: torch.Tensor
    sync: torch.Tensor

    @property
    def b_pad(self) -> int:
        return self.dw.shape[2]


def block_scratch(Xt: torch.Tensor, k: int, ranks: int) -> BlockScratch:
    """The scratch for ``Xt`` (n_blocks, B, n) from :func:`block_layout` on a
    CUDA device and ``k`` models in a group of ``ranks``. At the published
    shape (22,296 rows, 218 models) about 9 MB beside X's 1.99 GB."""
    _n_blocks, b, n = Xt.shape
    route = block_route(k, ranks)
    ctas = resident_ctas(Xt.device)
    grad = grad_schedule(n, b, route, ctas)
    _units, grid = resid_grid(n, route, ctas)
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, device=Xt.device, dtype=dtype)  # noqa: E731
    return BlockScratch(route=route, grad=grad, resid_grid=grid, ld=Xt.stride(1),
                        dw=zeros(2, route.n_pad, -(-b // KC) * KC),
                        parts=zeros(grad.segments, grad.feature_tiles * TILE_ROWS, route.n_pad), g=zeros(b, k),
                        sync=zeros(2, dtype=torch.int32))


def grad_update_plain(Xb: torch.Tensor, rw: torch.Tensor, r: torch.Tensor, hb: torch.Tensor, wb: torch.Tensor,
                      eta: float, lam: float, alpha: float, *, reduce=_identity, scratch=None,
                      update=coord_update_plain) -> torch.Tensor:
    """Plain PyTorch version of the first kernel: ``update(reduce(Xb @ (rw *
    r).T), hb, wb, ...)``, w updated in place; returns dw (B, K).
    ``scratch`` is the kernels' and is not used here."""
    return update(reduce(Xb @ (rw * r).T), hb, wb, eta, lam, alpha)


def residual_update_plain(Xb: torch.Tensor, dw: torch.Tensor, r: torch.Tensor, *, scratch=None) -> None:
    """Plain PyTorch version of the second kernel: ``r += dw.T @ Xb``
    (``scratch`` is the kernel's)."""
    r += dw.T @ Xb


def _check(Xb: torch.Tensor, r: torch.Tensor, rw: torch.Tensor, scratch: BlockScratch | None, what: str) -> None:
    """Raises on a CUDA input the kernels do not take (``rw`` may be
    ``r``: the residual kernel reads no row weights)."""
    for name, t in (("Xb", Xb), ("r", r), ("rw", rw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes fp32 tensors, got {name} {t.dtype}")
        if t.device != Xb.device:
            raise ValueError(f"{what} needs its tensors on one device, got {Xb.device}, {r.device}, {rw.device}")
    if Xb.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {Xb.device}")
    if scratch is None:
        raise ValueError(f"{what} on the card needs the sweep's BlockScratch (block_scratch)")
    b, n = Xb.shape
    ld = scratch.ld
    if (r.dim() != 2 or r.shape != rw.shape or r.shape[1] != n
            or any(t.stride() != (ld, 1) or t.data_ptr() % 32 for t in (r, rw))):
        raise ValueError(f"{what} takes r and rw (K, n) in transposed_rows' layout (rows {ld} floats apart, 32-byte "
                         f"aligned) with n = {n}, got {tuple(r.shape)} strides {r.stride()}, {tuple(rw.shape)} "
                         f"strides {rw.stride()}")
    route, k = scratch.route, r.shape[0]
    if Xb.stride(1) != 1 or Xb.stride(0) != ld or Xb.data_ptr() % 16:
        raise ValueError(f"{what} takes Xb in block_layout's layout (rows {ld} floats apart, 16-byte aligned), got "
                         f"strides {Xb.stride()}")
    if (scratch.dw.device != Xb.device or route != block_route(k, 1)._replace(fused=route.fused)
            or scratch.g.shape != (b, k) or scratch.b_pad < b):
        raise ValueError(f"{what}: the scratch was made for another block or K, not ({b}, {n}) x {k} models")


def _launch_grad(Xb: torch.Tensor, rw: torch.Tensor, r: torch.Tensor, scratch: BlockScratch, hb: torch.Tensor,
                 wb: torch.Tensor, eta: float, lam: float, alpha: float, *, fused: bool) -> None:
    """Launches the first kernel on checked CUDA inputs, fused (w and dw's
    planes written) or not (G written into ``scratch.g``); counts nothing.
    :func:`grad_update` calls it with its route's ``fused``; the card tests
    and ``scripts/probe_gblinear_block.py`` call both to hold them equal."""
    b, n = Xb.shape
    k, route, sched = scratch.g.shape[1], scratch.route, scratch.grad
    if fused and (hb.shape != (b, k) or wb.shape != (b, k) or not (hb.is_contiguous() and wb.is_contiguous())
                  or hb.dtype != torch.float32 or wb.dtype != torch.float32 or wb.device != Xb.device
                  or hb.device != Xb.device):
        raise ValueError(f"the block step takes h and w contiguous fp32 ({b}, {k}) on {Xb.device}, got "
                         f"{tuple(hb.shape)} {hb.dtype}, {tuple(wb.shape)} {wb.dtype}")
    with torch.cuda.device(Xb.device):
        stream = torch.cuda.current_stream(Xb.device).cuda_stream
        err = cuda_build.launcher("gblinear_block_grad", 10, 3, n_ptrs=9)(
            Xb.data_ptr(), r.data_ptr(), rw.data_ptr(), hb.data_ptr(), wb.data_ptr(), scratch.dw.data_ptr(),
            scratch.g.data_ptr(), scratch.parts.data_ptr(), scratch.sync.data_ptr(), n, Xb.stride(0), b, k,
            route.tile, route.tiles, scratch.b_pad, sched.segments, sched.grid, int(fused), eta, lam, alpha, stream)
    if err != 0:
        raise RuntimeError(f"gblinear_block_grad kernel launch failed: error {err}")


def grad_update(Xb: torch.Tensor, rw: torch.Tensor, r: torch.Tensor, hb: torch.Tensor, wb: torch.Tensor, eta: float,
                lam: float, alpha: float, *, reduce=_identity, scratch: BlockScratch | None = None,
                update=coord_update_plain) -> torch.Tensor:
    """The block's gradient and coordinate update, w updated in place;
    returns dw as the second kernel takes it. CPU tensors: the plain
    version (``update`` applies the step; dw (B, K)). CUDA: the first kernel
    on ``scratch`` (from :func:`block_scratch`); returns dw's planes
    ``scratch.dw``. On the split route the kernel writes
    G, ``reduce`` sums it over the ranks and ``coord_update_planes`` updates
    (``update`` is the CPU's only). Raises on anything the kernels do not
    take and if a launch fails."""
    if Xb.device.type == "cpu":
        return grad_update_plain(Xb, rw, r, hb, wb, eta, lam, alpha, reduce=reduce, update=update)
    _check(Xb, r, rw, scratch, "grad_update")
    fused = scratch.route.fused
    _launch_grad(Xb, rw, r, scratch, hb, wb, eta, lam, alpha, fused=fused)
    if not fused:
        coord_update_planes(reduce(scratch.g), hb, wb, scratch.dw, eta, lam, alpha)
    route = "fused" if fused else "split"
    grad_update.launches += 1
    grad_update.launches_by_route[route] += 1
    grad_update.launches_by_shape[(Xb.shape[0], Xb.shape[1], r.shape[0], route)] += 1
    return scratch.dw


def residual_update(Xb: torch.Tensor, dw: torch.Tensor, r: torch.Tensor, *,
                    scratch: BlockScratch | None = None) -> None:
    """r += dw.T @ Xb in place. CPU tensors: the plain version (dw (B, K)).
    CUDA: the second kernel on ``scratch``, dw being ``scratch.dw`` (what
    :func:`grad_update` returns). Raises on anything the kernel does not
    take and if the launch fails."""
    if Xb.device.type == "cpu":
        return residual_update_plain(Xb, dw, r)
    _check(Xb, r, r, scratch, "residual_update")
    if dw is not scratch.dw:
        raise ValueError("residual_update on the card takes dw as grad_update returns it (the scratch's planes)")
    b, n = Xb.shape
    k, route = r.shape[0], scratch.route
    with torch.cuda.device(Xb.device):
        stream = torch.cuda.current_stream(Xb.device).cuda_stream
        err = cuda_build.launcher("gblinear_block_resid", 8, 0, n_ptrs=3)(
            Xb.data_ptr(), scratch.dw.data_ptr(), r.data_ptr(), n, Xb.stride(0), b, k, route.tile, route.tiles,
            scratch.b_pad, scratch.resid_grid, stream)
    if err != 0:
        raise RuntimeError(f"gblinear_block_resid kernel launch failed: error {err}")
    residual_update.launches += 1
    residual_update.launches_by_shape[(b, n, k)] += 1


def reset_launch_counts() -> None:
    """Zero the launch counts of :func:`grad_update` (all, by route, by (B,
    n, K, route)) and :func:`residual_update` (all, by (B, n, K))."""
    grad_update.launches = 0
    grad_update.launches_by_route = Counter({"fused": 0, "split": 0})
    grad_update.launches_by_shape = Counter()
    residual_update.launches = 0
    residual_update.launches_by_shape = Counter()


#: kernel launches since the last reset (CPU calls do not count)
reset_launch_counts()
