"""fc1's strided product of the port (ops/fc1.py) against the JAX package's
``fc1_pre_from_phases`` (its ``lax.conv_general_dilated`` at precision
HIGHEST), fp32 on the CPU, where the port's wrapper takes the plain
PyTorch version; the packers' layouts, the TF32 split (emulated at
Beluga's full depth against float64), the route rule, the split plan and
the wrapper's checks. The CUDA kernels (csrc/fc1_strided_tc.cu, bf16;
csrc/fc1_split_tf32.cu, then csrc/fc1_strided_tf32x3_swap.cu or
csrc/fc1_strided_tf32x3.cu, fp32) run only on the card: the ``gpu`` cases
below hold them against the plain version (and the fp32 ones against a
float64 product) there and skip without a card. They import no JAX, so on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fc1.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from expecto_tpu_torch.ops import fc1, spans
from expecto_tpu_torch.ops.fc1 import (
    FC1_FRAMES,
    _check,
    TILES,
    _packed,
    _route,
    _windows,
    fc1_schedule,
    fc1_strided,
    fc1_strided_plain,
    frame_order,
    pack_weights_fc1,
    pack_weights_tf32x3,
    pack_weights_tf32x3_swap,
    schedule_units,
    split_planes,
    split_planes_plain,
    split_tf32,
    walk_period,
)
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

# fp32 sums of 106*C products in another order than XLA's: within 1e-5 of
# the largest output
REL_TOL = 1e-5
C, N_OUT, N = 16, 19, 2  # narrow widths; an out width that is not a multiple of 8


@pytest.fixture(scope="module")
def jax_spans():
    """The JAX package's spans module, imported here and not at the top so
    that the gpu cases run where JAX is absent (the card's machine)."""
    pytest.importorskip("jax")
    from expecto_tpu.ops import spans as jspans

    return jspans


def _inputs(n, f, c, n_out, seed):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((n, f, c)).astype(np.float32)
    w = (rng.standard_normal((FC1_FRAMES * c, n_out)) / np.sqrt(FC1_FRAMES * c)).astype(np.float32)
    b = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
    return buf, w, b


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * float(np.abs(want).max()))


def _jax_conv(buf, w, s0, stride, n_win):
    """The JAX package's strided conv on the same numbers, as
    ``fc1_pre_from_phases`` calls it."""
    from jax import lax

    kernel = w.reshape(FC1_FRAMES, buf.shape[2], w.shape[1])
    out = lax.conv_general_dilated(buf[:, s0:], kernel, (stride,), "VALID", dimension_numbers=("NWC", "WIO", "NWC"),
                                   precision=lax.Precision.HIGHEST)
    return np.asarray(out)[:, :n_win]


# (F, s0, stride, n_win): the 200-bp grid's stride of 25 frames, wider
# strides, a single window, windows that end on the last frame
STRIDED = [(210, 0, 25, 5), (210, 12, 25, 4), (160, 3, 50, 2), (130, 24, 1, 1), (260, 0, 7, 23), (240, 4, 130, 1),
           (131, 0, 25, 2)]


@pytest.mark.parametrize("f,s0,stride,n_win", STRIDED)
def test_plain_matches_jax_strided_conv(jax_spans, f, s0, stride, n_win):
    buf, w, _b = _inputs(N, f, C, N_OUT, seed=f + s0 + stride)
    got = fc1_strided_plain(torch.from_numpy(buf), torch.from_numpy(w), s0, stride, n_win)
    assert got.shape == (N, n_win, N_OUT) and got.dtype == torch.float32
    _assert_close(got.numpy(), _jax_conv(buf, w, s0, stride, n_win))


def _phase_buffers(offsets, f, seed):
    rng = np.random.default_rng(seed)
    return {ph: rng.standard_normal((N, f, C)).astype(np.float32)
            for ph in sorted({(o // 4) % 4 for o in offsets})}


# offsets of the shift windows in the span: the uniform 200-bp grids of
# maxshift 800 and 400 (two pool-2 phases each), an 800-bp grid (one phase,
# stride 50), and non-uniform grids that take the per-window fallback
UNIFORM = {"maxshift800": [s + 800 for s in (0, -200, -400, -600, -800, 200, 400, 600, 800)],
           "maxshift400": [0, 200, 400, 600, 800], "step800": [0, 800, 1600, 2400]}
NON_UNIFORM = {"two_strides": [0, 400, 1200], "unsorted": [1200, 0, 200], "single": [800]}


@pytest.mark.parametrize("grid", list(UNIFORM) + list(NON_UNIFORM))
def test_fc1_pre_from_phases_matches_jax(jax_spans, grid):
    """The port's fc1_pre_from_phases (through fc1_strided on uniform
    grids) against the JAX package's on the same phase buffers."""
    import jax.numpy as jnp

    offsets = {**UNIFORM, **NON_UNIFORM}[grid]
    f = max(130, max(o // 16 for o in offsets) + FC1_FRAMES)
    _buf, w, b = _inputs(N, f, C, N_OUT, seed=len(offsets))
    phases = _phase_buffers(offsets, f, seed=f)
    tparams = {"fc1": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}}
    jparams = {"fc1": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    got = spans.fc1_pre_from_phases(tparams, {ph: torch.from_numpy(x) for ph, x in phases.items()}, offsets)
    want = jax_spans.fc1_pre_from_phases(jparams, {ph: jnp.asarray(x) for ph, x in phases.items()}, offsets)
    assert got.shape == (N, len(offsets), N_OUT)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("grid,calls", [("maxshift800", [(0, 0, 25, 5), (2, 12, 25, 4)]),
                                        ("step800", [(0, 0, 50, 4)]), ("two_strides", []), ("single", [])])
def test_uniform_grids_take_fc1_strided(monkeypatch, grid, calls):
    """Each phase of a uniform grid is one fc1_strided call over its whole
    buffer (the kernel on the card); a non-uniform one calls it never."""
    offsets = {**UNIFORM, **NON_UNIFORM}[grid]
    f = max(130, max(o // 16 for o in offsets) + FC1_FRAMES)
    _buf, w, b = _inputs(N, f, C, N_OUT, seed=1)
    phases = {ph: torch.from_numpy(x) for ph, x in _phase_buffers(offsets, f, seed=2).items()}
    seen = []

    def spy(buf, w_, s0, stride, n_win):
        seen.append(({id(x): ph for ph, x in phases.items()}[id(buf)], s0, stride, n_win))
        return fc1_strided_plain(buf, w_, s0, stride, n_win)

    monkeypatch.setattr(spans, "fc1_strided", spy)
    spans.fc1_pre_from_phases({"fc1": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}}, phases, offsets)
    assert sorted(seen) == calls


def test_bf16_plain_sums_in_fp32_and_rounds_once():
    buf, w, _b = _inputs(N, 210, C, N_OUT, seed=3)
    b16, w16 = torch.from_numpy(buf).bfloat16(), torch.from_numpy(w).bfloat16()
    got = fc1_strided_plain(b16, w16, 0, 25, 5)
    assert got.dtype == torch.bfloat16
    want = fc1_strided_plain(b16.float(), w16.float(), 0, 25, 5)
    assert torch.equal(got, want.bfloat16())


def test_windows_past_the_buffer_raise():
    buf, w, _b = _inputs(N, 130, C, N_OUT, seed=4)
    with pytest.raises(ValueError, match="overrun"):
        fc1_strided_plain(torch.from_numpy(buf), torch.from_numpy(w), 0, 25, 2)


def _unpack(wp, period=1, k=None):
    """The inverse of pack_weights_fc1: (K padded to 64, padded Nout), the
    128-byte swizzle undone (slot s of column n holds piece s ^ (n % 8))
    and the K chunks put back from the frame walk of ``period``."""
    tiles, chunks = wp.shape[:2]
    lo = torch.arange(8)
    x = wp.reshape(tiles, chunks, 32, 8, 8, 8)[:, :, :, lo[:, None], lo[None, :] ^ lo[:, None]]
    full = x.permute(1, 4, 5, 0, 2, 3).reshape(chunks * 64, tiles * 256)
    if period > 1:
        inv = torch.empty(FC1_FRAMES, dtype=torch.long)
        inv[torch.tensor(frame_order(FC1_FRAMES, period))] = torch.arange(FC1_FRAMES)
        full = full.reshape(FC1_FRAMES, k // FC1_FRAMES, -1)[inv].reshape(k, -1)
    return full


def test_frame_order_and_walk_period():
    """The walk visits every frame once, stride apart within a residue; the
    period is the stride only where a 64-deep K chunk lies in one frame and
    windows overlap."""
    for period in (1, 7, 25, 50, 105):
        order = frame_order(FC1_FRAMES, period)
        assert sorted(order) == list(range(FC1_FRAMES))
        residues = [f % period for f in order]
        assert residues == sorted(residues) and all(
            b - a == period for a, b in zip(order, order[1:]) if a % period == b % period)
    assert frame_order(FC1_FRAMES, 25)[:6] == [0, 25, 50, 75, 100, 1]
    assert frame_order(FC1_FRAMES, 1) == list(range(FC1_FRAMES))
    assert walk_period(640, 25) == 25 and walk_period(64, 50) == 50
    assert walk_period(48, 25) == 1 and walk_period(640, 1) == 1 and walk_period(640, 106) == 1


# K = 106*C: a multiple of 64 at C = 32, 64 and Beluga's 640; at C = 8, 16
# and 48 the last stage is part padding; at C % 64 == 0 the frame walk of
# the stride (period) reorders the chunks
@pytest.mark.parametrize("c,n_out,dtype,period", [(32, 19, torch.float32, 1), (64, 256, torch.float32, 1),
                                                  (32, 257, torch.float32, 1), (64, 2003, torch.bfloat16, 25),
                                                  (16, 19, torch.float32, 1), (48, 64, torch.bfloat16, 1),
                                                  (8, 1, torch.float32, 1), (128, 300, torch.float32, 7)])
def test_packer_round_trips_and_pads_with_zeros(c, n_out, dtype, period):
    k = FC1_FRAMES * c
    w = torch.from_numpy(np.random.default_rng(c + n_out).standard_normal((k, n_out)).astype(np.float32)).to(dtype)
    wp = pack_weights_fc1(w, period)
    tiles, chunks = -(-n_out // 256), -(-k // 64)
    assert wp.shape == (tiles, chunks, 256, 8, 8) and wp.is_contiguous() and wp.dtype == w.dtype
    full = _unpack(wp, period, k)
    assert torch.equal(full[:k, :n_out], w)
    assert not full[:, n_out:].any() and not full[k:].any()
    # one stage: column n of tile t and chunk j is a 128-byte row whose slot
    # s holds K group s ^ (n % 8) of the chunk's 64 K rows, K-major
    nb, order = c // 64, frame_order(FC1_FRAMES, period)
    t, j, n = tiles - 1, chunks - 2, min(11, n_out - 1 - (tiles - 1) * 256)
    k0 = order[j // nb] * c + (j % nb) * 64 if period > 1 else j * 64
    col = t * 256 + n
    for slot in range(8):
        g = slot ^ (n % 8)
        assert torch.equal(wp[t, j, n, slot], w[k0 + 8 * g : k0 + 8 * g + 8, col])


def test_packed_is_cached_per_weight_tensor_and_version():
    """Per weight tensor, frame-walk period and version."""
    w = torch.ones((FC1_FRAMES * 64, 19))
    first = _packed(w)
    assert _packed(w) is first and _packed(w, 1) is first
    walked = _packed(w, 25)
    assert walked is not first and _packed(w, 25) is walked
    w.mul_(2.0)  # an in-place write bumps the version: repacked
    again = _packed(w)
    assert again is not first and torch.equal(_unpack(again)[:, :19], w)
    assert torch.equal(_unpack(_packed(w, 25), 25, w.shape[0])[:, :19], w)


def test_split_tf32_rounds_both_parts_to_nearest():
    """hi and lo are TF32 values (low 13 mantissa bits zero), hi is x
    rounded to nearest with ties away from zero (cvt.rna.tf32.f32), and hi +
    lo holds x within 2^-22 |x|; zeros split into zeros."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
                                         rng.random(1024), [0.0, -0.0, 1.0, -2.5]]).astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    # hi is the nearest TF32 value: within half a TF32 step (2^-11 of the binade)
    assert bool(((x - hi).abs() <= 2.0**-11 * x.abs()).all())
    # a tie (exactly half a step above 1) goes away from zero, as cvt.rna does
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert split_tf32(tie)[0].tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]
    assert not split_tf32(torch.zeros(3))[1].any()


def _unpack_tf32x3(wp, period=1, k=None):
    """The inverse of pack_weights_tf32x3: (hi, lo), each (K padded to 32,
    Nout padded to 128), the swizzle and the frame walk undone."""
    tiles, chunks, _two, bn = wp.shape[:4]
    lo8 = torch.arange(8)
    parts = []
    for part in range(2):
        x = wp[:, :, part].reshape(tiles, chunks, bn // 8, 8, 8, 4)[:, :, :, lo8[:, None], lo8[None, :] ^ lo8[:, None]]
        full = x.permute(1, 4, 5, 0, 2, 3).reshape(chunks * 32, tiles * bn)
        if period > 1:
            inv = torch.empty(FC1_FRAMES, dtype=torch.long)
            inv[torch.tensor(frame_order(FC1_FRAMES, period))] = torch.arange(FC1_FRAMES)
            full = full.reshape(FC1_FRAMES, k // FC1_FRAMES, -1)[inv].reshape(k, -1)
        parts.append(full)
    return parts


# the fp32 kernel's K chunk is 32 deep: at C = 32 and 640 the frame walk of
# the stride reorders the chunks; at C = 4 and 12 the last stage is part
# padding; Nout off the 128-column tile
@pytest.mark.parametrize("c,n_out,period", [(32, 19, 25), (4, 1, 1), (12, 130, 1), (64, 256, 7), (32, 2003, 1)])
def test_tf32x3_packer_splits_round_trips_and_pads_with_zeros(c, n_out, period):
    k = FC1_FRAMES * c
    w = torch.from_numpy(np.random.default_rng(c + n_out).standard_normal((k, n_out)).astype(np.float32))
    wp = pack_weights_tf32x3(w, period)
    tiles, chunks = -(-n_out // 128), -(-k // 32)
    assert wp.shape == (tiles, chunks, 2, 128, 8, 4) and wp.is_contiguous() and wp.dtype == torch.float32
    assert not (wp.view(torch.int32) & 0x1FFF).any()  # every stored value a TF32 value
    hi, lo = _unpack_tf32x3(wp, period, k)
    want_hi, want_lo = split_tf32(w)
    assert torch.equal(hi[:k, :n_out], want_hi) and torch.equal(lo[:k, :n_out], want_lo)
    assert bool(((w.double() - hi[:k, :n_out].double() - lo[:k, :n_out].double()).abs()
                 <= 2.0**-22 * w.double().abs()).all())
    for part in (hi, lo):
        assert not part[:, n_out:].any() and not part[k:].any()
    # one stage: column n of tile t and chunk j is a 128-byte row whose slot
    # s holds K group s ^ (n % 8) (4 floats) of the chunk's 32 K rows
    assert walk_period(c, 25, 32) == (25 if c % 32 == 0 else 1)
    nb, order = c // 32, frame_order(FC1_FRAMES, period)
    t, j, n = tiles - 1, chunks - 2, min(11, n_out - 1 - (tiles - 1) * 128)
    k0 = order[j // nb] * c + (j % nb) * 32 if period > 1 else j * 32
    for slot in range(8):
        g = slot ^ (n % 8)
        assert torch.equal(wp[t, j, 1, n, slot], want_lo[k0 + 4 * g : k0 + 4 * g + 4, t * 128 + n])


def test_packed_keys_on_the_route():
    """One weight tensor packed for each kernel it meets: the bf16 tc layout
    and the fp32 split, each cached."""
    w = torch.ones((FC1_FRAMES * 64, 19))
    tc, split = _packed(w, 1, "tc"), _packed(w, 1, "tf32x3")
    assert tc.shape == (1, FC1_FRAMES, 256, 8, 8) and split.shape == (1, 2 * FC1_FRAMES, 2, 128, 8, 4)
    assert _packed(w, 1, "tc") is tc and _packed(w, 1, "tf32x3") is split and _packed(w) is tc
    assert _packed(w, 25, "tf32x3") is not split


# Beluga's full depth, K = 106 * 640 = 67,840. The card check's fp32 limits
# (chip_smoke.py): the kernel within 1e-5 of max|y| of a float64 product of
# the same inputs; the plain SGEMM (TF32 off), which rounds a running fp32
# sum of 67,840 products (about 2^-24 sqrt(K) = 1.6e-5 of max|y| off), within
# 4e-5 of it, and the kernel within 4e-5 of the plain version
K_FULL, FP32_REL, FP32_PLAIN_REL = FC1_FRAMES * 640, 1e-5, 4e-5


def test_three_pass_split_holds_fp32_limit_at_belugas_depth():
    """The tf32x3 kernel's products, emulated at K = 67,840: each operand
    split (split_tf32) and lo*hi + hi*lo + hi*hi summed in float64, for a few
    windows of non-negative activations (after conv6's ReLU) and 64 columns
    of W. The split alone stays well inside the card check's limit against
    float64 (FP32_REL); a single TF32 pass (hi*hi, the planted fault) misses
    it, and the plain version's looser limit too."""
    rng = np.random.default_rng(17)
    a = rng.random((6, K_FULL)).astype(np.float32)
    w = (rng.standard_normal((K_FULL, 64)) / np.sqrt(K_FULL)).astype(np.float32)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    limit = FP32_REL * float(np.abs(exact).max())
    (a_hi, a_lo), (w_hi, w_lo) = ((p.double().numpy() for p in split_tf32(torch.from_numpy(x))) for x in (a, w))
    three = a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
    err3, err1 = float(np.abs(three - exact).max()), float(np.abs(a_hi @ w_hi - exact).max())
    assert err3 <= 0.1 * limit, (err3, limit)
    assert err1 > FP32_PLAIN_REL / FP32_REL * limit, (err1, limit)


@pytest.mark.parametrize("m,n_out,k", [(1135, 2003, K_FULL), (1600, 2003, K_FULL), (500, 2003, K_FULL),
                                       (60, 2003, K_FULL), (35, 19, FC1_FRAMES * 12), (20000, 2003, K_FULL)])
def test_tf32x3_schedule_covers_every_chunk_once(m, n_out, k):
    """The fp32 kernel's schedule at its own tiles (128 columns, 32-deep K
    chunks): never more CTAs than the card holds, every group at least 64
    chunks (2,048 K) where K has them, and each (row tile, column tile, K
    chunk) in exactly one unit of the walk."""
    tiles = TILES["tf32x3"]
    s = fc1_schedule(m, n_out, k, SMS, tiles=tiles)
    tiles_m, tiles_n, kt = -(-m // s.tile_rows), -(-n_out // 128), -(-k // 32)
    assert s.rows * s.cols * s.groups <= SMS and tiles_n % s.cols == 0
    assert s.groups == 1 or (tiles_n // s.cols) * kt // s.groups >= 64
    seen = Counter()
    for _cta, i, t, k0, k1, _slot in schedule_units(m, n_out, k, s, tiles):
        assert 0 <= i < tiles_m and 0 <= t < tiles_n and 0 <= k0 < k1 <= kt
        seen.update((i, t, j) for j in range(k0, k1))
    assert set(seen.values()) == {1} and len(seen) == tiles_m * tiles_n * kt


def test_route_is_a_pure_function_of_device_and_dtype():
    """CUDA bf16 takes the tc kernel at every M, CUDA fp32 one of its two
    kernels by M alone; the CPU takes the plain version; no flow computes
    in another dtype on the card, so such a buffer raises."""
    table = {("cpu", torch.float32, 1600): "cpu", ("cpu", torch.bfloat16, 4): "cpu",
             ("cuda", torch.bfloat16, 4): "tc", ("cuda", torch.bfloat16, 1600): "tc",
             ("cuda", torch.float32, 1600): "tf32x3", ("cuda", torch.float32, 4): "tf32x3_swap"}
    for _ in range(2):
        assert {key: _route(*key) for key in table} == table
    assert set(fc1.ROUTES) == {"tc", "tf32x3", "tf32x3_swap"} == set(TILES) == set(fc1.KERNELS)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            _route("cuda", dtype, 4)


K_BELUGA, SMS = FC1_FRAMES * 640, 132


def test_split_plan():
    """The schedule is a pure function of (M, Nout, K, the card's CTAs):
    never more CTAs than the card holds, every group at least 32 K chunks
    where K has them, balanced row tiles, and at the flows' shapes the
    split that keeps the most CTAs busy."""
    for m in (1, 60, 227, 500, 560, 908, 1120, 1135, 1600, 4096, 20000, 40000):
        s = fc1_schedule(m, 2003, K_BELUGA, SMS)
        assert s == fc1_schedule(m, 2003, K_BELUGA, SMS)
        tiles_m, kt = -(-m // s.tile_rows), K_BELUGA // 64
        assert s.tile_rows <= 128 and tiles_m == -(-m // 128) and s.tile_rows * tiles_m - m < tiles_m
        assert s.rows <= tiles_m and 8 % s.cols == 0
        assert s.rows * s.cols * s.groups <= SMS and (8 // s.cols) * kt // s.groups >= fc1._MIN_CHUNKS
    # gene chunks (M = 1,600: 13 row tiles of 124) in 5 groups of 13 x 2
    # CTAs, consensus chunks (M = 500: 4 row tiles of 125) in 33 groups of 4
    assert fc1_schedule(1600, 2003, K_BELUGA, SMS) == (124, 13, 2, 5)
    assert fc1_schedule(500, 2003, K_BELUGA, SMS) == (125, 4, 1, 33)
    assert fc1_schedule(1135, 2003, K_BELUGA, SMS) == (127, 9, 2, 7)
    # more row tiles than CTAs: one group of whole tiles, rows CTAs apart
    assert fc1_schedule(20000, 2003, K_BELUGA, SMS)[1:] == (132, 1, 1)
    # a short K: one group walks it all
    assert fc1_schedule(1, 2003, 2 * 64, SMS)[1:] == (1, 8, 1)
    assert fc1_schedule(1, 19, 64 + 16, SMS)[1:] == (1, 1, 1)
    # the probe's knobs are kept: here the row tiles of a tensor map over
    # whole samples of 100 windows (16 of 100 rows at M = 1,600)
    assert fc1_schedule(1600, 2003, K_BELUGA, SMS, groups=3, cols=4)[1:] == (13, 4, 3)
    assert fc1_schedule(1600, 2003, K_BELUGA, SMS, tile_rows=100)[:2] == (100, 16)
    with pytest.raises(ValueError, match="does not divide"):
        fc1_schedule(1600, 2003, K_BELUGA, SMS, cols=3)
    with pytest.raises(ValueError, match="1 to 128 rows"):
        fc1_schedule(1600, 2003, K_BELUGA, SMS, tile_rows=129)


# (M, Nout, K) of the flows (serving, h5, gene, consensus at Beluga's
# widths) and of the narrow test widths, and edges: a part stage, one
# column, more row tiles than SMs
SCHEDULE_SHAPES = [(1135, 2003, K_BELUGA), (908, 2003, K_BELUGA), (1120, 2003, K_BELUGA), (896, 2003, K_BELUGA),
                   (60, 2003, K_BELUGA), (1600, 2003, K_BELUGA), (500, 2003, K_BELUGA), (127, 2003, K_BELUGA),
                   (129, 2003, K_BELUGA), (35, 64, FC1_FRAMES * 48), (35, 1, FC1_FRAMES * 8),
                   (35, 257, FC1_FRAMES * 32), (20000, 2003, FC1_FRAMES * 64)]
# the schedule's own choice, and knobs forced as the probe forces them (2
# groups on one column block, row tiles of 100 rows)
KNOBS = {"own": {}, "forced": {"groups": 2, "cols": 1, "tile_rows": 100}}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("m,n_out,k", SCHEDULE_SHAPES)
def test_schedule_covers_every_chunk_once(m, n_out, k, knobs):
    """Each (row tile, column tile, K chunk) is in exactly one unit of the
    walk; a tile that one unit holds whole is stored, every other tile's
    parts go to distinct slots of its groups, at most two a group."""
    sched = fc1_schedule(m, n_out, k, SMS, **KNOBS[knobs])
    rows, cols, groups = sched.rows, sched.cols, sched.groups
    tiles_m = -(-m // sched.tile_rows)
    tiles_n, kt = -(-n_out // 256), -(-k // 64)
    seen = Counter()
    parts = {}
    for cta, i, t, k0, k1, slot in schedule_units(m, n_out, k, sched):
        assert 0 <= cta < rows * cols * groups and 0 <= i < tiles_m and 0 <= t < tiles_n and 0 <= k0 < k1 <= kt
        seen.update((i, t, j) for j in range(k0, k1))
        if slot is not None:
            assert slot // 2 == cta // (rows * cols)
            key = (i, t, slot)
            assert key not in parts
            parts[key] = (k0, k1)
    assert set(seen.values()) == {1} and len(seen) == tiles_m * tiles_n * kt
    by_tile = {}
    for (i, t, slot), (k0, k1) in parts.items():
        by_tile.setdefault((i, t), []).append((slot, k0, k1))
    for pieces in by_tile.values():
        pieces.sort()  # in slot order = in group order: K order
        assert len(pieces) >= 2 and pieces[0][1] == 0 and pieces[-1][2] == kt
        assert all(a[2] == b[1] for a, b in zip(pieces, pieces[1:]))


def _group_of(x, positions, groups):
    return ((x + 1) * groups - 1) // positions


def _emulate(buf, w, s0, stride, n_win, sms, knobs, route="tc", passes=3):
    """The kernel's arithmetic on the CPU, as its CTAs walk the schedule:
    A rows from the buffer at the walk's K offsets, B stages unswizzled
    from the packed weight, fp32 tiles stored whole or as parts, and the
    second pass summing each tile's parts in group order. fp32 routes: the three
    products lo*hi + hi*lo + hi*hi of a stage summed into a fresh fp32
    accumulator and promoted into the tile's fp32 sum; "tf32x3" at its
    tiles with W split by its packer and each A stage split as its
    consumers split it, "tf32x3_swap" at its own (at most 64 windows a
    tile) with the windows from the split pass's planes and each fp32 W
    stage split as its consumers split it (in registers: the same split).
    ``passes`` = 1 keeps hi*hi alone: a single TF32 pass."""
    n, _f, c = buf.shape
    tiles = TILES[route]
    bn, kc = tiles.bn, tiles.kc
    n_out, m, k = w.shape[1], n * n_win, FC1_FRAMES * c
    period = walk_period(c, stride, kc)
    sched = fc1_schedule(m, n_out, k, sms, tiles=tiles, **knobs)
    cols, groups, tm = sched.cols, sched.groups, sched.tile_rows
    kt, tiles_n = -(-k // kc), -(-n_out // bn)
    lo = torch.arange(8)

    def rows(x, at):
        return torch.nn.functional.pad(_windows(x.float(), at, stride, n_win).reshape(m, k), (0, kt * kc - k))

    def stages(wp):
        return wp.reshape(tiles_n, kt, bn // 8, 8, 8, kc // 8)[:, :, :, lo[:, None], lo[None, :] ^ lo[:, None]].reshape(
            tiles_n, kt, bn, kc)

    if route == "tc":
        a, b = rows(buf, s0), stages(pack_weights_fc1(w, period).float())
    elif route == "tf32x3":
        a = rows(buf, s0)
        wp = pack_weights_tf32x3(w, period)
        b, b_lo = stages(wp[:, :, 0]), stages(wp[:, :, 1])
    else:
        planes = split_planes_plain(buf, s0, (n_win - 1) * stride + FC1_FRAMES)
        a, a_lo = rows(planes[0], 0), rows(planes[1], 0)
        b = stages(pack_weights_tf32x3_swap(w, period))
    nb, order = (c // kc, frame_order(FC1_FRAMES, period)) if c % kc == 0 else (0, None)
    y = torch.zeros((m, tiles_n * bn))
    ws = {}
    for _cta, i, t, k0, k1, slot in schedule_units(m, n_out, k, sched, tiles):
        r = slice(min(m, i * tm), min(m, (i + 1) * tm))
        acc = torch.zeros((r.stop - r.start, bn))
        for j in range(k0, k1):
            koff = order[j // nb] * c + (j % nb) * kc if nb else j * kc
            if route == "tc":
                acc += a[r, koff : koff + kc] @ b[t, j].T
            else:
                if route == "tf32x3_swap":
                    (w_hi, w_lo), x_hi, x_lo = split_tf32(b[t, j]), a[r, koff : koff + kc], a_lo[r, koff : koff + kc]
                else:
                    (x_hi, x_lo), w_hi, w_lo = split_tf32(a[r, koff : koff + kc]), b[t, j], b_lo[t, j]
                stage = x_hi @ w_hi.T
                if passes == 3:
                    stage = x_lo @ w_hi.T + x_hi @ w_lo.T + stage
                acc += stage
        if slot is None:
            y[r, t * bn : (t + 1) * bn] = acc
        else:
            ws.setdefault((slot, t), torch.zeros((m, bn)))[r] = acc
    positions = tiles_n // cols * kt
    for t in range(tiles_n):
        cb = t // cols
        qf, ql = _group_of(cb * kt, positions, groups), _group_of(cb * kt + kt - 1, positions, groups)
        if qf != ql:
            parts = [ws[(2 * q + int(q * positions // groups // kt != cb), t)] for q in range(qf, ql + 1)]
            y[:, t * bn : (t + 1) * bn] = sum(parts[1:], parts[0])
    return y[:, :n_out].reshape(n, n_win, n_out)


# (N, F, C, s0, stride, n_win, Nout, SMs): the walk of period 25 and 1, K
# off the stage, columns off the tile, many groups on few K chunks, one
# sample of 100 windows
EMULATED = [(3, 160, 64, 12, 25, 2, 300, 132), (7, 300, 48, 12, 25, 5, 64, 132), (5, 240, 16, 0, 50, 2, 19, 8),
            (2, 131, 64, 0, 25, 1, 257, 3), (1, 2594, 8, 0, 25, 100, 1, 132), (9, 206, 64, 0, 25, 5, 530, 20)]


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("n,f,c,s0,stride,n_win,n_out,sms", EMULATED)
def test_emulated_kernel_walk_matches_plain(n, f, c, s0, stride, n_win, n_out, sms, knobs):
    buf, w, _b = _inputs(n, f, c, n_out, seed=n + f + c)
    got = _emulate(torch.from_numpy(buf), torch.from_numpy(w), s0, stride, n_win, sms, KNOBS[knobs])
    want = fc1_strided_plain(torch.from_numpy(buf), torch.from_numpy(w), s0, stride, n_win)
    _assert_close(got.numpy(), want.numpy())


# (N, F, C, s0, stride, n_win, Nout, SMs) for the fp32 kernel: the walk of
# period 25 (C % 32 == 0) and 1, K off the 32-deep stage (C = 12), columns
# off the 128-column tile, many groups on few chunks, one sample of 100
# windows
EMULATED_TF32 = [(3, 160, 32, 12, 25, 2, 300, 132), (7, 300, 12, 12, 25, 5, 64, 132), (5, 240, 16, 0, 50, 2, 19, 8),
                 (2, 131, 64, 0, 25, 1, 257, 3), (1, 2594, 4, 0, 25, 100, 1, 132), (9, 206, 32, 0, 25, 5, 530, 20)]


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("n,f,c,s0,stride,n_win,n_out,sms", EMULATED_TF32)
def test_emulated_tf32x3_walk_matches_plain(n, f, c, s0, stride, n_win, n_out, sms, knobs):
    """The fp32 kernel's walk at its own tiles, with the three-pass split,
    against the plain fp32 version."""
    buf, w, _b = _inputs(n, f, c, n_out, seed=n + f + c + 1)
    got = _emulate(torch.from_numpy(buf), torch.from_numpy(w), s0, stride, n_win, sms, KNOBS[knobs], "tf32x3")
    want = fc1_strided_plain(torch.from_numpy(buf), torch.from_numpy(w), s0, stride, n_win)
    _assert_close(got.numpy(), want.numpy())


@pytest.mark.parametrize("m", [1, 4, 5, fc1.SWAP_MAX_M - 1, fc1.SWAP_MAX_M, fc1.SWAP_MAX_M + 1, 128, 1600])
def test_fp32_route_is_a_pure_function_of_the_shape(m):
    """CUDA fp32 takes the swapped kernel up to SWAP_MAX_M windows a call
    (one window tile) and the tf32x3 kernel past it, whatever else the call
    holds: the route depends on M alone, the same on every call."""
    want = "tf32x3_swap" if m <= fc1.SWAP_MAX_M else "tf32x3"
    assert fc1.SWAP_MAX_M <= TILES["tf32x3_swap"].tm
    assert [_route("cuda", torch.float32, m) for _ in range(2)] == [want, want]
    assert _route("cuda", torch.bfloat16, m) == "tc" and _route("cpu", torch.float32, m) == "cpu"


def _unpack_swap(wp, period=1, k=None):
    """The inverse of pack_weights_tf32x3_swap: (K padded to 32, Nout
    padded to 128), the swizzle and the frame walk undone."""
    tiles, chunks, bn = wp.shape[:3]
    lo8 = torch.arange(8)
    x = wp.reshape(tiles, chunks, bn // 8, 8, 8, 4)[:, :, :, lo8[:, None], lo8[None, :] ^ lo8[:, None]]
    full = x.permute(1, 4, 5, 0, 2, 3).reshape(chunks * 32, tiles * bn)
    if period > 1:
        inv = torch.empty(FC1_FRAMES, dtype=torch.long)
        inv[torch.tensor(frame_order(FC1_FRAMES, period))] = torch.arange(FC1_FRAMES)
        full = full.reshape(FC1_FRAMES, k // FC1_FRAMES, -1)[inv].reshape(k, -1)
    return full


# the swapped kernel's W: fp32 as it is, 128-column tiles of 32-deep K
# chunks; the frame walk of the stride at C % 32 == 0, K off the stage at C
# = 4 and 12, Nout off the tile
@pytest.mark.parametrize("c,n_out,period", [(32, 19, 25), (4, 1, 1), (12, 130, 1), (64, 256, 7), (32, 2003, 1)])
def test_swap_packer_round_trips_and_pads_with_zeros(c, n_out, period):
    k = FC1_FRAMES * c
    w = torch.from_numpy(np.random.default_rng(c + n_out + 1).standard_normal((k, n_out)).astype(np.float32))
    wp = pack_weights_tf32x3_swap(w, period)
    tiles, chunks = -(-n_out // 128), -(-k // 32)
    assert wp.shape == (tiles, chunks, 128, 8, 4) and wp.is_contiguous() and wp.dtype == torch.float32
    full = _unpack_swap(wp, period, k)
    assert torch.equal(full[:k, :n_out], w)  # not split: the kernel splits it
    assert not full[:, n_out:].any() and not full[k:].any()
    # one stage: W column n of tile t and chunk j is a 128-byte K-major row
    # (wgmma's A operand) whose slot s holds K group s ^ (n % 8)
    nb, order = c // 32, frame_order(FC1_FRAMES, period)
    t, j, n = tiles - 1, chunks - 2, min(11, n_out - 1 - (tiles - 1) * 128)
    k0 = order[j // nb] * c + (j % nb) * 32 if period > 1 else j * 32
    for slot in range(8):
        g = slot ^ (n % 8)
        assert torch.equal(wp[t, j, n, slot], w[k0 + 4 * g : k0 + 4 * g + 4, t * 128 + n])


def test_swap_packing_is_cached_on_its_own_route():
    """The swapped kernel's fp32 W is cached beside the split one: a weight
    that meets both fp32 kernels is packed once for each."""
    w = torch.ones((FC1_FRAMES * 32, 19))
    swap, split = _packed(w, 1, "tf32x3_swap"), _packed(w, 1, "tf32x3")
    assert swap.shape == (1, FC1_FRAMES, 128, 8, 4) and split.shape == (1, FC1_FRAMES, 2, 128, 8, 4)
    assert _packed(w, 1, "tf32x3_swap") is swap and torch.equal(swap, pack_weights_tf32x3_swap(w))
    assert _packed(w, 25, "tf32x3_swap") is not swap


@pytest.mark.parametrize("m,n_out,k", [(1, 2003, K_FULL), (4, 2003, K_FULL), (5, 2003, K_FULL), (60, 2003, K_FULL),
                                       (64, 2003, K_FULL), (65, 2003, K_FULL), (129, 2003, K_FULL),
                                       (512, 2003, K_FULL), (35, 19, FC1_FRAMES * 12), (9, 257, FC1_FRAMES * 32)])
def test_swap_schedule_covers_every_chunk_once(m, n_out, k):
    """The swapped kernel's schedule (128 W columns, at most 64 windows a
    tile, 32-deep K chunks): never more CTAs than the card holds, one
    window tile up to 64 windows, every group at least 64 chunks where K
    has them, and each (window tile, column tile, K chunk) in exactly one
    unit of the walk."""
    tiles = TILES["tf32x3_swap"]
    s = fc1_schedule(m, n_out, k, SMS, tiles=tiles)
    tiles_m, tiles_n, kt = -(-m // s.tile_rows), -(-n_out // 128), -(-k // 32)
    assert s.tile_rows <= 64 and (m > 64 or tiles_m == 1) and s.rows * s.cols * s.groups <= SMS
    assert s.groups == 1 or (tiles_n // s.cols) * kt // s.groups >= 64
    seen = Counter()
    for _cta, i, t, k0, k1, _slot in schedule_units(m, n_out, k, s, tiles):
        assert 0 <= i < tiles_m and 0 <= t < tiles_n and 0 <= k0 < k1 <= kt
        seen.update((i, t, j) for j in range(k0, k1))
    assert set(seen.values()) == {1} and len(seen) == tiles_m * tiles_n * kt
    if m <= fc1.SWAP_MAX_M and k == K_FULL:
        assert s.rows * s.cols * s.groups == SMS  # the 132 SMs all stream W


SWAP_KNOBS = {"own": {}, "forced": {"groups": 2, "cols": 1, "tile_rows": 24}}
# (N, F, C, s0, stride, n_win, Nout, SMs) for the swapped kernel: one window
# tile (M 4-64; several at the forced 24 rows), several (M 65, 100), the
# walk of period 25 and 1, K off the stage, columns off the tile, many
# groups on few chunks
EMULATED_SWAP = [(2, 160, 32, 12, 25, 2, 300, 132), (7, 300, 12, 12, 25, 5, 64, 132), (5, 240, 16, 0, 50, 2, 19, 8),
                 (16, 206, 32, 0, 25, 4, 130, 132), (13, 206, 4, 0, 25, 5, 1, 132), (1, 2594, 8, 0, 25, 100, 19, 20)]


@pytest.mark.parametrize("knobs", list(SWAP_KNOBS))
@pytest.mark.parametrize("n,f,c,s0,stride,n_win,n_out,sms", EMULATED_SWAP)
def test_emulated_swap_walk_matches_plain_and_float64(n, f, c, s0, stride, n_win, n_out, sms, knobs):
    """The swapped kernel's walk (windows from the split planes, each W
    stage split as its consumers split it, a fresh accumulator a stage
    promoted into the sum, parts summed in group order) against the plain
    fp32 version and a float64 product, at narrow widths."""
    buf, w, _b = _inputs(n, f, c, n_out, seed=n + f + c + 2)
    b_t, w_t = torch.from_numpy(buf), torch.from_numpy(w)
    got = _emulate(b_t, w_t, s0, stride, n_win, sms, SWAP_KNOBS[knobs], "tf32x3_swap")
    _assert_close(got.numpy(), fc1_strided_plain(b_t, w_t, s0, stride, n_win).numpy())
    exact = (_windows(b_t.double(), s0, stride, n_win) @ w_t.double()).numpy()
    _assert_close(got.numpy(), exact)


@pytest.mark.parametrize("n,n_win", [(1, 5), (16, 4)])
def test_swap_walk_holds_fp32_limit_at_belugas_depth(n, n_win):
    """The swapped kernel's walk at K = 67,840 (C = 640) on 3 columns, at
    the single-sample tail (M = 5) and a full window tile (M = 64): within
    FP32_REL of max|y| of float64 and FP32_PLAIN_REL of the plain SGEMM's
    stand-in; a single TF32 pass a stage (the planted fault) misses the
    plain version's looser limit."""
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.random((n, 206, 640)).astype(np.float32))  # after conv6's ReLU: non-negative
    w = torch.from_numpy((rng.standard_normal((K_FULL, 3)) / np.sqrt(K_FULL)).astype(np.float32))
    exact = _windows(buf.double(), 0, 25, n_win) @ w.double()
    limit = FP32_REL * float(exact.abs().max())
    got = _emulate(buf, w, 0, 25, n_win, SMS, {}, "tf32x3_swap")
    assert float((got.double() - exact).abs().max()) <= limit
    assert float((got - fc1_strided_plain(buf, w, 0, 25, n_win)).abs().max()) <= FP32_PLAIN_REL / FP32_REL * limit
    single = _emulate(buf, w, 0, 25, n_win, SMS, {}, "tf32x3_swap", passes=1)
    assert float((single.double() - exact).abs().max()) > FP32_PLAIN_REL / FP32_REL * limit


@pytest.mark.parametrize("s0,span,view", [(0, 206, False), (12, 181, False), (3, 106, True)])
def test_split_pass_plain_version_is_split_tf32(s0, span, view):
    """The split pass's plain version: the frames s0 .. s0 + span - 1 as
    (2, N, span, C), split_tf32's hi then lo; on the CPU the wrapper is the
    plain version (a splice view too) and launches nothing."""
    rng = np.random.default_rng(s0 + span)
    base = torch.from_numpy((rng.standard_normal((3, 207, 8)) * 10.0 ** rng.integers(-4, 4, (3, 207, 8)))
                            .astype(np.float32))
    buf = base[:, :206] if view else base[:, :206].contiguous()
    fc1.reset_launch_counts()
    planes = split_planes(buf, s0, span)
    hi, lo = split_tf32(buf[:, s0 : s0 + span])
    assert planes.shape == (2, 3, span, 8) and planes.is_contiguous()
    assert torch.equal(planes[0], hi) and torch.equal(planes[1], lo)
    assert torch.equal(split_planes_plain(buf, s0, span), planes) and split_planes.launches == 0
    err = (buf[:, s0 : s0 + span].double() - planes[0].double() - planes[1].double()).abs()
    assert bool((err <= 2.0**-22 * buf[:, s0 : s0 + span].double().abs()).all())


def _good(f=240, c=32, n_out=19, n=2):
    buf = torch.zeros((n, f, c), dtype=torch.bfloat16)
    return buf, torch.zeros((FC1_FRAMES * c, n_out), dtype=torch.bfloat16)


@pytest.mark.parametrize("case,exc,match", [
    ("fp32", TypeError, "of one dtype"),
    ("w_fp32", TypeError, "of one dtype"),
    ("fp16", TypeError, "bfloat16 or float32"),
    ("c_off_fp32", ValueError, "C % 4"),
    ("sample_stride_fp32", ValueError, "multiple of 4 elements"),
    ("buf_2d", ValueError, r"buf \(N, F, C\)"),
    ("w_rows", ValueError, "does not match"),
    ("c_off", ValueError, "C % 8"),
    ("overrun", ValueError, "do not fit"),
    ("negative_s0", ValueError, "do not fit"),
    ("zero_stride", ValueError, "do not fit"),
    ("channel_stride", ValueError, "contiguous rows"),
    ("w_transposed", ValueError, "contiguous rows"),
    ("misaligned", ValueError, "16-byte-aligned"),
    ("cpu", ValueError, "CUDA device"),
])
def test_check_refuses(case, exc, match):
    buf, w = _good()
    s0, stride, n_win = 0, 25, 4
    if case == "fp32":
        buf = buf.float()
    elif case == "w_fp32":
        w = w.float()
    elif case == "fp16":
        buf, w = buf.half(), w.half()
    elif case == "c_off_fp32":
        buf, w = (x.float() for x in _good(c=6))
    elif case == "sample_stride_fp32":
        buf, w = torch.zeros((2, 241 * 32 + 2), dtype=torch.float32)[:, : 240 * 32].view(2, 240, 32), w.float()
    elif case == "buf_2d":
        buf = buf[0]
    elif case == "w_rows":
        w = w[:-64]
    elif case == "c_off":
        buf, w = _good(c=12)
    elif case == "overrun":
        n_win = 7  # the 7th window ends at frame 256 of 240
    elif case == "negative_s0":
        s0 = -1
    elif case == "zero_stride":
        stride = 0
    elif case == "channel_stride":
        buf = torch.zeros((2, 240, 64), dtype=torch.bfloat16)[:, :, ::2]
    elif case == "w_transposed":
        w = torch.zeros((19, FC1_FRAMES * 32), dtype=torch.bfloat16).T
    elif case == "misaligned":
        flat = torch.zeros(2 * 240 * 32 + 8, dtype=torch.bfloat16)
        buf = flat[1 : 1 + 2 * 240 * 32].view(2, 240, 32)
        assert buf.data_ptr() % 16
    with pytest.raises(exc, match=match):
        _check(buf, w, s0, stride, n_win)


@pytest.mark.parametrize("c", [8, 16, 48])
def test_check_takes_k_off_the_stage(c):
    """106*C need not be a multiple of the kernel's 64-deep stage: the last
    stage is zero-padded (here only the device is left to refuse)."""
    buf, w = _good(c=c)
    with pytest.raises(ValueError, match="CUDA device"):
        _check(buf, w, 0, 25, 4)


@pytest.mark.parametrize("c", [4, 12, 640])
def test_check_takes_fp32_rows_of_16_bytes(c):
    """fp32 buf and W, C % 4 == 0 (here only the device is left to
    refuse)."""
    buf, w = (x.float() for x in _good(c=c))
    with pytest.raises(ValueError, match="CUDA device"):
        _check(buf, w, 0, 25, 4)


def test_check_takes_a_splice_view():
    """The consensus splice hands over (N, F, C) views of (N, F+1, C)
    buffers: samples (F+1)*C elements apart are taken in place (on the card;
    here only the device is left to refuse)."""
    base = torch.zeros((2, 241, 32), dtype=torch.bfloat16)
    buf = base[:, :240]
    assert not buf.is_contiguous()
    _buf, w = _good()
    with pytest.raises(ValueError, match="CUDA device"):
        _check(buf, w, 0, 25, 4)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    fc1.reset_launch_counts()
    buf, w, _b = _inputs(N, 210, C, N_OUT, seed=5)
    for dtype in (torch.float32, torch.bfloat16):
        b_t, w_t = torch.from_numpy(buf).to(dtype), torch.from_numpy(w).to(dtype)
        assert torch.equal(fc1_strided(b_t, w_t, 12, 25, 4), fc1_strided_plain(b_t, w_t, 12, 25, 4))
    assert fc1_strided.launches == 0 and not fc1_strided.launches_by_shape


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (N, F, s0, stride, n_win) at Beluga's widths (C 640, Nout 2,003): a serving
# chunk's two phases (227 spans of 3,600 bp), an h5 pair chunk's (224 spans),
# a gene chunk's (16 spans of 41,800 bp, 100 windows a phase) and a
# consensus patch batch
CARD_SHAPES = [(227, 206, 0, 25, 5), (227, 206, 12, 25, 4), (224, 206, 0, 25, 5), (128, 206, 12, 25, 4),
               (16, 2594, 0, 25, 100), (16, 2594, 12, 25, 100), (5, 2614, 0, 25, 100), (3, 131, 0, 25, 2)]


def _card_inputs(n, f, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.rand((n, f, 640), generator=g, device=device).bfloat16()
    w = (torch.randn((FC1_FRAMES * 640, 2003), generator=g, device=device) / (FC1_FRAMES * 640) ** 0.5).bfloat16()
    return buf, w


def _card_tol(want):
    """Two bf16 steps (2^-8 relative each) of the largest output: both sides
    round an fp32 sum of the same bf16 products, taken in another order."""
    return 2 * 2.0**-8 * float(want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,s0,stride,n_win", CARD_SHAPES)
def test_kernel_matches_plain_and_repeats_bit_for_bit(cuda, n, f, s0, stride, n_win):
    buf, w = _card_inputs(n, f, n + f + s0, cuda)
    _kernel_matches_plain(buf, w, n, f, s0, stride, n_win)


def _kernel_matches_plain(buf, w, n, f, s0, stride, n_win):
    before = fc1_strided.launches
    got = fc1_strided(buf, w, s0, stride, n_win)
    again = fc1_strided(buf, w, s0, stride, n_win)
    torch.cuda.synchronize()
    assert fc1_strided.launches == before + 2
    assert got.shape == (n, n_win, 2003) and got.dtype == torch.bfloat16 and got.device.type == "cuda"
    assert torch.equal(got, again)
    want = fc1_strided_plain(buf, w, s0, stride, n_win)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _card_tol(want), err
    # a window read one frame late misses the tolerance
    late = want.clone()
    late[:, 0] = fc1_strided_plain(buf, w, s0 + 1, stride, 1)[:, 0]
    assert float((got.float() - late.float()).abs().max()) > _card_tol(want)


# (N, F, C, s0, stride, n_win, Nout) at the edges of the kernel's tiles and
# schedule: M one below and one above a 128-row tile, one sample of 100
# windows, a part stage (C = 48), one column and 257 columns
CARD_EDGE_SHAPES = [(127, 206, 640, 0, 25, 1, 2003), (43, 206, 640, 12, 25, 3, 2003),
                    (1, 2594, 640, 0, 25, 100, 2003), (7, 300, 48, 12, 25, 5, 2003), (9, 206, 640, 0, 25, 5, 1),
                    (9, 206, 640, 12, 25, 4, 257)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,c,s0,stride,n_win,n_out", CARD_EDGE_SHAPES)
def test_kernel_at_tile_edges_repeats_on_a_second_stream(cuda, n, f, c, s0, stride, n_win, n_out):
    g = torch.Generator(device=cuda).manual_seed(n + c + n_out)
    buf = torch.rand((n, f, c), generator=g, device=cuda).bfloat16()
    w = (torch.randn((FC1_FRAMES * c, n_out), generator=g, device=cuda) / (FC1_FRAMES * c) ** 0.5).bfloat16()
    got = fc1_strided(buf, w, s0, stride, n_win)
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = fc1_strided(buf, w, s0, stride, n_win)
    torch.cuda.synchronize()
    assert got.shape == (n, n_win, n_out) and torch.equal(got, again)
    want = fc1_strided_plain(buf, w, s0, stride, n_win)
    assert float((got.float() - want.float()).abs().max()) <= _card_tol(want)


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_out", [(48, 64), (16, 19), (8, 1), (32, 257)])
def test_kernel_takes_narrow_widths(cuda, c, n_out):
    """Test widths: 106*C off the 64-deep stage (the last one zero-padded),
    Nout off the 256-column tile, down to one column."""
    g = torch.Generator(device=cuda).manual_seed(c)
    buf = torch.rand((7, 300, c), generator=g, device=cuda).bfloat16()
    w = (torch.randn((FC1_FRAMES * c, n_out), generator=g, device=cuda) / (FC1_FRAMES * c) ** 0.5).bfloat16()
    got = fc1_strided(buf, w, 12, 25, 5)
    want = fc1_strided_plain(buf, w, 12, 25, 5)
    assert got.shape == (7, 5, n_out)
    assert float((got.float() - want.float()).abs().max()) <= _card_tol(want)
    assert torch.equal(got, fc1_strided(buf, w, 12, 25, 5))


@pytest.mark.gpu
def test_kernel_reads_a_splice_view_in_place(cuda):
    base, w = _card_inputs(5, 207, 9, cuda)
    buf = base[:, :206]
    got = fc1_strided(buf, w, 12, 25, 4)
    want = fc1_strided_plain(buf.contiguous(), w, 12, 25, 4)
    assert float((got.float() - want.float()).abs().max()) <= _card_tol(want)


def _card_inputs_fp32(n, f, c, n_out, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.rand((n, f, c), generator=g, device=device)
    w = torch.randn((FC1_FRAMES * c, n_out), generator=g, device=device) / (FC1_FRAMES * c) ** 0.5
    return buf, w


def _tf32x3_matches_plain_and_float64(buf, w, s0, stride, n_win, got):
    """The fp32 kernel's output within FP32_REL of max|y| of a float64
    product and within FP32_PLAIN_REL of the plain version (SGEMM, TF32
    off); the plain version within FP32_PLAIN_REL of float64; the first
    window read one frame late outside both limits."""
    want = fc1_strided_plain(buf, w, s0, stride, n_win)
    exact = (_windows(buf, s0, stride, n_win).double() @ w.double()).float()
    scale = float(exact.abs().max())
    assert got.dtype == torch.float32 and got.shape == want.shape
    err_f64 = float((got - exact).abs().max())
    errs_plain = [float((got - want).abs().max()), float((want - exact).abs().max())]
    assert err_f64 <= FP32_REL * scale, (err_f64, scale)
    assert max(errs_plain) <= FP32_PLAIN_REL * scale, (errs_plain, scale)
    late = want.clone()
    late[:, 0] = fc1_strided_plain(buf, w, s0 + 1, stride, 1)[:, 0]
    assert float((got - late).abs().max()) > FP32_PLAIN_REL * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,s0,stride,n_win", CARD_SHAPES)
def test_tf32x3_kernel_matches_plain_and_float64(cuda, n, f, s0, stride, n_win):
    """At the flows' shapes (Beluga's widths): two calls on the fp32 kernel,
    bit-equal, within the fp32 limit of the plain version and of float64."""
    buf, w = _card_inputs_fp32(n, f, 640, 2003, n + f + s0, cuda)
    before = Counter(fc1_strided.launches_by_route)
    got = fc1_strided(buf, w, s0, stride, n_win)
    again = fc1_strided(buf, w, s0, stride, n_win)
    torch.cuda.synchronize()
    assert fc1_strided.launches_by_route - before == Counter({_route("cuda", torch.float32, n * n_win): 2})
    assert torch.equal(got, again)
    _tf32x3_matches_plain_and_float64(buf, w, s0, stride, n_win, got)


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,c,s0,stride,n_win,n_out", CARD_EDGE_SHAPES)
def test_tf32x3_kernel_at_tile_edges_repeats_on_a_second_stream(cuda, n, f, c, s0, stride, n_win, n_out):
    buf, w = _card_inputs_fp32(n, f, c, n_out, n + c + n_out, cuda)
    got = fc1_strided(buf, w, s0, stride, n_win)
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = fc1_strided(buf, w, s0, stride, n_win)
    torch.cuda.synchronize()
    assert got.shape == (n, n_win, n_out) and torch.equal(got, again)
    _tf32x3_matches_plain_and_float64(buf, w, s0, stride, n_win, got)


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_out", [(4, 1), (12, 19), (48, 64), (32, 257)])
def test_tf32x3_kernel_takes_narrow_widths(cuda, c, n_out):
    """Test widths in fp32: 106*C off the 32-deep stage (the last one
    zero-padded), C down to one 16-byte piece, Nout off the 128-column tile,
    down to one column."""
    buf, w = _card_inputs_fp32(7, 300, c, n_out, c, cuda)
    got = fc1_strided(buf, w, 12, 25, 5)
    assert got.shape == (7, 5, n_out) and torch.equal(got, fc1_strided(buf, w, 12, 25, 5))
    _tf32x3_matches_plain_and_float64(buf, w, 12, 25, 5, got)


@pytest.mark.gpu
def test_tf32x3_kernel_reads_a_splice_view_in_place(cuda):
    base, w = _card_inputs_fp32(5, 207, 640, 2003, 9, cuda)
    buf = base[:, :206]
    _tf32x3_matches_plain_and_float64(buf.contiguous(), w, 12, 25, 4, fc1_strided(buf, w, 12, 25, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 16])
def test_fp32_on_the_card_is_the_tf32x3_kernel(cuda, n):
    """A CUDA fp32 buffer launches one three-pass TF32 kernel, the one its
    M routes to (M = 20: the split pass and the swapped kernel; 80: the
    tf32x3 kernel): one launch counted on that route and under an fp32
    shape, none on the bf16 kernel."""
    buf, w = _card_inputs_fp32(n, 206, 640, 2003, 3, cuda)
    fc1.reset_launch_counts()
    got = fc1_strided(buf, w, 0, 25, 5)
    route = "tf32x3_swap" if 5 * n <= fc1.SWAP_MAX_M else "tf32x3"
    assert fc1_strided.launches == 1 and fc1_strided.launches_by_route == Counter({route: 1})
    assert fc1_strided.launches_by_shape == Counter({("float32", n, 206, 640, 0, 25, 5, 2003): 1})
    assert split_planes.launches == (route == "tf32x3_swap")
    _tf32x3_matches_plain_and_float64(buf, w, 0, 25, 5, got)


# (N, F, C, s0, stride, n_win, Nout) around the fp32 routes' boundary and
# the swapped kernel's tiles at Beluga's widths: M = 1, 4 and 5 (single
# samples), 60, 63, SWAP_MAX_M = 64 and 65 (two window tiles of 33 in the
# swapped kernel), 128 and 129 (two and three); narrow widths: a part
# stage (C = 12), one column, 257 columns
FP32_EDGE_SHAPES = [(1, 206, 640, 0, 25, 1, 2003), (1, 206, 640, 12, 25, 4, 2003), (1, 206, 640, 0, 25, 5, 2003),
                    (12, 206, 640, 0, 25, 5, 2003), (21, 206, 640, 0, 25, 3, 2003), (16, 206, 640, 0, 25, 4, 2003),
                    (13, 206, 640, 0, 25, 5, 2003), (32, 206, 640, 0, 25, 4, 2003), (43, 206, 640, 0, 25, 3, 2003),
                    (7, 300, 12, 12, 25, 5, 19), (9, 206, 640, 0, 25, 5, 1), (9, 206, 640, 12, 25, 4, 257)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,c,s0,stride,n_win,n_out", FP32_EDGE_SHAPES)
def test_fp32_regimes_at_their_boundary_repeat_on_a_second_stream(cuda, n, f, c, s0, stride, n_win, n_out):
    """Both fp32 kernels at each shape (the route's own through fc1_strided,
    the other through its launcher): on a second stream bit-equal to the
    first call, within the fp32 limits of the plain version and float64."""
    buf, w = _card_inputs_fp32(n, f, c, n_out, n + c + n_out + 1, cuda)
    route = _route("cuda", torch.float32, n * n_win)
    before = Counter(fc1_strided.launches_by_route)
    got = fc1_strided(buf, w, s0, stride, n_win)
    assert fc1_strided.launches_by_route - before == Counter({route: 1})
    for which in ("tf32x3_swap", "tf32x3"):
        y = got if which == route else fc1._launch(which, buf, w, s0, stride, n_win)
        side = torch.cuda.Stream(device=cuda)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            again = fc1._launch(which, buf, w, s0, stride, n_win)
        torch.cuda.synchronize()
        assert y.shape == (n, n_win, n_out) and torch.equal(y, again), which
        _tf32x3_matches_plain_and_float64(buf, w, s0, stride, n_win, y)


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_out", [(4, 1), (12, 19), (48, 64), (32, 257)])
def test_swap_kernel_takes_narrow_widths(cuda, c, n_out):
    """The swapped kernel at test widths (M = 10): 106*C off the 32-deep
    stage, C down to one 16-byte piece, Nout off the 128-column tile."""
    buf, w = _card_inputs_fp32(2, 300, c, n_out, c + 1, cuda)
    before = Counter(fc1_strided.launches_by_route)
    got = fc1_strided(buf, w, 12, 25, 5)
    assert fc1_strided.launches_by_route - before == Counter({"tf32x3_swap": 1})
    assert got.shape == (2, 5, n_out) and torch.equal(got, fc1_strided(buf, w, 12, 25, 5))
    _tf32x3_matches_plain_and_float64(buf, w, 12, 25, 5, got)


@pytest.mark.gpu
def test_swap_kernel_reads_a_splice_view_in_place(cuda):
    base, w = _card_inputs_fp32(3, 207, 640, 2003, 10, cuda)
    buf = base[:, :206]
    got = fc1_strided(buf, w, 12, 25, 4)
    _tf32x3_matches_plain_and_float64(buf.contiguous(), w, 12, 25, 4, got)


@pytest.mark.gpu
@pytest.mark.parametrize("s0,span,view", [(0, 206, False), (12, 181, False), (3, 106, True), (0, 2581, False)])
def test_split_pass_equals_split_tf32_bit_for_bit(cuda, s0, span, view):
    """The split pass on the card against split_tf32 on the same numbers
    (magnitudes over 16 binades, zeros, ties), a splice view read in place."""
    g = torch.Generator(device=cuda).manual_seed(s0 + span)
    f = max(206, s0 + span)
    base = torch.randn((5, f + 1, 640), generator=g, device=cuda) * torch.exp2(
        torch.randint(-8, 8, (5, f + 1, 640), generator=g, device=cuda).float())
    base[0, s0, :4] = torch.tensor([0.0, -0.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11)], device=cuda)
    buf = base[:, :f] if view else base[:, :f].contiguous()
    before = split_planes.launches
    planes = split_planes(buf, s0, span)
    torch.cuda.synchronize()
    assert split_planes.launches == before + 1 and planes.shape == (2, 5, span, 640)
    want = split_planes_plain(buf, s0, span)
    assert torch.equal(planes.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_split_pass_refuses_on_the_card(cuda):
    buf = torch.zeros((2, 206, 640), device=cuda)
    flat = torch.zeros(2 * 206 * 640 + 4, device=cuda)
    with pytest.raises(ValueError, match="split pass"):
        split_planes(flat[1 : 1 + 2 * 206 * 640].view(2, 206, 640), 0, 206)
    with pytest.raises(ValueError, match="split pass"):
        split_planes(torch.zeros((2, 206, 6), device=cuda), 0, 206)
    with pytest.raises(ValueError, match="split pass"):
        split_planes(buf.bfloat16(), 0, 206)
    with pytest.raises(ValueError, match="split pass"):
        split_planes(buf, 101, 106)


@pytest.mark.gpu
def test_kernel_refuses_on_the_card(cuda):
    buf, w = _card_inputs(2, 206, 4, cuda)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flat = torch.zeros(2 * 206 * 640 + 8, dtype=torch.bfloat16, device=cuda)
        fc1_strided(flat[1 : 1 + 2 * 206 * 640].view(2, 206, 640), w, 0, 25, 4)
    with pytest.raises(ValueError, match="do not fit"):
        fc1_strided(buf, w, 0, 25, 5 + 1)


@pytest.mark.gpu
def test_tf32x3_kernel_refuses_on_the_card(cuda):
    """fp32 off the kernel's rules raises; so do mixed dtypes and a dtype no
    kernel takes: nothing falls back to a matmul."""
    buf, w = _card_inputs_fp32(2, 206, 640, 2003, 4, cuda)
    flat = torch.zeros(2 * 206 * 640 + 4, device=cuda)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fc1_strided(flat[1 : 1 + 2 * 206 * 640].view(2, 206, 640), w, 0, 25, 4)
    with pytest.raises(ValueError, match="do not fit"):
        fc1_strided(buf, w, 0, 25, 5 + 1)
    with pytest.raises(TypeError, match="of one dtype"):
        fc1_strided(buf, w.bfloat16(), 0, 25, 4)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fc1_strided(buf.half(), w.half(), 0, 25, 4)
