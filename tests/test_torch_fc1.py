"""fc1's strided product of the port (ops/fc1.py) against the JAX package's
``fc1_pre_from_phases`` (its ``lax.conv_general_dilated`` at precision
HIGHEST), fp32 on the CPU, where the port's wrapper takes the plain
PyTorch version; the packer's layout, the route rule, the split plan and
the wrapper's checks. The CUDA kernel (csrc/fc1_strided_tc.cu) runs only on
the card: the ``gpu`` cases below hold it against the plain version there
and skip without a card. They import no JAX, so on a machine without it:

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
    _packed,
    _route,
    _windows,
    fc1_schedule,
    fc1_strided,
    fc1_strided_plain,
    frame_order,
    pack_weights_fc1,
    schedule_units,
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


def test_route_is_a_pure_function_of_device_and_dtype():
    table = {("cpu", torch.float32): "cpu", ("cpu", torch.bfloat16): "cpu", ("cuda", torch.bfloat16): "tc",
             ("cuda", torch.float32): "cublas"}
    for _ in range(2):
        assert {key: _route(*key) for key in table} == table
    assert set(fc1.ROUTES) == {"tc", "cublas"}


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


def _emulate(buf, w, s0, stride, n_win, sms, knobs):
    """The kernel's arithmetic on the CPU, as its CTAs walk the schedule:
    A rows from the buffer at the walk's K offsets, B stages unswizzled
    from the packed weight, fp32 tiles stored whole or as parts, and the
    second pass summing each tile's parts in group order."""
    n, _f, c = buf.shape
    n_out, m, k = w.shape[1], n * n_win, FC1_FRAMES * c
    period = walk_period(c, stride)
    sched = fc1_schedule(m, n_out, k, sms, **knobs)
    cols, groups, tm = sched.cols, sched.groups, sched.tile_rows
    kt, tiles_n = -(-k // 64), -(-n_out // 256)
    a = torch.nn.functional.pad(_windows(buf.float(), s0, stride, n_win).reshape(m, k), (0, kt * 64 - k))
    lo = torch.arange(8)
    wp = pack_weights_fc1(w, period).float()
    b = wp.reshape(tiles_n, kt, 32, 8, 8, 8)[:, :, :, lo[:, None], lo[None, :] ^ lo[:, None]].reshape(
        tiles_n, kt, 256, 64)
    nb, order = (c // 64, frame_order(FC1_FRAMES, period)) if c % 64 == 0 else (0, None)
    y = torch.zeros((m, tiles_n * 256))
    ws = {}
    for _cta, i, t, k0, k1, slot in schedule_units(m, n_out, k, sched):
        r = slice(min(m, i * tm), min(m, (i + 1) * tm))
        acc = torch.zeros((r.stop - r.start, 256))
        for j in range(k0, k1):
            koff = order[j // nb] * c + (j % nb) * 64 if nb else j * 64
            acc += a[r, koff : koff + 64] @ b[t, j].T
        if slot is None:
            y[r, t * 256 : (t + 1) * 256] = acc
        else:
            ws.setdefault((slot, t), torch.zeros((m, 256)))[r] = acc
    positions = tiles_n // cols * kt
    for t in range(tiles_n):
        cb = t // cols
        qf, ql = _group_of(cb * kt, positions, groups), _group_of(cb * kt + kt - 1, positions, groups)
        if qf != ql:
            parts = [ws[(2 * q + int(q * positions // groups // kt != cb), t)] for q in range(qf, ql + 1)]
            y[:, t * 256 : (t + 1) * 256] = sum(parts[1:], parts[0])
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


def _good(f=240, c=32, n_out=19, n=2):
    buf = torch.zeros((n, f, c), dtype=torch.bfloat16)
    return buf, torch.zeros((FC1_FRAMES * c, n_out), dtype=torch.bfloat16)


@pytest.mark.parametrize("case,exc,match", [
    ("fp32", TypeError, "bfloat16"),
    ("w_fp32", TypeError, "bfloat16"),
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


@pytest.mark.gpu
def test_fp32_on_the_card_is_the_cublas_product(cuda):
    buf, w = _card_inputs(4, 206, 3, cuda)
    buf, w = buf.float(), w.float()
    before = fc1_strided.launches
    got = fc1_strided(buf, w, 0, 25, 5)
    assert fc1_strided.launches == before
    assert torch.equal(got, fc1._windows(buf, 0, 25, 5) @ w)


@pytest.mark.gpu
def test_kernel_refuses_on_the_card(cuda):
    buf, w = _card_inputs(2, 206, 4, cuda)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flat = torch.zeros(2 * 206 * 640 + 8, dtype=torch.bfloat16, device=cuda)
        fc1_strided(flat[1 : 1 + 2 * 206 * 640].view(2, 206, 640), w, 0, 25, 4)
    with pytest.raises(ValueError, match="do not fit"):
        fc1_strided(buf, w, 0, 25, 5 + 1)
