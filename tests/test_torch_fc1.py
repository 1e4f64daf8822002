"""fc1's strided product of the port (ops/fc1.py) against the JAX package's
``fc1_pre_from_phases`` (its ``lax.conv_general_dilated`` at precision
HIGHEST), fp32 on the CPU, where the port's wrapper takes the plain
PyTorch version; the packer's layout, the route rule, the split plan and
the wrapper's checks. The CUDA kernel (csrc/fc1_strided_tc.cu) runs only on
the card: the ``gpu`` cases below hold it against the plain version there
and skip without a card. They import no JAX, so on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fc1.py
"""

import numpy as np
import pytest
import torch

from expecto_tpu_torch.ops import fc1, spans
from expecto_tpu_torch.ops.fc1 import (
    FC1_FRAMES,
    _check,
    _packed,
    _route,
    fc1_splits,
    fc1_strided,
    fc1_strided_plain,
    pack_weights_fc1,
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


def _unpack(wp):
    """The inverse of pack_weights_fc1's permutation: (K, padded Nout)."""
    tiles, chunks = wp.shape[:2]
    return wp.permute(1, 2, 4, 0, 3).reshape(chunks * 64, tiles * 256)


# K = 106*C: a multiple of 64 at C = 32, 64 and Beluga's 640; at C = 8, 16
# and 48 the last stage is part padding
@pytest.mark.parametrize("c,n_out,dtype", [(32, 19, torch.float32), (64, 256, torch.float32),
                                           (32, 257, torch.float32), (64, 2003, torch.bfloat16),
                                           (16, 19, torch.float32), (48, 64, torch.bfloat16), (8, 1, torch.float32)])
def test_packer_round_trips_and_pads_with_zeros(c, n_out, dtype):
    k = FC1_FRAMES * c
    w = torch.from_numpy(np.random.default_rng(c + n_out).standard_normal((k, n_out)).astype(np.float32)).to(dtype)
    wp = pack_weights_fc1(w)
    tiles = -(-n_out // 256)
    assert wp.shape == (tiles, -(-k // 64), 8, 256, 8) and wp.is_contiguous() and wp.dtype == w.dtype
    full = _unpack(wp)
    assert torch.equal(full[:k, :n_out], w)
    assert not full[:, n_out:].any() and not full[k:].any()
    # one stage: K group g of column tile t and chunk j is column j*64 + 8g .. + 7 of K, K-major
    t, j, g = tiles - 1, k // 64 - 1, 5  # a chunk whole inside K
    cols = slice(t * 256, min((t + 1) * 256, n_out))
    stage = wp[t, j, g, : cols.stop - cols.start]  # (columns, 8)
    assert torch.equal(stage, w[j * 64 + 8 * g : j * 64 + 8 * g + 8, cols].T)


def test_packed_is_cached_per_weight_tensor_and_version():
    w = torch.ones((FC1_FRAMES * 32, 19))
    first = _packed(w)
    assert _packed(w) is first
    w.mul_(2.0)  # an in-place write bumps the version: repacked
    again = _packed(w)
    assert again is not first and torch.equal(_unpack(again)[:, :19], w)


def test_route_is_a_pure_function_of_device_and_dtype():
    table = {("cpu", torch.float32): "cpu", ("cpu", torch.bfloat16): "cpu", ("cuda", torch.bfloat16): "tc",
             ("cuda", torch.float32): "cublas"}
    for _ in range(2):
        assert {key: _route(*key) for key in table} == table
    assert set(fc1.ROUTES) == {"tc", "cublas"}


def test_split_plan():
    k, sms = FC1_FRAMES * 640, 132
    for m in (1, 227, 560, 908, 1120, 1135, 1600, 4096, 20000):
        s = fc1_splits(m, 2003, k, sms)
        assert 4 <= s <= 16 and s == fc1_splits(m, 2003, k, sms)
    # the slice count that fills the last wave: 9 x 8 tiles at 7 slices are
    # 504 blocks, 3.8 waves of 132 SMs; 4 x 8 at 4 are one wave
    assert fc1_splits(1135, 2003, k, sms) == 7 and fc1_splits(500, 2003, k, sms) == 4
    # 33 row tiles x 8 column tiles are two whole waves at any count: the
    # fewest slices (the split-sum pass costs bytes)
    assert fc1_splits(33 * 128, 2003, k, sms) == 4
    # never more slices than K has stages (a part stage counts)
    assert fc1_splits(1, 2003, 2 * 64, sms) == 2 and fc1_splits(1, 2003, 64, sms) == 1
    assert fc1_splits(1, 2003, 64 + 16, sms) == 2


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
