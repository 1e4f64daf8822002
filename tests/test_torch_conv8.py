"""conv8_relu of the port vs the JAX package's Pallas kernel (interpret mode)
and its XLA reference, fp32 on the CPU, where the port's wrapper takes the
plain PyTorch version; the route rule, the kernels' flat-row indexing
(conv8_relu_flat_plain), their packed weight layouts and the SIMT kernel's
stage-by-stage sum over its packed weights. The CUDA kernels themselves run
only on the card (chip_smoke.py and tests/test_torch_card.py hold them
against the plain version there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expecto_tpu.ops.pallas_conv import conv8_relu as jax_conv8_relu
from expecto_tpu.ops.pallas_conv import conv8_relu_reference
from expecto_tpu_torch.ops.conv8 import (
    _packed,
    _route,
    conv8_relu,
    conv8_relu_flat_plain,
    conv8_relu_plain,
    pack_weights_simt,
    pack_weights_tc,
    reset_launch_counts,
)
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

# fp32 sums of at most 8*64 terms of unit-scale inputs in another order
TOL = 1e-5


def _inputs(n, l, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l, cin)).astype(np.float32)
    w = (rng.standard_normal((8, cin, cout)) / np.sqrt(8 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


# tests/test_pallas_conv.py's shapes, Beluga's conv0 (Cin = 4) and ragged
# lengths, the shortest valid input (L = 8) and a Cout that is not a multiple
# of 64 (480 is not either)
SHAPES = [(2, 64, 4, 32), (2, 128, 32, 64), (2, 57, 64, 160), (1, 600, 4, 320), (3, 13, 4, 48), (2, 8, 20, 40),
          (1, 37, 48, 96)]


@pytest.mark.parametrize("n,l,cin,cout", SHAPES)
def test_plain_matches_pallas_interpret(n, l, cin, cout):
    x, w, b = _inputs(n, l, cin, cout, seed=l + cin)
    want = np.asarray(jax_conv8_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = conv8_relu_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert got.shape == (n, l - 7, cout)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,l,cin,cout", SHAPES)
def test_plain_matches_xla_reference(n, l, cin, cout):
    x, w, b = _inputs(n, l, cin, cout, seed=2 * l + cin)
    want = np.asarray(conv8_relu_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv8_relu_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_takes_plain_path_and_counts_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 40, 16, 32, seed=7))
    before = conv8_relu.launches
    got = conv8_relu(x, w, b)
    assert conv8_relu.launches == before
    torch.testing.assert_close(got, conv8_relu_plain(x, w, b), rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    x, w, b = (torch.from_numpy(a).to("meta") for a in _inputs(1, 16, 4, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv8_relu(x, w, b)


@pytest.mark.parametrize("bad", ["width", "short"])
def test_plain_rejects_invalid_shapes(bad):
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 8, seed=1))
    if bad == "width":
        w = w[:7]
    else:
        x = x[:, :7]
    with pytest.raises(ValueError):
        conv8_relu_plain(x, w, b)


def _misaligned_bf16(n, l, cin):
    """A contiguous bf16 view whose data pointer is 2 bytes past a 16-byte
    boundary (a slice one element into a buffer)."""
    buf = torch.zeros(n * l * cin + 8, dtype=torch.bfloat16)
    view = buf[1 : 1 + n * l * cin].view(n, l, cin)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    return view


@pytest.mark.parametrize("dtype,cin,aligned,device,want", [
    (torch.bfloat16, 320, True, "cuda", "tc"),
    (torch.bfloat16, 480, True, "cuda", "tc"),
    (torch.bfloat16, 640, True, "cuda", "tc"),
    (torch.bfloat16, 16, True, "cuda", "tc"),
    (torch.bfloat16, 4, True, "cuda", "simt"),  # conv0
    (torch.bfloat16, 20, True, "cuda", "simt"),  # Cin not a multiple of 16
    (torch.bfloat16, 320, False, "cuda", "simt"),  # TMA needs a 16-byte-aligned base
    (torch.float32, 4, True, "cuda", "simt"),
    (torch.float32, 16, True, "cuda", "simt"),
    (torch.float32, 320, True, "cuda", "simt"),
    (torch.float32, 640, True, "cuda", "simt"),
    (torch.bfloat16, 320, True, "cpu", "cpu"),
    (torch.float32, 4, True, "cpu", "cpu"),
])
def test_route_is_a_function_of_dtype_cin_and_alignment(dtype, cin, aligned, device, want):
    x = torch.zeros((2, 8, cin), dtype=dtype) if aligned else _misaligned_bf16(2, 8, cin)
    assert x.data_ptr() % 16 == (0 if aligned else 2)
    assert _route(device, x.dtype, x.shape[2], x.data_ptr()) == want


# short rows (the patch sub-span's conv4/conv5 inputs are 26-34 long), one to
# five spans, and a Cout that is not a multiple of the tc kernel's 160
FLAT_SHAPES = [(1, 8, 16, 32), (5, 9, 16, 24), (3, 15, 32, 40), (4, 26, 16, 161), (5, 34, 32, 48), (2, 8, 4, 7)]


@pytest.mark.parametrize("n,l,cin,cout", FLAT_SHAPES)
def test_flat_plain_matches_pallas_interpret(n, l, cin, cout):
    x, w, b = _inputs(n, l, cin, cout, seed=3 * l + cin + n)
    want = np.asarray(jax_conv8_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = conv8_relu_flat_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert got.shape == (n, l - 7, cout)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,l,cin,cout", FLAT_SHAPES)
def test_flat_plain_matches_xla_reference(n, l, cin, cout):
    x, w, b = _inputs(n, l, cin, cout, seed=5 * l + cin + n)
    want = np.asarray(conv8_relu_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv8_relu_flat_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cin,cout", [(16, 160), (32, 200), (48, 1)])
def test_packed_weights_hold_each_stage_where_the_tc_kernel_reads_it(cin, cout):
    """Stage (tile t, chunk c), tap k, 8-channel column g is the 160 x 8 block
    W[k, 16c + 8g : +8, 160t : +160].T, zero past Cout."""
    w = torch.from_numpy(_inputs(1, 8, cin, cout, seed=cin)[1])
    packed = pack_weights_tc(w)
    tiles = -(-cout // 160)
    assert packed.shape == (tiles, cin // 16, 8, 2, 160, 8) and packed.is_contiguous()
    wide = torch.zeros((8, cin, tiles * 160))
    wide[..., :cout] = w
    for t in range(tiles):
        for c in range(cin // 16):
            for k in range(8):
                for g in range(2):
                    block = wide[k, 16 * c + 8 * g : 16 * c + 8 * g + 8, 160 * t : 160 * t + 160].T
                    assert torch.equal(packed[t, c, k, g], block)


@pytest.mark.parametrize("cin,cout,dtype", [(4, 32, torch.float32), (17, 161, torch.float32), (20, 7, torch.bfloat16),
                                             (48, 1, torch.float32)])
def test_packed_weights_hold_each_stage_where_the_simt_kernel_reads_it(cin, cout, dtype):
    """Stage (tile t, chunk q), tap k, channel c is the fp32 row
    W[k, 4q + c, 160t : +160], zero past Cin and past Cout."""
    w = torch.from_numpy(_inputs(1, 8, cin, cout, seed=cin + 1)[1]).to(dtype)
    packed = pack_weights_simt(w)
    tiles, chunks = -(-cout // 160), -(-cin // 4)
    assert packed.shape == (tiles, chunks, 8, 4, 160) and packed.dtype == torch.float32 and packed.is_contiguous()
    wide = torch.zeros((8, 4 * chunks, 160 * tiles))
    wide[:, :cin, :cout] = w.float()
    for t in range(tiles):
        for q in range(chunks):
            for k in range(8):
                for c in range(4):
                    assert torch.equal(packed[t, q, k, c], wide[k, 4 * q + c, 160 * t : 160 * t + 160])


def _simt_stage_sums(x, w, b):
    """The SIMT kernel's sum in plain PyTorch: over the flat rows, 4-channel
    stages of zero-padded x against the packed W, tap k a shift of k rows;
    then bias, ReLU and the rows that straddle two spans dropped."""
    n, l, cin = x.shape
    packed = pack_weights_simt(w)
    tiles, chunks = packed.shape[:2]
    flat = torch.zeros((n * l + 7, 4 * chunks))
    flat[: n * l, :cin] = x.reshape(n * l, cin)
    y = torch.zeros((n * l, 160 * tiles))
    for t in range(tiles):
        for q in range(chunks):
            for k in range(8):
                y[:, 160 * t : 160 * t + 160] += flat[k : k + n * l, 4 * q : 4 * q + 4] @ packed[t, q, k]
    y = torch.relu(y[:, : w.shape[2]] + b)
    return y.reshape(n, l, -1)[:, : l - 7]


@pytest.mark.parametrize("n,l,cin,cout", FLAT_SHAPES + [(3, 13, 17, 161), (2, 9, 20, 1)])
def test_simt_stage_sums_match_pallas_interpret(n, l, cin, cout):
    x, w, b = _inputs(n, l, cin, cout, seed=7 * l + cin + n)
    want = np.asarray(jax_conv8_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = _simt_stage_sums(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert got.shape == (n, l - 7, cout)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_packed_weights_are_cached_per_route_until_written():
    w = torch.from_numpy(_inputs(1, 8, 16, 32, seed=3)[1]).bfloat16()
    simt, tc = _packed(w, "simt"), _packed(w, "tc")
    assert _packed(w, "simt") is simt and _packed(w, "tc") is tc
    assert torch.equal(simt, pack_weights_simt(w)) and torch.equal(tc, pack_weights_tc(w))
    w.mul_(-1)
    assert torch.equal(_packed(w, "simt"), pack_weights_simt(w)) and not torch.equal(_packed(w, "simt"), simt)


def test_pack_rejects_cin_off_the_stage_width():
    with pytest.raises(ValueError):
        pack_weights_tc(torch.zeros((8, 20, 32)))


def test_wrapper_on_cpu_rejects_a_kernel_route():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 8, seed=2))
    with pytest.raises(ValueError, match="needs CUDA"):
        conv8_relu(x.bfloat16(), w.bfloat16(), b.bfloat16(), route="tc")


def test_reset_launch_counts_zeroes_every_count():
    conv8_relu.launches_by_route["tc"] += 3
    reset_launch_counts()
    assert conv8_relu.launches == 0 and conv8_relu.launches_by_route == {"simt": 0, "tc": 0}
    assert not conv8_relu.launches_by_kind
