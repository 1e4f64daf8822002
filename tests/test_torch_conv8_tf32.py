"""The fp32 conv8_relu route on the TF32 tensor cores in three passes
("tf32x3", csrc/conv8_relu_tf32x3.cu), on the CPU: its packed weights (the
TF32 hi and lo planes in the kernel's layout), its K split rule, and a
plain-PyTorch emulation of the kernel's stage-by-stage three-pass sum held
against the JAX package's Pallas kernel in interpret mode and its XLA
reference at narrow widths, and against float64 at Beluga's depth, where one
TF32 pass misses the limit. The kernel itself runs only on the card
(tests/test_torch_card.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expecto_tpu.ops.pallas_conv import conv8_relu as jax_conv8_relu
from expecto_tpu.ops.pallas_conv import conv8_relu_reference
from expecto_tpu_torch.ops.conv8 import (
    _packed,
    conv8_relu,
    conv8_relu_plain,
    conv8_relu_pool4,
    pack_weights_simt,
    pack_weights_tf32x3,
    tf32x3_splits,
)
from expecto_tpu_torch.ops.fc1 import split_tf32
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

# fp32 sums of at most 8*64 terms of unit-scale inputs in another order
TOL = 1e-5
# the kernel's limit against a float64 product: 1e-5 of max|y|
F64_REL = 1e-5
H100_SMS = 132


def _inputs(n, l, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l, cin)).astype(np.float32)
    w = (rng.standard_normal((8, cin, cout)) / np.sqrt(8 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _tf32x3_stage_sums(x, w, b, splits=1, passes=3):
    """The tf32x3 kernel's sum in plain PyTorch: over the flat rows (7 zero
    rows past them, as TMA fills), x split into TF32 hi and lo; for each
    4-channel stage of the packed weights, a fresh fp32 chain over the four
    tap pairs of lo*hi + hi*lo + hi*hi (``passes`` 1: hi*hi alone, the
    planted fault), added into the part's fp32 sum; the parts of K
    (``splits``) added in part order; then bias, ReLU and the rows that
    straddle two spans dropped."""
    n, l, cin = x.shape
    packed = pack_weights_tf32x3(w)
    tiles, chunks = packed.shape[:2]
    m = n * l
    flat = torch.zeros((m + 7, cin))
    flat[:m] = x.reshape(m, cin)
    a_hi, a_lo = split_tf32(flat)
    y = None
    for s in range(splits):
        part = torch.zeros((m, 160 * tiles))
        for q in range(s * chunks // splits, (s + 1) * chunks // splits):
            chain = torch.zeros_like(part)
            for t in range(tiles):
                cols = slice(160 * t, 160 * t + 160)
                for k in range(8):
                    ah, al = a_hi[k : k + m, 4 * q : 4 * q + 4], a_lo[k : k + m, 4 * q : 4 * q + 4]
                    bh, bl = packed[t, q, 0, k].T, packed[t, q, 1, k].T  # (4, 160)
                    if passes == 3:
                        chain[:, cols] += al @ bh + ah @ bl
                    chain[:, cols] += ah @ bh
            part = part + chain
        y = part if y is None else y + part
    y = torch.relu(y[:, : w.shape[2]] + b)
    return y.reshape(n, l, -1)[:, : l - 7]


@pytest.mark.parametrize("cin,cout", [(4, 32), (16, 160), (40, 200), (8, 1)])
def test_packed_weights_hold_each_stage_where_the_tf32x3_kernel_reads_it(cin, cout):
    """Stage (tile t, chunk q), plane p (hi, lo), tap k is the 160 x 4 block
    split(W)[p][k, 4q : 4q + 4, 160t : +160].T, zero past Cout."""
    w = torch.from_numpy(_inputs(1, 8, cin, cout, seed=cin + cout)[1])
    packed = pack_weights_tf32x3(w)
    tiles = -(-cout // 160)
    assert packed.shape == (tiles, cin // 4, 2, 8, 160, 4) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    wide = torch.zeros((8, cin, tiles * 160))
    wide[..., :cout] = w
    planes = split_tf32(wide)
    for t in range(tiles):
        for q in range(cin // 4):
            for p in range(2):
                for k in range(8):
                    block = planes[p][k, 4 * q : 4 * q + 4, 160 * t : 160 * t + 160].T
                    assert torch.equal(packed[t, q, p, k], block)
    assert not packed[-1, :, :, :, cout - 160 * (tiles - 1) :].any()  # the zero padding past Cout


def test_packed_planes_are_tf32_exact_and_hold_w():
    """hi and lo have their 13 low mantissa bits zero, and hi + lo is W
    within 2^-22 |W| (the round trip)."""
    w = torch.from_numpy(_inputs(1, 8, 32, 320, seed=11)[1]) * torch.logspace(-3, 3, 320)
    packed = pack_weights_tf32x3(w)
    assert not (packed.view(torch.int32) & 0x1FFF).any()
    hi, lo = packed[:, :, 0], packed[:, :, 1]  # (tiles, chunks, 8, 160, 4)
    back = (hi.double() + lo.double()).permute(2, 1, 4, 0, 3).reshape(8, 32, 320)  # tap, Cin, Cout
    assert (back - w.double()).abs().le(2.0**-22 * w.double().abs()).all()
    # hi alone is W rounded to TF32: up to 2^-11 |W| off, which a single pass keeps
    assert float(((hi.double().permute(2, 1, 4, 0, 3).reshape(8, 32, 320) - w.double()).abs()
                  / w.double().abs()).max()) > 2.0**-14


@pytest.mark.parametrize("bad", ["cin", "dtype", "width"])
def test_pack_tf32x3_rejects_what_the_kernel_does_not_take(bad):
    w = torch.zeros((8, 16, 32))
    w = {"cin": torch.zeros((8, 18, 32)), "dtype": w.bfloat16(), "width": w[:7]}[bad]
    with pytest.raises(ValueError, match="tf32x3"):
        pack_weights_tf32x3(w)


def test_packed_tf32x3_weights_are_cached_per_route_until_written():
    w = torch.from_numpy(_inputs(1, 8, 16, 32, seed=3)[1])
    tf, simt = _packed(w, "tf32x3"), _packed(w, "simt")
    assert _packed(w, "tf32x3") is tf and _packed(w, "simt") is simt
    assert torch.equal(tf, pack_weights_tf32x3(w)) and torch.equal(simt, pack_weights_simt(w))
    w.mul_(-1)
    assert torch.equal(_packed(w, "tf32x3"), pack_weights_tf32x3(w)) and not torch.equal(_packed(w, "tf32x3"), tf)


# narrow widths: short rows, several spans, a Cout past one 160-wide tile
# and one that is not a multiple of 8, the shortest valid input
EMU_SHAPES = [(2, 64, 4, 32, 1), (2, 57, 16, 160, 1), (3, 13, 8, 200, 2), (1, 40, 32, 24, 4), (2, 8, 20, 7, 1),
              (4, 26, 24, 48, 3)]


@pytest.mark.parametrize("n,l,cin,cout,splits", EMU_SHAPES)
def test_tf32x3_stage_sums_match_pallas_interpret(n, l, cin, cout, splits):
    x, w, b = _inputs(n, l, cin, cout, seed=11 * l + cin + n)
    want = np.asarray(jax_conv8_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = _tf32x3_stage_sums(*(torch.from_numpy(a) for a in (x, w, b)), splits=splits).numpy()
    assert got.shape == (n, l - 7, cout)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,l,cin,cout,splits", EMU_SHAPES)
def test_tf32x3_stage_sums_match_xla_reference(n, l, cin, cout, splits):
    x, w, b = _inputs(n, l, cin, cout, seed=13 * l + cin + n)
    want = np.asarray(conv8_relu_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = _tf32x3_stage_sums(*(torch.from_numpy(a) for a in (x, w, b)), splits=splits).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cin,splits", [(640, 1), (640, 3), (480, 2)])
def test_tf32x3_stage_sums_hold_float64_at_beluga_depth_where_one_pass_misses(cin, splits):
    """K = 8 Cin = 3,840-5,120 (conv4, conv5): three passes within 1e-5 of
    max|y| of a float64 product; one TF32 pass (hi*hi, the planted fault)
    about 2^-11 relative off, past the limit."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 30, cin, 24, seed=cin + splits))
    want = conv8_relu_plain(x.double(), w.double(), b.double())
    scale = float(want.abs().max())
    got = _tf32x3_stage_sums(x, w, b, splits=splits)
    assert float((got.double() - want).abs().max()) <= F64_REL * scale
    one_pass = _tf32x3_stage_sums(x, w, b, splits=splits, passes=1)
    assert float((one_pass.double() - want).abs().max()) > 5 * F64_REL * scale


# (M, Cin, Cout) of the flows' shapes: the serving span's conv1 (227 spans),
# its patch conv5, the gene chunk's conv1 (16 x 41,800), the consensus
# patch's conv3-conv5 at N.K = 40 and 384
SPLIT_SHAPES = {"serve conv1": (227 * 3593, 320, 320), "serve patch conv5": (227 * 26, 640, 640),
                "gene conv1": (16 * 41793, 320, 320), "patch40 conv3": (40 * 172, 480, 480),
                "patch40 conv4": (40 * 39, 480, 640), "patch40 conv5": (40 * 32, 640, 640),
                "patch384 conv5": (384 * 32, 640, 640)}


@pytest.mark.parametrize("what", list(SPLIT_SHAPES))
def test_tf32x3_splits_fill_the_waves_and_keep_many_wave_shapes_whole(what):
    m, cin, cout = SPLIT_SHAPES[what]
    s = tf32x3_splits(m, cin, cout, H100_SMS)
    tiles = -(-m // 128) * -(-cout // 160)
    assert 1 <= s <= 4 and cin // 4 // s >= 16
    assert s == tf32x3_splits(m, cin, cout, H100_SMS)  # a function of the shape alone
    if tiles >= 2 * H100_SMS:
        assert s == 1
    ctas = tiles * s
    fill = ctas / (H100_SMS * -(-ctas // H100_SMS))
    assert fill >= 0.75 or tiles >= 2 * H100_SMS


def test_tf32x3_splits_at_the_short_patch_rows():
    """N.K = 40: conv4 (13 x 4 tiles) in 2 parts, conv5 (10 x 4) in 3; the
    serving patch's conv5 (48 x 4) in 2; conv1 (218 x 2 tiles, past two
    waves) whole."""
    assert tf32x3_splits(40 * 39, 480, 640, H100_SMS) == 2
    assert tf32x3_splits(40 * 32, 640, 640, H100_SMS) == 3
    assert tf32x3_splits(227 * 27, 640, 640, H100_SMS) == 2
    assert tf32x3_splits(40 * 697, 320, 320, H100_SMS) == 1
    assert tf32x3_splits(40 * 32, 8, 640, H100_SMS) == 1  # too few stages to cut


@pytest.mark.parametrize("pooled", [False, True])
def test_cpu_tensors_refuse_the_tf32x3_route(pooled):
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 8, seed=2))
    with pytest.raises(ValueError, match="needs CUDA"):
        if pooled:
            conv8_relu_pool4(x, w, b, (0,), route="tf32x3")
        else:
            conv8_relu(x, w, b, route="tf32x3")
