"""conv0 over int8 base codes (ops/conv0.py) vs the JAX package, fp32 on the
CPU, where the port's wrapper takes the plain PyTorch version: the one-hot
of every int8 code, the code-space reverse complement, conv0 against the
Pallas kernel (interpret mode) and the XLA reference on the one-hot, and the
conv stack on codes against the same functions on the one-hot. The CUDA
kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_card.py hold it against the plain version there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expecto_tpu.genome.windows import variant_shifts
from expecto_tpu.models.beluga import beluga_forward as jax_beluga_forward
from expecto_tpu.ops import spans as jspans
from expecto_tpu.ops.pallas_conv import conv8_relu as jax_conv8_relu
from expecto_tpu.ops.pallas_conv import conv8_relu_reference
from expecto_tpu.parallel import runner as jrunner
from expecto_tpu_torch.models.beluga import beluga_forward
from expecto_tpu_torch.models.convert import params_from_jax
from expecto_tpu_torch.ops import spans as tspans
from expecto_tpu_torch.ops.conv0 import (
    conv0_codes_relu,
    conv0_codes_relu_plain,
    onehot_from_codes,
    rc_codes,
    reset_launch_counts,
)
from expecto_tpu_torch.parallel import runner as trunner
from torch_port_common import single_torch_thread, narrow_params, random_codes  # noqa: F401 (autouse fixture)

# fp32: a sum of 8 table entries and the bias, in another order than the
# JAX kernel's; the span path is held to the per-window path at 1e-5
TOL = 1e-5

ALL_INT8 = np.arange(-128, 128, dtype=np.int8)


def _codes(n, l, seed):
    """Codes 0..4 with N runs and a few codes outside 0..4."""
    rng = np.random.default_rng(seed)
    codes = random_codes(rng, n, l, n_frac=0.03)
    codes[:, l // 3 : l // 3 + 5] = 4  # an N run
    odd = rng.random((n, l)) < 0.02
    codes[odd] = rng.choice(np.array([-128, -2, -1, 5, 17, 127], np.int8), odd.sum())
    return codes


def _weights(cout, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((8, 4, cout)) / np.sqrt(32)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_onehot_matches_jax_for_every_int8_code(dtype):
    codes = np.stack([ALL_INT8, ALL_INT8[::-1]])
    got = onehot_from_codes(torch.from_numpy(codes), dtype)
    want = np.asarray(jrunner.onehot_from_codes(jnp.asarray(codes)))
    assert got.dtype == dtype and got.shape == (2, 256, 4)
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(trunner.onehot_from_codes(torch.from_numpy(codes)).numpy(), want)
    # codes outside 0..3 (N = 4, -2, 5, ...) one-hot to zeros
    assert not got[0, (ALL_INT8 < 0) | (ALL_INT8 > 3)].any()


def test_rc_codes_is_the_one_hot_reverse_complement():
    codes = np.concatenate([np.stack([ALL_INT8, ALL_INT8[::-1]]), _codes(2, 256, seed=1)])
    rc = rc_codes(torch.from_numpy(codes))
    assert rc.dtype == torch.int8
    want = np.asarray(jrunner.rc_onehot(jrunner.onehot_from_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(onehot_from_codes(rc).numpy(), want)
    np.testing.assert_array_equal(trunner.rc_onehot(onehot_from_codes(torch.from_numpy(codes))).numpy(), want)
    # an involution that keeps every code outside 0..3
    np.testing.assert_array_equal(rc_codes(rc).numpy(), codes)
    keep = (codes < 0) | (codes > 3)
    np.testing.assert_array_equal(rc.numpy()[:, ::-1][keep], codes[keep])


# Beluga's conv0 (Cout 320) over a patch-like and a longer span, a ragged
# Cout that is not a multiple of 8 channels, and the shortest input (L = 8)
CONV0_SHAPES = [(2, 64, 320), (1, 600, 320), (3, 13, 48), (2, 8, 40)]


@pytest.mark.parametrize("n,l,cout", CONV0_SHAPES)
def test_plain_matches_pallas_interpret_on_the_one_hot(n, l, cout):
    codes = _codes(n, l, seed=l + cout)
    w, b = _weights(cout, seed=l)
    x = jrunner.onehot_from_codes(jnp.asarray(codes))
    want = np.asarray(jax_conv8_relu(x, jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = conv0_codes_relu_plain(torch.from_numpy(codes), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert got.shape == (n, l - 7, cout)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,l,cout", CONV0_SHAPES)
def test_plain_matches_xla_reference_on_the_one_hot(n, l, cout):
    codes = _codes(n, l, seed=2 * l + cout)
    w, b = _weights(cout, seed=2 * l)
    want = np.asarray(conv8_relu_reference(jrunner.onehot_from_codes(jnp.asarray(codes)), jnp.asarray(w),
                                           jnp.asarray(b)))
    got = conv0_codes_relu_plain(torch.from_numpy(codes), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_takes_plain_path_and_counts_no_launch():
    codes = torch.from_numpy(_codes(2, 40, seed=3))
    w, b = (torch.from_numpy(a) for a in _weights(32, seed=3))
    reset_launch_counts()
    got = conv0_codes_relu(codes[:, ::2], w, b)  # a strided view is taken as well
    assert conv0_codes_relu.launches == 0 and not conv0_codes_relu.launches_by_kind
    torch.testing.assert_close(got, conv0_codes_relu_plain(codes[:, ::2].contiguous(), w, b), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float codes", "int64 codes", "cin", "width", "dtypes", "short", "w strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    codes = torch.from_numpy(_codes(1, 16, seed=4))
    w, b = (torch.from_numpy(a) for a in _weights(8, seed=4))
    err = TypeError if bad in ("float codes", "int64 codes", "dtypes") else ValueError
    if bad == "float codes":
        codes = codes.float()
    elif bad == "int64 codes":
        codes = codes.long()
    elif bad == "cin":
        w = torch.zeros((8, 5, 8))
    elif bad == "width":
        w = w[:7]
    elif bad == "dtypes":
        b = b.bfloat16()
    elif bad == "short":
        codes = codes[:, :7]
    else:
        w = torch.zeros((8, 4, 16))[:, :, ::2]
    with pytest.raises(err):
        conv0_codes_relu(codes, w, b)


def test_wrapper_rejects_other_devices():
    codes = torch.zeros((1, 16), dtype=torch.int8, device="meta")
    w, b = torch.zeros((8, 4, 8), device="meta"), torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv0_codes_relu(codes, w, b)


# ---- the conv stack on codes ---------------------------------------------

@pytest.fixture(scope="module")
def params():
    return narrow_params(31)


@pytest.fixture(scope="module")
def tparams(params):
    return params_from_jax(params)


@pytest.fixture(scope="module")
def jparams(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _both(codes):
    """(int8 codes tensor, the port's float one-hot, the JAX one-hot)."""
    t = torch.from_numpy(codes)
    return t, onehot_from_codes(t), jrunner.onehot_from_codes(jnp.asarray(codes))


def test_conv1_acts_on_codes(tparams, jparams):
    t, x, jx = _both(_codes(2, 300, seed=5))
    got = tspans.conv1_acts(tparams, t)
    torch.testing.assert_close(got, tspans.conv1_acts(tparams, x), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jspans.conv1_acts(jparams, jx)), atol=TOL, rtol=TOL)


SPAN_LEN = 2 * 400 + 2000  # maxshift 400
OFFSETS = [s + 400 for s in variant_shifts(400)]


def test_conv6_phases_on_codes(tparams, jparams):
    t, x, jx = _both(_codes(2, SPAN_LEN, seed=6))
    got = tspans.conv6_phases(tparams, t, {0, 2})
    same = tspans.conv6_phases(tparams, x, {0, 2})
    want = jspans.conv6_phases(jparams, jx, {0, 2})
    for ph in (0, 2):
        torch.testing.assert_close(got[ph], same[ph], rtol=0, atol=0)
        np.testing.assert_allclose(got[ph].numpy(), np.asarray(want[ph]), atol=TOL, rtol=TOL)


def test_conv6_phases_patch_on_codes(tparams, jparams):
    """The alt patch slices its sub-span out of the codes as it does out of
    the one-hot."""
    mutpos = 400 + 999
    ref = _codes(2, SPAN_LEN, seed=7)
    alt = ref.copy()
    alt[:, mutpos] = (alt[:, mutpos] + 1) % 4
    t_ref, x_ref, j_ref = _both(ref)
    t_alt, x_alt, j_alt = _both(alt)
    ph_ref = tspans.conv6_phases(tparams, t_ref, {0, 2})
    got = tspans.conv6_phases_patch(tparams, ph_ref, t_alt, mutpos, 1, {0, 2})
    same = tspans.conv6_phases_patch(tparams, tspans.conv6_phases(tparams, x_ref, {0, 2}), x_alt, mutpos, 1, {0, 2})
    want = jspans.conv6_phases_patch(jparams, jspans.conv6_phases(jparams, j_ref, {0, 2}), j_alt, mutpos, 1, {0, 2})
    for ph in (0, 2):
        torch.testing.assert_close(got[ph], same[ph], rtol=0, atol=0)
        np.testing.assert_allclose(got[ph].numpy(), np.asarray(want[ph]), atol=TOL, rtol=TOL)


def test_beluga_forward_spans_on_codes(tparams, jparams):
    t, x, jx = _both(_codes(2, SPAN_LEN, seed=8))
    got = tspans.beluga_forward_spans(tparams, t, OFFSETS)
    torch.testing.assert_close(got, tspans.beluga_forward_spans(tparams, x, OFFSETS), rtol=0, atol=0)
    want = np.asarray(jspans.beluga_forward_spans(jparams, jx, OFFSETS))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # and in the reverse-complement orientation, from code space
    rc_off = [SPAN_LEN - 2000 - o for o in OFFSETS]
    got_rc = tspans.beluga_forward_spans(tparams, rc_codes(t), rc_off)
    want_rc = np.asarray(jspans.beluga_forward_spans(jparams, jrunner.rc_onehot(jx), rc_off))
    np.testing.assert_allclose(got_rc.numpy(), want_rc, atol=TOL, rtol=TOL)


def test_beluga_forward_on_codes(params, tparams, jparams):
    t, x, jx = _both(_codes(3, 2000, seed=9))
    got = beluga_forward(tparams, t)
    torch.testing.assert_close(got, beluga_forward(tparams, x), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_beluga_forward(jparams, jx)), atol=2e-6, rtol=1e-5)
