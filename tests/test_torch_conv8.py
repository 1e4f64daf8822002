"""conv8_relu of the port vs the JAX package's Pallas kernel (interpret mode)
and its XLA reference, fp32 on the CPU, where the port's wrapper takes the
plain PyTorch version. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against the plain version there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expecto_tpu.ops.pallas_conv import conv8_relu as jax_conv8_relu
from expecto_tpu.ops.pallas_conv import conv8_relu_reference
from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_plain
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
