"""The port's CUDA kernel and runner on the card: conv8_relu against its plain
PyTorch version at ragged shapes, the wrapper's checks on CUDA tensors, and
the serving runner in fp32 on the card against the same runner on the CPU.

These tests need a CUDA GPU and skip without one. This file imports no JAX,
so it runs where JAX is absent; on such a machine pass ``--noconftest``
(tests/conftest.py sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from expecto_tpu_torch.genome.windows import variant_shifts
from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_plain
from expecto_tpu_torch.parallel.runner import BelugaRunner
from torch_port_common import narrow_params, random_codes, sed_atol

pytestmark = pytest.mark.gpu

# kernel vs plain on the same inputs. fp32: sums of up to 8*640 products in
# another order (TF32 off). bf16: the kernel sums the bf16 inputs in fp32 and
# rounds its output to bf16 (relative step 2^-8); the reference is the fp32
# plain version on the same bf16 values.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# conv0 (Cin 4), the shortest input (L 8), ragged L - 7 and Cout that is not
# a multiple of the kernel's 64-channel tile, and the wide Beluga layers
SHAPES = [(2, 64, 4, 32), (3, 13, 4, 48), (2, 8, 20, 40), (1, 37, 48, 96), (2, 300, 320, 480),
          (1, 150, 640, 640), (4, 200, 17, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, l, cin, cout, seed, device, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l, cin)).astype(np.float32)
    w = (rng.standard_normal((8, cin, cout)) / np.sqrt(8 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in (x, w, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,l,cin,cout", SHAPES)
def test_conv8_kernel_matches_plain(cuda, n, l, cin, cout, dtype):
    x, w, b = _inputs(n, l, cin, cout, l + cin, cuda, dtype)
    before = conv8_relu.launches
    got = conv8_relu(x, w, b)
    torch.cuda.synchronize()
    assert conv8_relu.launches == before + 1
    assert got.shape == (n, l - 7, cout) and got.dtype == dtype and got.device.type == "cuda"
    want = conv8_relu_plain(x.float(), w.float(), b.float())
    torch.testing.assert_close(got.float(), want, rtol=TOL[dtype], atol=TOL[dtype])


def test_conv8_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w, b = _inputs(2, 32, 16, 32, 0, cuda, torch.float32)
    before = conv8_relu.launches
    with pytest.raises(TypeError):
        conv8_relu(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):
        conv8_relu(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match="contiguous"):
        conv8_relu(x.transpose(0, 1).contiguous().transpose(0, 1), w, b)
    with pytest.raises(ValueError, match="one device"):
        conv8_relu(x, w.cpu(), b)
    with pytest.raises(ValueError):
        conv8_relu(x, w[:, :8], b)
    assert conv8_relu.launches == before


def test_runner_fp32_on_card_matches_cpu(cuda):
    """score_variant_spans_packed_rows at narrow widths, maxshift 400: fp32 on
    the card (every conv on the kernel) against fp32 on the CPU."""
    maxshift = 400
    offsets = tuple(s + maxshift for s in variant_shifts(maxshift))
    mutpos = maxshift + 999
    rng = np.random.default_rng(5)
    spans = random_codes(rng, 5, 2 * maxshift + 2000)
    alt = ((spans[:, mutpos : mutpos + 1] + 1) % 4).astype(np.int8)
    row_uidx = np.array([0, 0, 1, 2, 3, 3, 4])
    basis = rng.random((len(offsets), len(row_uidx), 10)).astype(np.float32)
    W = (rng.standard_normal((10 * 2002, 3)) * 0.05).astype(np.float32)
    bias = np.array([2.0, 2.1, 1.9], np.float32)
    args = (spans, mutpos, alt, offsets, basis, row_uidx, W, bias)
    params = narrow_params(2)

    before = conv8_relu.launches
    got = BelugaRunner(params, batch_size=16, device="cuda").score_variant_spans_packed_rows(*args)
    assert conv8_relu.launches > before
    want = BelugaRunner(params, batch_size=16, device="cpu").score_variant_spans_packed_rows(*args)
    for name, g, w_ in zip(("REF", "ALT", "SED"), got, want):
        atol = sed_atol(want[0]) if name == "SED" else 1e-5
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=atol, err_msg=name)
