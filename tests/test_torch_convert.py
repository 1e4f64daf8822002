"""The port's .pth -> npz converter (expecto_tpu_torch/models/convert.py) vs
the JAX package's, on the CPU at Beluga's published widths (the converter
checks the widths): the arrays of ``state_dict_to_params``, the npz files
that both packages' ``python -m ... convert`` write from one ``.pth``, the
port's forward on the converted weights against the torch oracle, and the
three shape errors."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from expecto_tpu.models import convert as jconvert
from expecto_tpu_torch.models import convert as tconvert
from expecto_tpu_torch.models.beluga import beluga_forward
from torch_oracle import TorchBeluga
from torch_port_common import single_torch_thread, onehot, random_codes  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
# the port's fp32 forward against the torch oracle, both on the CPU: the JAX
# package's own limit for its Beluga against the oracle (tests/test_beluga.py)
FORWARD_ATOL, FORWARD_RTOL = 2e-6, 1e-5


@pytest.fixture(scope="module")
def oracle():
    """The published topology with seeded He-scaled weights (std
    sqrt(2 / fan_in), biases 0.05), as the port's tests and chip_smoke.py
    draw Beluga's weights, so the tracks spread over (0, 1)."""
    torch.manual_seed(11)
    net = TorchBeluga().eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("weight"):
                p.normal_(0.0, float(np.sqrt(2.0 / p[0].numel())))
            else:
                p.normal_(0.0, 0.05)
    return net


@pytest.fixture(scope="module")
def converted(oracle):
    """(port, JAX) ``state_dict_to_params`` of the oracle's state dict."""
    sd = oracle.state_dict_reference_keys()
    return tconvert.state_dict_to_params(sd), jconvert.state_dict_to_params(sd)


def _assert_params_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer])
        for name, a in want[layer].items():
            assert got[layer][name].dtype == np.float32 == a.dtype
            np.testing.assert_array_equal(got[layer][name], a, err_msg=f"{layer}/{name}")


def test_state_dict_to_params_equals_jax(converted):
    got, want = converted
    _assert_params_equal(got, want)
    assert got["conv1"]["w"].shape == (8, 320, 320) and got["fc1"]["w"].shape == (67840, 2003)
    assert got["fc2"]["w"].shape == (2003, 2002) and got["fc1"]["w"].flags.c_contiguous


def test_fc1_permutation_equals_jax():
    perm = tconvert.fc1_permutation()
    np.testing.assert_array_equal(perm, jconvert.fc1_permutation())
    assert perm[:3].tolist() == [0, 106, 212] and perm[640] == 1  # new[l*640 + c] = old[c*106 + l]
    assert np.array_equal(np.sort(perm), np.arange(67840))
    assert tconvert.TORCH_CONV_KEYS == jconvert.TORCH_CONV_KEYS and tconvert.TORCH_FC_KEYS == jconvert.TORCH_FC_KEYS


def test_both_command_lines_write_equal_npz(oracle, converted, tmp_path):
    """``python -m <package>.models.convert in.pth out.npz`` of both
    packages, run at once, on one .pth: the same keys and equal arrays, and
    the port's equal to its in-process conversion."""
    pth = tmp_path / "deepsea.beluga.pth"
    torch.save(oracle.state_dict_reference_keys(), pth)
    procs = {pkg: subprocess.Popen([sys.executable, "-m", f"{pkg}.models.convert", str(pth), str(tmp_path / f"{pkg}.npz")],
                                   cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pkg in ("expecto_tpu_torch", "expecto_tpu")}
    for pkg, proc in procs.items():
        _out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, (pkg, err[-3000:])
    with np.load(tmp_path / "expecto_tpu_torch.npz") as got, np.load(tmp_path / "expecto_tpu.npz") as want:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 16
        for key in want.files:
            layer, name = key.split("/")
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            np.testing.assert_array_equal(got[key], converted[0][layer][name], err_msg=key)


def test_forward_on_converted_params_matches_oracle(oracle, converted):
    params = tconvert.params_from_jax(converted[0])
    x = onehot(random_codes(np.random.default_rng(3), 2, 2000, n_frac=0.05))  # (N, 2000, 4), N bases included
    got = beluga_forward(params, torch.from_numpy(x)).numpy()
    with torch.no_grad():
        want = oracle(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))[:, :, None, :]).numpy()
    assert got.shape == (2, 2002) and 0.05 < want.std() and np.abs(want[0] - want[1]).max() > 0.05
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=FORWARD_RTOL)
    # the fc1 permutation is what makes them agree: fc1 transposed without it misses
    unpermuted = dict(params, fc1={"w": torch.from_numpy(np.ascontiguousarray(oracle.fc1.weight.detach().numpy().T)),
                                   "b": params["fc1"]["b"]})
    assert np.abs(beluga_forward(unpermuted, torch.from_numpy(x)).numpy() - want).max() > 1e3 * FORWARD_ATOL


@pytest.mark.parametrize("key,shape,message", [
    ("model.0.2.weight", (320, 320, 1, 7), "conv1 weight shape (320, 320, 1, 7), expected (320, 320, 1, 8)"),
    ("model.1.2.1.weight", (2003, 640), "fc1 weight shape (2003, 640), expected (2003, 67840)"),
    ("model.1.4.1.weight", (2002, 2002), "fc2 weight shape (2002, 2002), expected (2002, 2003)"),
], ids=["conv", "fc1", "fc2"])
def test_shape_errors_match_jax(oracle, key, shape, message):
    sd = dict(oracle.state_dict_reference_keys())
    sd[key] = torch.zeros(shape)
    errors = []
    for mod in (tconvert, jconvert):
        with pytest.raises(ValueError) as info:
            mod.state_dict_to_params(sd)
        errors.append(str(info.value))
    assert errors[0] == errors[1] == message
