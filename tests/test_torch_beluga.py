"""Beluga forward of the port vs the JAX package, fp32 on the CPU, with the
weights carried over by params_from_jax and by the shared npz checkpoint."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from expecto_tpu.models.beluga import beluga_forward as jax_beluga_forward
from expecto_tpu.models.beluga import count_params as jax_count_params
from expecto_tpu.models.beluga import init_beluga_params as jax_init_beluga_params
from expecto_tpu.models.convert import save_params_npz as jax_save_params_npz
from expecto_tpu_torch.models.beluga import beluga_forward, count_params, init_beluga_params
from expecto_tpu_torch.models.convert import load_params_npz, params_from_jax, save_params_npz
from torch_port_common import single_torch_thread, narrow_params, onehot, random_codes  # noqa: F401 (autouse fixture)

# fp32 in both stacks, summed in another order (the JAX package holds its
# own Beluga to 2e-6 against a torch oracle at full width). Logits are not
# squashed into (0, 1), so their absolute error scales with their magnitude.
TOL = 2e-6


def _jax(params, x, logits=False):
    jp = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}
    return np.asarray(jax_beluga_forward(jp, jnp.asarray(x), logits=logits))


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed, logits):
    params = narrow_params(seed)
    x = onehot(random_codes(np.random.default_rng(seed), 3, 2000, n_frac=0.05))  # N bases included
    got = beluga_forward(params_from_jax(params), torch.from_numpy(x), logits=logits).numpy()
    assert got.shape == (3, 2002)
    want = _jax(params, x, logits)
    atol = TOL * max(1.0, float(np.abs(want).max())) if logits else TOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)


def test_npz_written_by_jax_package_loads_to_same_outputs(tmp_path):
    params = narrow_params(5)
    path = tmp_path / "beluga.npz"
    jax_save_params_npz(params, path)
    loaded = load_params_npz(path)
    assert {k: {n: a.shape for n, a in d.items()} for k, d in loaded.items()} == {
        k: {n: a.shape for n, a in d.items()} for k, d in params.items()
    }
    x = onehot(random_codes(np.random.default_rng(5), 2, 2000))
    got = beluga_forward(params_from_jax(loaded), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax(params, x), atol=TOL, rtol=1e-5)


def test_port_npz_round_trip_is_exact(tmp_path):
    params = narrow_params(6)
    save_params_npz(params_from_jax(params), tmp_path / "p.npz")
    loaded = load_params_npz(tmp_path / "p.npz")
    for layer, d in params.items():
        for name, a in d.items():
            np.testing.assert_array_equal(loaded[layer][name], a)


def test_params_from_jax_casts_and_keeps_layout():
    params = narrow_params(7)
    t = params_from_jax(params, dtype=torch.bfloat16)
    assert t["conv0"]["w"].shape == (8, 4, 16) and t["conv0"]["w"].dtype == torch.bfloat16
    assert t["fc1"]["w"].shape == params["fc1"]["w"].shape and t["fc1"]["w"].is_contiguous()
    # tensors pass through as well as numpy arrays
    again = params_from_jax(params_from_jax(params))
    np.testing.assert_array_equal(again["fc2"]["b"].numpy(), params["fc2"]["b"])



# --- the random init and the parameter count -----------------------------------


@pytest.fixture(scope="module")
def jax_init():
    """JAX's init at the published widths (it has no width option), drawn once."""
    return jax.tree.map(np.asarray, jax_init_beluga_params(jax.random.PRNGKey(0)))


def _std_error(w) -> float:
    """|std(w) / sqrt(2 / fan_in) - 1| of a weight (a tensor or a numpy
    array) whose fan-in is every axis but the last (the conv kernels' (8,
    in), fc's in)."""
    return abs(float(w.std()) / np.sqrt(2.0 / np.prod(w.shape[:-1])) - 1.0)


def _std_tol(w) -> float:
    """Six standard errors of the sample std of ``w.size`` normal draws,
    relative to the true std: 6 / sqrt(2 n)."""
    return 6.0 / np.sqrt(2.0 * np.prod(w.shape))


def test_count_params_matches_jax():
    narrow = narrow_params(3)
    assert count_params(params_from_jax(narrow)) == count_params(narrow) == jax_count_params(narrow)
    full = jax.eval_shape(jax_init_beluga_params, jax.random.PRNGKey(0))
    assert count_params(full) == jax_count_params(full) == 149_536_251


def test_init_beluga_params_against_jax(jax_init):
    """Names, shapes and dtypes as JAX's tree (fp32 and bf16); zero biases;
    every weight's std within six standard errors of sqrt(2 / fan_in), a
    bound JAX's own draw meets too; the same generator seed gives the same
    tensors, and the bf16 init is the fp32 draw rounded."""
    got = init_beluga_params(torch.Generator().manual_seed(7))
    assert count_params(got) == jax_count_params(jax_init)
    again = init_beluga_params(torch.Generator().manual_seed(7))
    half = init_beluga_params(torch.Generator().manual_seed(7), dtype=torch.bfloat16)
    for dtype, tree in (("float32", got), ("bfloat16", half)):
        shapes = jax.eval_shape(lambda k: jax_init_beluga_params(k, dtype=getattr(jnp, dtype)), jax.random.PRNGKey(0))
        assert {(k, n, s.shape, str(s.dtype)) for k, d in shapes.items() for n, s in d.items()} == {
            (k, n, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, d in tree.items() for n, t in d.items()}
    for name, layer in got.items():
        assert not torch.any(layer["b"]), name
        for leaf, t in layer.items():
            assert t.device.type == "cpu" and torch.equal(t, again[name][leaf]), (name, leaf)
            assert torch.equal(half[name][leaf], t.to(torch.bfloat16)), (name, leaf)
        w = layer["w"]
        assert _std_error(w) < _std_tol(w), (name, _std_error(w), _std_tol(w))
        assert _std_error(jax_init[name]["w"]) < _std_tol(w), (name, _std_error(jax_init[name]["w"]))
        assert abs(float(w.float().mean())) < 6.0 * float(w.float().std()) / np.sqrt(w.numel()), name
