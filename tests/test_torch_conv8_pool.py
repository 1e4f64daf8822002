"""conv8_relu_pool4, the conv with Beluga's 4-wide max-pool fused into the
kernels' epilogue, on the CPU: its plain path against the JAX package's
``_pool4_from(conv8_relu(..., interpret=True))``; the kernels' tile
ownership (conv8_relu_pool4_flat_plain) against the plain version bit for
bit; the span and per-window forwards with every standalone pool made to
raise; the wrapper's phase checks and counts. The CUDA kernels run only on
the card (tests/test_torch_card.py and chip_smoke.py hold them against the
unfused kernel and the pool there)."""

import ctypes
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis.configuration import set_hypothesis_home_dir
from hypothesis import strategies as st

import jax.numpy as jnp

from expecto_tpu.models.beluga import beluga_forward as jax_beluga_forward
from expecto_tpu.ops import spans as jspans
from expecto_tpu.ops.pallas_conv import conv8_relu as jax_conv8_relu
from expecto_tpu_torch.models import beluga
from expecto_tpu_torch.models.convert import params_from_jax
from expecto_tpu_torch.ops import cuda_build
from expecto_tpu_torch.ops import spans as tspans
from expecto_tpu_torch.ops.conv8 import (
    conv8_relu,
    conv8_relu_plain,
    conv8_relu_pool4,
    conv8_relu_pool4_flat_plain,
    conv8_relu_pool4_plain,
    pool4_frames,
    reset_launch_counts,
)
from torch_port_common import single_torch_thread, narrow_params, onehot, random_codes  # noqa: F401 (autouse fixture)

# fp32 sums of at most 8*48 terms of unit-scale inputs in another order; the
# max is exact
TOL = 1e-5

PHASE_SETS = [(0,), (0, 2), (1, 3), (0, 1, 2, 3)]


def _inputs(n, l, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l, cin)).astype(np.float32)
    w = (rng.standard_normal((8, cin, cout)) / np.sqrt(8 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("cin", [4, 16, 48])
@pytest.mark.parametrize("phases", PHASE_SETS, ids=lambda p: "ph" + "".join(map(str, p)))
@pytest.mark.parametrize("l", [40, 41, 42, 43], ids=lambda l: f"Lmod4_{l % 4}")
def test_pool4_matches_jax_pool_of_pallas_interpret(l, phases, cin):
    x, w, b = _inputs(2, l, cin, 24, seed=l + cin)
    y = jax_conv8_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    got = conv8_relu_pool4(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), phases)
    assert sorted(got) == sorted(phases)
    for ph in phases:
        want = np.asarray(jspans._pool4_from(y, ph))
        assert got[ph].shape == (2, pool4_frames(l - 7, ph), 24) == want.shape
        np.testing.assert_allclose(got[ph].numpy(), want, atol=TOL, rtol=TOL)


def test_pool4_frames_drop_the_remainder():
    assert [pool4_frames(36, ph) for ph in range(4)] == [9, 8, 8, 8]
    assert [pool4_frames(3, ph) for ph in range(4)] == [0, 0, 0, 0]
    assert pool4_frames(1, 3) == 0


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for ph in want:
        assert got[ph].shape == want[ph].shape and got[ph].dtype == want[ph].dtype
        assert torch.equal(got[ph], want[ph]), ph


# spans shorter than a tile, N*L just past a tile's 124 or 60 owned rows or
# a 128- or 64-row tile's edge, a span of exactly 8 (no pool frame at all)
# and spans long enough that the groups start at every offset inside a tile
FLAT_CASES = [(1, 8, (0, 1, 2, 3)), (3, 9, (0,)), (1, 125, (0, 2)), (2, 63, (1, 3)), (5, 26, (0, 2)),
              (1, 300, (0, 1, 2, 3)), (4, 61, (3,)), (2, 131, (0, 3)), (1, 65, (0, 1, 2, 3)), (1, 129, (1, 2)),
              (2, 64, (0, 3)), (3, 43, (2,))]


# the tc and tf32x3 kernels' 128-row tiles stepping 124 rows; the SIMT
# kernel's 128- and 64-row tiles, groups across their edges merged
TILES = [("tc", 128), ("simt", 128), ("simt", 64), ("tf32x3", 128)]


@pytest.mark.parametrize("route,tm", TILES, ids=["tc128", "simt128", "simt64", "tf32x3_128"])
@pytest.mark.parametrize("n,l,phases", FLAT_CASES)
def test_flat_tiles_equal_plain_bit_for_bit(n, l, phases, route, tm):
    x, w, b = (torch.from_numpy(a) for a in _inputs(n, l, 16, 20, seed=n * l))
    got = conv8_relu_pool4_flat_plain(x, w, b, phases, route=route, tm=tm)
    _assert_bit_equal(got, conv8_relu_pool4_plain(x, w, b, phases))


@pytest.fixture(scope="module", autouse=True)
def hypothesis_home(tmp_path_factory):
    """Hypothesis keeps its caches under a temporary directory, not in the
    checkout."""
    set_hypothesis_home_dir(tmp_path_factory.mktemp("hypothesis"))
    yield
    set_hypothesis_home_dir(None)


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(1, 6), l=st.integers(8, 140), tiles=st.sampled_from(TILES),
       phases=st.sets(st.integers(0, 3), min_size=1), dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_flat_tiles_equal_plain_for_any_rows_and_phases(n, l, tiles, phases, dtype):
    x, w, b = (torch.from_numpy(a).to(dtype) for a in _inputs(n, l, 4, 9, seed=n + l))
    got = conv8_relu_pool4_flat_plain(x, w, b, phases, route=tiles[0], tm=tiles[1])
    _assert_bit_equal(got, conv8_relu_pool4_plain(x, w, b, phases))


def test_flat_tiles_reject_an_unknown_route():
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 8, seed=1))
    with pytest.raises(ValueError, match="unknown conv8_relu route"):
        conv8_relu_pool4_flat_plain(x, w, b, (0,), route="cpu")


def test_plain_returns_each_phase_as_its_own_contiguous_tensor():
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 50, 16, 32, seed=5))
    got = conv8_relu_pool4(x, w, b, (2, 0))
    assert list(got) == [0, 2]
    for ph, t in got.items():
        assert t.is_contiguous() and t.storage_offset() == 0
        assert torch.equal(t, tspans._pool4_from(conv8_relu(x, w, b), ph))


@pytest.mark.parametrize("phases", [(), (0, 0), (4,), (-1,), (0, 1, 2, 3, 0)])
def test_pool4_rejects_phase_sets(phases):
    x, w, b = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 8, seed=1))
    with pytest.raises(ValueError, match="pool phases"):
        conv8_relu_pool4(x, w, b, phases)


def test_pool4_on_cpu_counts_no_launch_and_rejects_other_devices():
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 40, 16, 32, seed=7))
    reset_launch_counts()
    conv8_relu_pool4(x, w, b, (0,))
    assert conv8_relu.launches == 0 and conv8_relu_pool4.launches == 0
    assert conv8_relu_pool4.launches_by_route == {"simt": 0, "tc": 0, "tf32x3": 0}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv8_relu_pool4(x.to("meta"), w.to("meta"), b.to("meta"), (0,))


def test_launcher_takes_another_entry_of_the_library(monkeypatch):
    fake = types.SimpleNamespace(probe_pool4_launch=types.SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    fn = cuda_build.launcher("probe", 5, n_ptrs=7, entry="probe_pool4_launch")
    assert fn is fake.probe_pool4_launch
    assert fn.argtypes == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


# the main path with every standalone pool made to raise


@pytest.fixture(scope="module")
def params():
    return narrow_params(23)


@pytest.fixture(scope="module")
def tparams(params):
    return params_from_jax(params)


@pytest.fixture(scope="module")
def jparams(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


@pytest.fixture
def no_standalone_pool(monkeypatch):
    """ops/spans._pool4_from raises, and conv8_relu_pool4 counts its calls
    through the model (the CPU counts no launch)."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a standalone pool ran")

    calls = []
    fused = beluga.conv8_relu_pool4

    def spy(x, w, b, phases):
        calls.append(tuple(phases))
        return fused(x, w, b, phases)

    monkeypatch.setattr(tspans, "_pool4_from", refuse)
    monkeypatch.setattr(beluga, "conv8_relu_pool4", spy)
    return calls


@pytest.mark.parametrize("codes", [False, True], ids=["onehot", "codes"])
def test_conv6_phases_pools_only_in_the_conv_calls(tparams, jparams, no_standalone_pool, codes):
    c = random_codes(np.random.default_rng(4), 2, 2800)
    got = tspans.conv6_phases(tparams, torch.from_numpy(c if codes else onehot(c)), {0, 2})
    assert no_standalone_pool == [(0,), (0, 2)]
    want = jspans.conv6_phases(jparams, jnp.asarray(onehot(c)), {0, 2})
    for ph in (0, 2):
        np.testing.assert_allclose(got[ph].numpy(), np.asarray(want[ph]), atol=TOL, rtol=TOL)


def test_forward_spans_pools_only_in_the_conv_calls(tparams, jparams, no_standalone_pool):
    x = onehot(random_codes(np.random.default_rng(5), 2, 2800))
    offsets = [0, 200, 400, 600, 800]
    got = tspans.beluga_forward_spans(tparams, torch.from_numpy(x), offsets).numpy()
    assert len(no_standalone_pool) == 2
    want = np.asarray(jspans.beluga_forward_spans(jparams, jnp.asarray(x), offsets))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_beluga_forward_pools_only_in_the_conv_calls(params, tparams, jparams, no_standalone_pool):
    assert not hasattr(beluga, "_maxpool4")
    x = onehot(random_codes(np.random.default_rng(6), 3, 2000, n_frac=0.05))
    got = beluga.beluga_forward(tparams, torch.from_numpy(x)).numpy()
    assert no_standalone_pool == [(0,), (0,)]
    np.testing.assert_allclose(got, np.asarray(jax_beluga_forward(jparams, jnp.asarray(x))), atol=2e-6, rtol=1e-5)


def test_patch_sites_c1_keeps_its_one_standalone_pool(tparams, monkeypatch):
    """conv6_from_conv1 takes given conv1 activations, so its first pool is
    the one standalone pool left; its conv3 pools in the kernel call."""
    seen = []
    pool = tspans._pool4_from
    monkeypatch.setattr(tspans, "_pool4_from", lambda h, ph: seen.append(ph) or pool(h, ph))
    x = torch.from_numpy(onehot(random_codes(np.random.default_rng(7), 1, 900)))
    h = tspans.conv1_acts(tparams, x)
    got = tspans.conv6_from_conv1(tparams, h, {0, 2})
    assert seen == [0]
    want = tspans.conv6_phases(tparams, x, {0, 2})
    for ph in (0, 2):
        torch.testing.assert_close(got[ph], want[ph], rtol=0, atol=0)
