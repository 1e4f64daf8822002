"""Span-amortized forward of the port vs the JAX package (ops/spans.py) at
the serving geometries of maxshift 400 (5 shifts) and 800 (9 shifts), fp32
on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from expecto_tpu.genome.windows import variant_shifts
from expecto_tpu.ops import spans as jspans
from expecto_tpu_torch.models.beluga import beluga_forward
from expecto_tpu_torch.models.convert import params_from_jax
from expecto_tpu_torch.ops import spans as tspans
from torch_port_common import single_torch_thread, narrow_params, onehot, random_codes  # noqa: F401 (autouse fixture)

# fp32, summed in another order; the JAX package holds its span path to
# the per-window path at 1e-5
TOL = 1e-5

GEOMETRIES = {"maxshift400": 400, "maxshift800": 800}


@pytest.fixture(scope="module")
def params():
    return narrow_params(11)


@pytest.fixture(scope="module")
def tparams(params):
    return params_from_jax(params)


@pytest.fixture(scope="module")
def jparams(params):
    return {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in params.items()}


def _geometry(maxshift):
    offsets, extra = jspans.span_offsets_for_shifts(variant_shifts(maxshift))
    assert (offsets, extra) == tspans.span_offsets_for_shifts(variant_shifts(maxshift))
    return offsets, 2000 + extra


def _spans(n, span_len, seed):
    return onehot(random_codes(np.random.default_rng(seed), n, span_len))


def _phases_both(tparams, jparams, x, phases):
    got = tspans.conv6_phases(tparams, torch.from_numpy(x), phases)
    want = jspans.conv6_phases(jparams, jnp.asarray(x), phases)
    return got, want


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_conv6_phases_match(tparams, jparams, geometry):
    offsets, span_len = _geometry(GEOMETRIES[geometry])
    phases = {(o // 4) % 4 for o in offsets}
    got, want = _phases_both(tparams, jparams, _spans(2, span_len, seed=1), phases)
    assert sorted(got) == sorted(want) == [0, 2]
    for ph in got:
        np.testing.assert_allclose(got[ph].numpy(), np.asarray(want[ph]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_fc1_pre_uniform_offsets_match(tparams, jparams, geometry):
    offsets, span_len = _geometry(GEOMETRIES[geometry])
    got, want = _phases_both(tparams, jparams, _spans(2, span_len, seed=2), {0, 2})
    h_t = tspans.fc1_pre_from_phases(tparams, got, offsets).numpy()
    h_j = np.asarray(jspans.fc1_pre_from_phases(jparams, want, offsets))
    assert h_t.shape == (2, len(offsets), 64)
    np.testing.assert_allclose(h_t, h_j, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("offsets", [[0, 400, 1200], [1200, 0, 200], [800]])
def test_fc1_pre_non_uniform_offsets_match(tparams, jparams, offsets):
    """Phase-0 starts 0, 25, 75 (two strides), a single-window phase and
    unsorted offsets all take the per-window fallback."""
    span_len = 2000 + max(offsets)
    got, want = _phases_both(tparams, jparams, _spans(2, span_len, seed=3), {(o // 4) % 4 for o in offsets})
    h_t = tspans.fc1_pre_from_phases(tparams, got, offsets).numpy()
    h_j = np.asarray(jspans.fc1_pre_from_phases(jparams, want, offsets))
    np.testing.assert_allclose(h_t, h_j, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_beluga_forward_spans_matches_jax_and_per_window(tparams, jparams, geometry):
    offsets, span_len = _geometry(GEOMETRIES[geometry])
    x = _spans(2, span_len, seed=4)
    got = tspans.beluga_forward_spans(tparams, torch.from_numpy(x), offsets).numpy()
    want = np.asarray(jspans.beluga_forward_spans(jparams, jnp.asarray(x), offsets))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    for i, o in enumerate(offsets):
        win = beluga_forward(tparams, torch.from_numpy(np.ascontiguousarray(x[:, o : o + 2000]))).numpy()
        np.testing.assert_allclose(got[:, i], win, atol=TOL, rtol=TOL)


def test_unaligned_offset_raises(tparams):
    with pytest.raises(ValueError, match="not aligned"):
        tspans.beluga_forward_spans(tparams, torch.zeros(1, 2100, 4), [2])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("mut_len", [1, 3])
def test_patch_and_fc1_delta_match_jax_and_full_alt(tparams, jparams, geometry, mut_len):
    """conv6_phases_patch + fc1_delta_from_phases vs JAX, and patched alt ==
    the full alt forward, at the serving mutpos (maxshift + 999)."""
    maxshift = GEOMETRIES[geometry]
    offsets, span_len = _geometry(maxshift)
    mutpos = maxshift + 999
    phases = {(o // 4) % 4 for o in offsets}
    ref_codes = random_codes(np.random.default_rng(5), 2, span_len)
    alt_codes = ref_codes.copy()
    alt_codes[:, mutpos : mutpos + mut_len] = (alt_codes[:, mutpos : mutpos + mut_len] + 1) % 4
    x_ref, x_alt = onehot(ref_codes), onehot(alt_codes)

    ref_t, ref_j = _phases_both(tparams, jparams, x_ref, phases)
    alt_t = tspans.conv6_phases_patch(tparams, ref_t, torch.from_numpy(x_alt), mutpos, mut_len, phases)
    alt_j = jspans.conv6_phases_patch(jparams, ref_j, jnp.asarray(x_alt), mutpos, mut_len, phases)
    full_alt = tspans.conv6_phases(tparams, torch.from_numpy(x_alt), phases)
    for ph in phases:
        np.testing.assert_allclose(alt_t[ph].numpy(), np.asarray(alt_j[ph]), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(alt_t[ph].numpy(), full_alt[ph].numpy(), atol=TOL, rtol=TOL)

    counts = {ph: b.shape[1] for ph, b in ref_t.items()}
    ranges = tspans.conv6_patch_ranges(mutpos, mut_len, phases, counts)
    assert ranges == jspans.conv6_patch_ranges(mutpos, mut_len, phases, counts)
    d_t = tspans.fc1_delta_from_phases(tparams, ref_t, alt_t, ranges, offsets)
    d_j = np.asarray(jspans.fc1_delta_from_phases(jparams, ref_j, alt_j, ranges, offsets))
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=TOL, rtol=TOL)

    h_ref = tspans.fc1_pre_from_phases(tparams, ref_t, offsets)
    patched = tspans.fc_head(tparams, h_ref + d_t).numpy()
    full = tspans.beluga_forward_spans(tparams, torch.from_numpy(x_alt), offsets).numpy()
    np.testing.assert_allclose(patched, full, atol=TOL, rtol=TOL)
