"""The port's round of the single-model block coordinate-descent sweep
(``ops/gblinear_round.py``) vs the JAX package, fp32 on the CPU: the plain
round against ``_round_body``'s ``one_round`` (odd row counts, padded last
blocks, L1, a bias regulariser), ``train_gblinear`` through the new call
against the JAX trainer, the wrapper's checks and launch count, the
kernel's row plan, a planted stale-residual fault, and the build helper's
launcher signature and header-aware hash. The CUDA kernel
``csrc/gblinear_round.cu`` is held to the plain round on the card
(tests/test_torch_card.py).

Tolerances: weights, biases, residuals and the per-round RMSE within 1e-5,
as tests/test_torch_gblinear.py holds the trainers (products summed in
another order)."""

import ctypes
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from expecto_tpu.models import gblinear as jgb
from expecto_tpu_torch.models import gblinear as tgb
from expecto_tpu_torch.ops import cuda_build, gblinear_round as gr
from torch_port_common import single_torch_thread, stale_residual_round  # noqa: F401 (autouse fixture)

TOL = 1e-5


def _round_inputs(n: int, f: int, b: int, seed: int):
    """(Xt blocks, column hessians, weights, bias, residual) as numpy: a
    standard-normal (n, f) X padded to blocks of b, and a state part way
    through training (nonzero weights, bias and residual)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    Xt, n_blocks = jgb._pad_blocks(np.ascontiguousarray(X.T), b)
    hess = np.sum(Xt.astype(np.float64) ** 2, axis=2).astype(np.float32)
    w = (rng.normal(size=(n_blocks, b)) * 0.05).astype(np.float32)
    w.reshape(-1)[f:] = 0.0
    bias = np.float32(rng.normal() * 0.1)
    r = rng.normal(size=n).astype(np.float32)
    return Xt, hess, w, bias, r


def _plain_round(Xt, hess, w, bias, r, hp, round_fn=gr.gblinear_round_plain):
    """One round of the port's function ``round_fn`` on CPU copies; returns
    (w, bias, r) as numpy."""
    w_t, bias_t, r_t = torch.from_numpy(w.copy()), torch.tensor([bias]), torch.from_numpy(r.copy())
    denom = float(np.float32(Xt.shape[2]) + np.float32(hp.reg_lambda_bias))
    round_fn(torch.from_numpy(Xt), torch.from_numpy(hess), w_t, bias_t, r_t, None, denom, hp.eta, hp.reg_lambda,
             hp.reg_alpha)
    return w_t.numpy(), float(bias_t[0]), r_t.numpy()


def _jax_round(Xt, hess, w, bias, r, hp):
    one_round = jax.jit(jgb._round_body(jgb.GBLinearParams(**hp.__dict__)))
    w_j, b_j, r_j = one_round(jnp.asarray(w), jnp.float32(bias), jnp.asarray(r), jnp.asarray(Xt), jnp.asarray(hess),
                              jnp.float32(Xt.shape[2]))
    return np.asarray(w_j), float(b_j), np.asarray(r_j)


@pytest.mark.parametrize("alpha", [0.0, 5.0])
@pytest.mark.parametrize("b", [16, 512])
@pytest.mark.parametrize("f", [60, 1100])
@pytest.mark.parametrize("n", [400, 401])
def test_plain_round_matches_jax_one_round(n, f, b, alpha):
    Xt, hess, w, bias, r = _round_inputs(n, f, b, seed=n + f + b)
    hp = tgb.GBLinearParams(eta=0.3, reg_lambda=5.0, reg_alpha=alpha, reg_lambda_bias=3.0, block_size=b)
    got, want = _plain_round(Xt, hess, w, bias, r, hp), _jax_round(Xt, hess, w, bias, r, hp)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    assert abs(got[1] - want[1]) < TOL
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=TOL)
    assert (got[0].reshape(-1)[f:] == 0).all()  # padded features (h = 0) never move
    assert not np.allclose(got[0], w) and got[1] != bias  # the round moved the state


def test_stale_residual_fault_misses_the_limits():
    """The round with r left unadvanced after the first block (the next
    block's gradient is stale) must miss the 1e-5 limits that hold the
    plain round to JAX."""
    Xt, hess, w, bias, r = _round_inputs(401, 1100, 512, seed=9)
    hp = tgb.GBLinearParams(eta=0.3, reg_lambda=5.0, reg_lambda_bias=3.0)
    got, want = _plain_round(Xt, hess, w, bias, r, hp, round_fn=stale_residual_round), _jax_round(
        Xt, hess, w, bias, r, hp)
    assert np.abs(got[0] - want[0]).max() > TOL and np.abs(got[2] - want[2]).max() > TOL


@pytest.fixture(scope="module")
def odd_problem():
    rng = np.random.default_rng(11)
    n, f = 301, 70
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (2.0 + X @ (rng.normal(size=f) * 0.5) + rng.normal(size=n) * 0.1).astype(np.float32)
    return X, y


@pytest.mark.parametrize("kw", [{"block_size": 16, "reg_alpha": 5.0, "reg_lambda_bias": 2.0, "eta": 0.3},
                                {"eta": 0.3, "reg_lambda": 5.0}], ids=["b16-l1-bias", "b512"])
def test_train_gblinear_calls_the_round_once_a_round_and_matches_jax(odd_problem, monkeypatch, kw):
    X, y = odd_problem
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return gr.gblinear_round(*args, **kwargs)

    monkeypatch.setattr(tgb, "gblinear_round", counted)
    evals = [(X[250:], y[250:], "eval"), (X, y, "train")]
    params = dict(num_round=25, **kw)
    got = tgb.train_gblinear(X, y, tgb.GBLinearParams(**params), evals=evals, device="cpu")
    want = jgb.train_gblinear(X, y, jgb.GBLinearParams(**params), evals=evals)
    assert len(calls) == 25 and calls[0] == (-(-70 // params.get("block_size", 512)), params.get("block_size", 512),
                                             301)
    np.testing.assert_allclose(got.weight, want.weight, rtol=0, atol=TOL)
    assert abs(got.bias - want.bias) < TOL
    for name in ("eval", "train"):
        np.testing.assert_allclose(got.eval_history[name], want.eval_history[name], rtol=0, atol=TOL)


def test_train_gblinear_with_the_plain_round_swapped_in_is_unchanged(odd_problem, monkeypatch):
    """The plain round takes the wrapper's arguments, so a test (or the
    card's checks) can swap it in at ``models/gblinear.gblinear_round``."""
    X, y = odd_problem
    hp = tgb.GBLinearParams(num_round=10, block_size=32, reg_alpha=1.0)
    want = tgb.train_gblinear(X, y, hp, device="cpu")
    monkeypatch.setattr(tgb, "gblinear_round", gr.gblinear_round_plain)
    got = tgb.train_gblinear(X, y, hp, device="cpu")
    np.testing.assert_array_equal(got.weight, want.weight)
    assert got.bias == want.bias


def _torch_inputs(n=401, f=100, b=32, seed=2):
    """The round's inputs as CPU tensors, Xt in the kernel's layout (rows a
    multiple of 4 floats apart: models/gblinear.py::_pad_blocks)."""
    Xt, *rest = [torch.from_numpy(np.atleast_1d(np.asarray(a)).copy()) for a in _round_inputs(n, f, b, seed)]
    n_blocks = Xt.shape[0]
    return [tgb._pad_blocks(Xt.reshape(n_blocks * b, n), b)[0], *rest]


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    Xt, hess, w, bias, r = _torch_inputs()
    w2, bias2, r2 = w.clone(), bias.clone(), r.clone()
    gr.reset_launch_counts()
    gr.gblinear_round(Xt, hess, w, bias, r, gr.round_scratch(Xt), 404.0, 0.3, 5.0, 1.0)
    gr.gblinear_round_plain(Xt, hess, w2, bias2, r2, None, 404.0, 0.3, 5.0, 1.0)
    assert gr.gblinear_round.launches == 0  # CPU calls do not count
    assert gr.round_scratch(Xt) is None
    for a, b in ((w, w2), (bias, bias2), (r, r2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case,err,match", [
    ("fp64 Xt", TypeError, "fp32"),
    ("r on another device", ValueError, "one device"),
    ("transposed weights", ValueError, "contiguous"),
    ("2-d Xt", ValueError, "shape"),
    ("weights of another shape", ValueError, "w_blocks of shape"),
    ("0-d bias", ValueError, "bias of shape"),
    ("r of another length", ValueError, "r of shape"),
    ("meta tensors", ValueError, "CUDA or CPU"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, err, match):
    Xt, hess, w, bias, r = _torch_inputs(n=64, f=64, b=8)
    if case == "fp64 Xt":
        Xt = Xt.double()
    elif case == "r on another device":
        r = r.to("meta")
    elif case == "transposed weights":
        w = w.t().contiguous().t()
    elif case == "2-d Xt":
        Xt = Xt[0]
    elif case == "weights of another shape":
        w = w[:-1]
    elif case == "0-d bias":
        bias = bias[0]
    elif case == "r of another length":
        r = r[:-1]
    else:
        Xt, hess, w, bias, r = (t.to("meta") for t in (Xt, hess, w, bias, r))
    with pytest.raises(err, match=match):
        gr.gblinear_round(Xt, hess, w, bias, r, None, 64.0, 0.3, 5.0, 0.0)


@pytest.mark.parametrize("ctas", [1, 2, 131, 132, 133, 264])
def test_row_plan_covers_every_row_once_in_order_for_n_up_to_100000(ctas):
    for start in range(1, 100_001, 20_000):
        n = np.arange(start, min(start + 20_000, 100_001), dtype=np.int64)
        quads = np.multiply.outer(-(-n // 4), np.arange(ctas + 1, dtype=np.int64)) // ctas
        bounds = np.minimum(4 * quads, n[:, None])  # row_plan for every n at once
        lo, hi = gr.row_plan(int(n[-1]), ctas)
        np.testing.assert_array_equal(np.append(lo, hi[-1]), bounds[-1])
        assert (bounds[:, 0] == 0).all() and (bounds[:, -1] == n).all()
        assert (bounds[:, :-1] % 4 == 0).all()  # every slice starts on 16 bytes
        sizes = np.diff(bounds, axis=1)
        assert (sizes >= 0).all() and (sizes.max(axis=1) <= 4 * -(-(-(-n // 4)) // ctas)).all()


@pytest.mark.parametrize("n", [1, 2, 131, 132, 133, 401, 22_296, 99_999, 100_000])
def test_row_plan_covers_every_row_once_in_order_for_1_to_264_ctas(n):
    for ctas in range(1, 265):
        lo, hi = gr.row_plan(n, ctas)
        assert len(lo) == ctas and lo[0] == 0 and hi[-1] == n
        np.testing.assert_array_equal(lo[1:], hi[:-1])
        assert ((lo % 4 == 0) | (lo == n)).all()  # every slice starts on 16 bytes (or is empty at n)
        assert (hi >= lo).all() and (hi - lo).max() <= 4 * -(-(-(-n // 4)) // ctas)
        assert np.array_equal(np.concatenate([np.arange(a, z) for a, z in zip(lo, hi)]), np.arange(n))


# the row-cap cells of the kernel this design replaced (the last row of its
# "shared" plan at B = 512 and the first of its "streamed" one), the "shared"
# plan's cap at 132 CTAs and one row past it, and the most rows the kernel takes:
# every CTA's range fits the kernel's int row indices and starts on 16 bytes
@pytest.mark.parametrize("n", [3_799_356, 3_799_357, 1_081_344, 1_081_345, 2**31 - 1])
def test_row_plan_at_the_streamed_plans_row_counts(n):
    for ctas in (132, 264):
        lo, hi = gr.row_plan(n, ctas)
        assert lo[0] == 0 and hi[-1] == n and np.array_equal(lo[1:], hi[:-1])
        assert (lo % 4 == 0).all() and (hi - lo).max() <= 4 * -(-(-(-n // 4)) // ctas)
        assert (hi - lo)[:-1].min() >= 4 * ((-(-n // 4)) // ctas)
        assert hi.max() < 2**31


def test_scratch_holds_partials_bias_sums_and_updates(monkeypatch):
    """Each CTA's partial gradients and partial sum of r and the block's
    updates, each an 8-byte word with its tag; a launch's tags lie above its
    scratch's earlier ones."""
    assert gr.scratch_floats(132, 512) == 2 * (132 * 512 + 132 + 512)
    monkeypatch.setattr(gr, "_next_tag", {})
    scratch = torch.zeros(gr.scratch_floats(4, 16))
    assert [gr._tags(scratch, 40), gr._tags(scratch, 40), gr._tags(scratch, 1)] == [1, 82, 163]
    scratch[0] = 1.0
    gr._next_tag[("cpu", scratch.untyped_storage().data_ptr())] = 2**31 - 5
    assert gr._tags(scratch, 2) == 1 and not scratch.any()  # zeroed before the count passes 2^31


@pytest.mark.parametrize("view", ["slice", "reshape", "offset", "same tensor anew"])
def test_a_view_of_a_used_scratch_takes_new_tags(monkeypatch, view):
    """The tag count belongs to the scratch's memory, not to the tensor
    object: a view of a used scratch (or a new tensor over its storage)
    goes on above the tags its earlier launches used."""
    monkeypatch.setattr(gr, "_next_tag", {})
    scratch = torch.zeros(gr.scratch_floats(4, 16) + 8)
    first = gr._tags(scratch, 40)
    other = {"slice": lambda: scratch[:], "reshape": lambda: scratch.view(-1, 2),
             "offset": lambda: scratch[8:],
             "same tensor anew": lambda: torch.empty(0).set_(scratch.untyped_storage())}[view]()
    assert other is not scratch
    assert gr._tags(other, 40) == first + 81
    assert gr._tags(scratch, 1) == first + 162


def test_launcher_argtypes_follow_the_counts(monkeypatch):
    fake = types.SimpleNamespace(probe_launch=types.SimpleNamespace(argtypes=None, restype=None))
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    fn = cuda_build.launcher("probe", 4, 4, n_ptrs=6)
    vp = ctypes.c_void_p
    assert fn.argtypes == [vp] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [vp]
    assert fn.restype is ctypes.c_int
    fake.probe_launch.argtypes = None
    assert cuda_build.launcher("probe", 1, 3).argtypes == [vp] * 4 + [ctypes.c_int] + [ctypes.c_float] * 3 + [vp]


def test_library_hash_covers_the_headers_a_source_includes(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    first = cuda_build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert cuda_build.library_path("k") == first
    for header in ("b.cuh", "a.cuh"):
        (tmp_path / header).write_text((tmp_path / header).read_text() + "// edited\n")
        assert cuda_build.library_path("k") != first
        first = cuda_build.library_path("k")
    assert [p.name for p in cuda_build._sources(tmp_path / "k.cu", [])] == ["k.cu", "a.cuh", "b.cuh"]


def test_the_two_gblinear_kernels_share_the_coordinate_step_header():
    """Every kernel that applies the coordinate step includes its one
    header (the coordinate-update kernel also the TF32 split of its planes
    entry, the block-step gradient kernel its own and the wgmma headers)."""
    want = {"gblinear_cd": ["gblinear_cd.cuh", "hopper_common.cuh"],
            "gblinear_round": ["gblinear_cd.cuh", "hopper_common.cuh"],
            "gblinear_block_grad": ["gblinear_block.cuh", "hopper_common.cuh", "gblinear_cd.cuh"]}
    for name, headers in want.items():
        assert [p.name for p in cuda_build._sources(cuda_build.CSRC_DIR / f"{name}.cu", [])] == [f"{name}.cu",
                                                                                                   *headers]
