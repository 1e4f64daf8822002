"""The K-model trainer's block step (ops/gblinear_block.py): on the CPU the
route, the layout and operand packers, the first kernel's schedule, a CPU
emulation of both kernels' three-pass walks against the plain block step and
a float64 block step (a single TF32 pass, the planted fault, must miss), and
``multi_round`` against the JAX package's ``_multi_round_body``; on the card
(``gpu``, skipped here) both kernels at every K the flows run and at tile
edges, bit-equal repeats, the fused one-rank update against the split route
(G, the identity reduce, the coordinate-update kernel's planes entry) bit for
bit, and the wrappers' refusals.

Tolerances: G and the residual's increment within 1e-5 of their max|.|
against float64, as the fp32 fc1 kernels are held (the three-pass split is
closer to float64 than SGEMM); the coordinate step is applied to
the kernel's own G, so w and dw are held bit for bit; ``multi_round``
against JAX within 1e-5 (tests/test_torch_gblinear.py's trainer limit).
JAX is imported inside the CPU tests only, so the card tests run where JAX
is absent."""

import numpy as np
import pytest
import torch

from expecto_tpu_torch.models import gblinear as tgb
from expecto_tpu_torch.ops import gblinear_block as gbb
from expecto_tpu_torch.ops import gblinear_cd
from expecto_tpu_torch.ops.fc1 import split_tf32
from torch_port_common import single_torch_thread  # noqa: F401 (autouse fixture)

ETA, LAM = 0.01, 100.0
REL = 1e-5


# ---- the route, the layout, the packers, the schedule -------------------------


@pytest.mark.parametrize("k,tiles,tile", [(1, 1, 8), (8, 1, 8), (128, 1, 128), (218, 2, 112), (256, 2, 128),
                                          (257, 3, 88), (1000, 8, 128)])
def test_route_is_a_pure_function_of_k_and_ranks(k, tiles, tile):
    for ranks in (1, 2, 4):
        got = [gbb.block_route(k, ranks) for _ in range(2)]
        assert got[0] == got[1] == (ranks == 1, tiles, tile)
        assert got[0].n_pad >= k > got[0].n_pad - tile and tile % 8 == 0 and tile <= gbb.NT_MAX
    for bad in ((0, 1), (5, 0)):
        with pytest.raises(ValueError):
            gbb.block_route(*bad)


@pytest.mark.parametrize("n,f,b", [(333, 70, 32), (8, 512, 512), (1001, 130, 64)])
def test_block_layout_round_trips_and_zero_pads(n, f, b):
    X = torch.from_numpy(np.random.default_rng(n).normal(size=(n, f)).astype(np.float32))
    Xt = gbb.block_layout(X, b)
    n_blocks = -(-f // b)
    ld = gbb.row_stride(n)
    assert Xt.shape == (n_blocks, b, n) and Xt.stride() == (b * ld, ld, 1) and ld % 8 == 0 and ld - n < 8
    np.testing.assert_array_equal(Xt.reshape(n_blocks * b, n)[:f].numpy(), X.T.numpy())
    whole = Xt.as_strided((n_blocks, b, ld), (b * ld, ld, 1))
    assert (whole.reshape(-1, ld)[f:] == 0).all() and (whole[..., n:] == 0).all()
    want, nb = tgb._pad_blocks(X.T, b)
    assert nb == n_blocks and torch.equal(Xt, want)


@pytest.mark.parametrize("n,k", [(5, 1), (333, 12), (64, 130)])
def test_transposed_rows_round_trip_and_zero_pad(n, k):
    A = torch.from_numpy(np.random.default_rng(k).normal(size=(n, k)).astype(np.float32) * 3)
    v = gbb.transposed_rows(A)
    ld = gbb.row_stride(n)
    assert v.shape == (k, n) and v.stride() == (ld, 1) and torch.equal(v, A.T) and ld % 8 == 0 and ld - n < 8
    assert (v.as_strided((k, ld), (ld, 1))[:, n:] == 0).all()
    # the TF32 split the first kernel makes of rw * r: hi and lo TF32-exact, their sum within 2^-21
    hi, lo = split_tf32(v)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), A.T.double().numpy(), rtol=2.0**-21, atol=0)


def test_coord_update_planes_plain_writes_the_split_transposed():
    rng = np.random.default_rng(4)
    g, h, w = (torch.from_numpy(a.astype(np.float32)) for a in
               (rng.normal(size=(40, 9)) * 30, rng.random((40, 9)) * 50, rng.normal(size=(40, 9)) * 0.05))
    h[:3] = 0.0
    w1, w2 = w.clone(), w.clone()
    planes = torch.zeros((2, 16, 64))
    before = gblinear_cd.coord_update.launches
    gblinear_cd.coord_update_planes(g, h, w1, planes, ETA, LAM, 0.7)
    dw = gblinear_cd.coord_update_plain(g, h, w2, ETA, LAM, 0.7)
    assert gblinear_cd.coord_update.launches == before  # CPU calls do not count
    assert torch.equal(w1, w2) and torch.equal(planes[:, :9, :40], torch.stack(split_tf32(dw.T.contiguous())))
    assert (planes[:, 9:] == 0).all() and (planes[..., 40:] == 0).all() and (planes[:, :, :3] == 0).all()
    with pytest.raises(ValueError, match="planes"):
        gblinear_cd.coord_update_planes(g, h, w1, torch.zeros((2, 8, 64)), ETA, LAM, 0.0)
    with pytest.raises(TypeError, match="fp32"):
        gblinear_cd.coord_update_planes(g.double(), h, w1, planes, ETA, LAM, 0.0)


@pytest.mark.parametrize("n,b,k,ctas", [(21202, 512, 218, 132), (22296, 512, 128, 132), (18000, 512, 256, 132),
                                        (22296, 512, 1, 132), (22296, 512, 1000, 132), (333, 256, 130, 7),
                                        (40, 512, 1000, 5), (1, 8, 3, 132)])
def test_grad_schedule_covers_every_segment_and_tile_once(n, b, k, ctas):
    route = gbb.block_route(k, 1)
    sched = gbb.grad_schedule(n, b, route, ctas)
    assert sched.grid <= ctas and sched.grid <= sched.units and sched.segments <= sched.stages
    walk = gbb.grad_units(sched, route)
    assert len(walk) == sched.grid and all(walk)
    seen = [(ft, mt, s) for units in walk for ft, mt, s, _a, _b in units]
    assert sorted(seen) == [(ft, mt, s) for ft in range(sched.feature_tiles) for mt in range(route.tiles)
                            for s in range(sched.segments)]
    spans = sorted({(s, a, e) for units in walk for _ft, _mt, s, a, e in units})
    assert [a for _s, a, _e in spans] == [0] + [e for _s, _a, e in spans[:-1]] and spans[-1][2] == sched.stages
    assert sched.stages == -(-n // 32) and sched.feature_tiles == -(-b // 128)
    if (n, b, k) == (21202, 512, 218):
        assert (sched.feature_tiles, route.tiles, sched.segments, sched.grid) == (4, 2, 16, 128)
    units, grid = gbb.resid_grid(n, route, ctas)
    assert units == -(-n // 128) * route.tiles and grid == min(units, ctas)


# ---- the three-pass walks emulated on the CPU ---------------------------------


def _tc(a_parts, b_parts, passes):
    """One chain of tensor-core products in float64: lo*hi + hi*lo + hi*hi
    (or hi*hi alone, the planted single pass)."""
    (ah, al), (bh, bl) = a_parts, b_parts
    if passes == 1:
        return ah.double() @ bh.double()
    return al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()


def _emulate_grad(Xb, v, route, ctas, passes=3):
    """The first kernel's G (B, K) from X and V = rw * r (K, n): both split,
    each unit's 32-row stages summed on the tensor cores (float64 here) and
    promoted into an fp32 sum a stage, the units' parts summed in segment
    order."""
    b, n = Xb.shape
    k = v.shape[0]
    sched = gbb.grad_schedule(n, b, route, ctas)
    xs = [torch.nn.functional.pad(t, (0, sched.stages * 32 - n, 0, sched.feature_tiles * 128 - b))
          for t in split_tf32(Xb)]
    vs = [torch.nn.functional.pad(t.T, (0, route.n_pad - k, 0, sched.stages * 32 - n)) for t in split_tf32(v)]
    parts = torch.zeros((sched.segments, sched.feature_tiles * 128, route.n_pad))
    for units in gbb.grad_units(sched, route):
        for ft, mt, s, st0, st1 in units:
            f, m = slice(128 * ft, 128 * ft + 128), slice(route.tile * mt, route.tile * mt + route.tile)
            acc = torch.zeros((128, route.tile))
            for st in range(st0, st1):
                rows = slice(32 * st, 32 * st + 32)
                acc = acc + _tc([x[f, rows] for x in xs], [u[rows, m] for u in vs], passes).float()
            parts[s, f, m] = acc
    g = parts[0]
    for s in range(1, sched.segments):
        g = g + parts[s]
    return g[:b, :k].contiguous()


def _emulate_resid_increment(Xb, dw, passes=3):
    """The second kernel's r increment (K, n): X and dw split, the block's
    features on one tensor-core chain (float64 here), rounded to fp32 once."""
    return _tc([x.T for x in split_tf32(Xb)], split_tf32(dw), passes).float().T


def _block_problem(n, b, k, seed, device="cpu"):
    """Xb (b, n) in block_layout's layout, rw and r (k, n) in
    transposed_rows', h = (Xb * Xb) @ rw.T and w (b, k), on ``device``;
    the last 5 features zero (padded rows: h = 0) and the last row weighted
    1 in every model."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, b)).astype(np.float32)
    X[:, -5:] = 0.0
    rw = rng.integers(0, 3, size=(n, k)).astype(np.float32)
    rw[-1] = 1.0
    r = (rng.normal(size=(n, k)) * 2).astype(np.float32)
    w = (rng.normal(size=(b, k)) * 0.05).astype(np.float32)
    Xb = gbb.block_layout(torch.from_numpy(X).to(device), b)[0]
    rw, r = (gbb.transposed_rows(torch.from_numpy(a).to(device)) for a in (rw, r))
    return Xb, rw, r, (Xb * Xb) @ rw.T, torch.from_numpy(w).to(device)


def _walk(problem, route, ctas, alpha, passes=3):
    """Both kernels emulated: (G, w after, dw, increment of r)."""
    Xb, rw, r, h, w = problem
    g = _emulate_grad(Xb, rw * r, route, ctas, passes)
    w = w.clone()
    dw = gblinear_cd.coord_update_plain(g, h, w, ETA, LAM, alpha)
    return g, w, dw, _emulate_resid_increment(Xb, dw, passes)


def _float64_step(problem, alpha):
    Xb, rw, r, h, w = problem
    g = Xb.double() @ (rw.double() * r.double()).T
    w = w.clone()
    dw = gblinear_cd.coord_update_plain(g.float(), h, w, ETA, LAM, alpha)
    return g, dw, dw.double().T @ Xb.double()


def _gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("n,b,k,ctas,alpha", [(333, 256, 12, 7, 0.0), (333, 256, 130, 7, 25.0), (701, 128, 8, 132, 0.7),
                                              (130, 512, 257, 5, 0.0)])
def test_emulated_walk_matches_plain_and_float64(n, b, k, ctas, alpha):
    problem = _block_problem(n, b, k, seed=n + k)
    Xb, rw, r, h, w = problem
    route = gbb.block_route(k, 1)
    g, w_new, dw, inc = _walk(problem, route, ctas, alpha)
    g64, _dw64, inc64 = _float64_step(problem, alpha)
    assert _gap(g, g64) <= REL and _gap(inc, dw.double().T @ Xb.double()) <= REL
    # the plain block step (the two torch statements), on the same inputs
    w_plain, r_plain = w.clone(), r.clone()
    dw_plain = gbb.grad_update_plain(Xb, rw, r_plain, h, w_plain, ETA, LAM, alpha)
    gbb.residual_update_plain(Xb, dw_plain, r_plain)
    assert _gap(g, Xb @ (rw * r).T) <= REL
    assert float((w_new - w_plain).abs().max()) <= REL * float(w_plain.abs().max())
    assert _gap(r + inc, r_plain) <= REL and _gap(inc, inc64) <= 1e-4
    assert (dw[-5:] == 0).all()  # padded features


@pytest.mark.parametrize("n,b,k,ctas", [(333, 256, 12, 7), (701, 128, 130, 132)])
def test_single_tf32_pass_misses_the_limits(n, b, k, ctas):
    problem = _block_problem(n, b, k, seed=3)
    g, _w, dw, inc = _walk(problem, gbb.block_route(k, 1), ctas, 0.0, passes=1)
    g64, _dw64, _inc64 = _float64_step(problem, 0.0)
    Xb = problem[0]
    assert _gap(g, g64) > 10 * REL and _gap(inc, dw.double().T @ Xb.double()) > 10 * REL


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    Xb, rw, r, h, w = _block_problem(97, 64, 5, seed=9)
    w1, w2, r1, r2 = w.clone(), w.clone(), gbb.transposed_rows(r.T), gbb.transposed_rows(r.T)
    gbb.reset_launch_counts()
    dw1 = gbb.grad_update(Xb, rw, r1, h, w1, ETA, LAM, 0.5)
    gbb.residual_update(Xb, dw1, r1)
    dw2 = gbb.grad_update_plain(Xb, rw, r2, h, w2, ETA, LAM, 0.5)
    gbb.residual_update_plain(Xb, dw2, r2)
    assert torch.equal(dw1, dw2) and torch.equal(w1, w2) and torch.equal(r1, r2)
    assert gbb.grad_update.launches == 0 and gbb.residual_update.launches == 0
    seen = []
    gbb.grad_update(Xb, rw, r1, h, w1, ETA, LAM, 0.5, reduce=lambda t: seen.append(t.shape) or t)
    assert seen == [(64, 5)]  # the CPU sums go through reduce
    assert r1.stride() == (gbb.row_stride(97), 1)  # updated in place, in its layout


def test_multi_round_matches_jax_multi_round_body():
    """multi_state + R multi_round (the plain versions on the CPU) against
    the JAX package's jitted _multi_round_body on the same bootstrap
    problem, within the trainers' 1e-5."""
    import jax
    import jax.numpy as jnp

    from expecto_tpu.models import gblinear as jgb

    rng = np.random.default_rng(11)
    n, f, k = 300, 90, 4
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (2.0 + X @ (rng.normal(size=f) * 0.3) + rng.normal(size=n) * 0.1).astype(np.float32)
    Y = np.stack([y] * k, axis=1)
    W = tgb.bootstrap_row_weights(n, [0, 1, 2, 3])
    hp = tgb.GBLinearParams(eta=0.3, reg_lambda=5.0, reg_alpha=2.0, block_size=32)
    s = tgb.multi_state(X, Y, W, hp, torch.device("cpu"))
    assert s.scratch is None and s.Xt.stride(1) == s.r.stride(0) == s.rw.stride(0) == gbb.row_stride(n)
    jhp = jgb.GBLinearParams(eta=0.3, reg_lambda=5.0, reg_alpha=2.0, block_size=32)
    Xt_blocks, _ = jgb._pad_blocks(np.ascontiguousarray(X.T), 32)
    rw = jnp.asarray(W)
    hess = jnp.stack([jnp.dot(Xb * Xb, rw, precision=jax.lax.Precision.HIGHEST) for Xb in jnp.asarray(Xt_blocks)])
    state = (jnp.zeros((Xt_blocks.shape[0], 32, k), jnp.float32), jnp.zeros((k,), jnp.float32),
             jnp.asarray(np.full((n, k), 2.0, np.float32) - Y))
    one_round = jax.jit(jgb._multi_round_body(jhp))
    for _ in range(8):
        tgb.multi_round(hp, s)
        state = one_round(*state, rw, jnp.asarray(W.sum(axis=0)), jnp.asarray(Xt_blocks), hess)
    np.testing.assert_allclose(s.w_blocks.numpy(), np.asarray(state[0]), rtol=0, atol=REL)
    np.testing.assert_allclose(s.bias.numpy(), np.asarray(state[1]), rtol=0, atol=REL)
    np.testing.assert_allclose(s.r.numpy().T, np.asarray(state[2]), rtol=0, atol=1e-4)


# ---- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_problem(n, b, k, seed, device):
    """_block_problem on the card, with the sweep's scratch."""
    Xb, rw, r, h, w = _block_problem(n, b, k, seed, device)
    return Xb, rw, r, h, w, gbb.block_scratch(Xb.unsqueeze(0), k, 1)


def _rows_copy(r):
    """A copy of r (K, n) in transposed_rows' layout."""
    return gbb.transposed_rows(r.T)


def _card_step(Xb, rw, r, h, w, scratch, alpha, fused=True):
    """One block step on the card from copies: (G or None, w, dw's planes,
    r)."""
    w, r = w.clone(), _rows_copy(r)
    gbb._launch_grad(Xb, rw, r, scratch, h, w, ETA, LAM, alpha, fused=fused)
    g = None
    if not fused:
        g = scratch.g.clone()
        gblinear_cd.coord_update_planes(scratch.g, h, w, scratch.dw, ETA, LAM, alpha)
    planes = scratch.dw.clone()
    gbb.residual_update(Xb, scratch.dw, r, scratch=scratch)
    torch.cuda.synchronize()
    return g, w, planes, r


def _bits(t):
    return t.contiguous().view(torch.int32)


CARD_SHAPES = [(2000, 512, 1), (2000, 512, 8), (4001, 512, 128), (2001, 512, 218), (1999, 512, 256),
               (2000, 512, 257), (1500, 512, 1000), (130, 512, 218), (129, 384, 136), (7, 64, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,b,k", CARD_SHAPES)
def test_kernels_match_float64_and_repeat_bit_for_bit(cuda, n, b, k):
    Xb, rw, r, h, w, scratch = _card_problem(n, b, k, n + k, cuda)
    g, w_new, planes, r_new = _card_step(Xb, rw, r, h, w, scratch, 0.7, fused=False)
    g64 = Xb.double() @ (rw.double() * r.double()).T
    assert _gap(g, g64) <= REL
    w_want = w.clone()
    dw = gblinear_cd.coord_update_plain(g, h, w_want, ETA, LAM, 0.7)
    assert torch.equal(_bits(w_new), _bits(w_want))
    assert torch.equal(planes[:, :k, :b], torch.stack(split_tf32(dw.T.contiguous())))
    inc64 = dw.double().T @ Xb.double()
    assert _gap(r_new, r.double() + inc64) <= REL
    # the increment alone: the residual kernel on r = 0 (r_new - r would carry fp32's rounding of r)
    inc = _rows_copy(torch.zeros_like(r))
    gbb.residual_update(Xb, scratch.dw, inc, scratch=scratch)
    assert _gap(inc, inc64) <= REL
    again = _card_step(Xb, rw, r, h, w, scratch, 0.7, fused=False)
    assert all(torch.equal(_bits(a), _bits(z)) for a, z in zip((g, w_new, planes, r_new), again))


@pytest.mark.gpu
@pytest.mark.parametrize("n,b,k", CARD_SHAPES)
def test_fused_update_equals_the_split_route_bit_for_bit(cuda, n, b, k):
    Xb, rw, r, h, w, scratch = _card_problem(n, b, k, 2 * n + k, cuda)
    _g, w_split, planes_split, r_split = _card_step(Xb, rw, r, h, w, scratch, 25.0, fused=False)
    _none, w_fused, planes_fused, r_fused = _card_step(Xb, rw, r, h, w, scratch, 25.0, fused=True)
    assert torch.equal(_bits(w_fused), _bits(w_split)) and torch.equal(_bits(planes_fused), _bits(planes_split))
    assert torch.equal(_bits(r_fused), _bits(r_split))


@pytest.mark.gpu
@pytest.mark.parametrize("n,b,k", [(2001, 512, 218), (130, 512, 1000), (7, 64, 3)])
def test_kernels_keep_the_padding_zero(cuda, n, b, k):
    """r's padding columns and dw's planes past K models and B features stay
    zero through the wrappers' block steps (the kernels read them)."""
    Xb, rw, r, h, w, scratch = _card_problem(n, b, k, 5, cuda)
    for _ in range(2):
        dw = gbb.grad_update(Xb, rw, r, h, w, ETA, LAM, 0.0, scratch=scratch)
        gbb.residual_update(Xb, dw, r, scratch=scratch)
    torch.cuda.synchronize()
    ld = gbb.row_stride(n)
    assert (r.as_strided((k, ld), (ld, 1))[:, n:] == 0).all()
    assert (scratch.dw[:, k:] == 0).all() and (scratch.dw[..., b:] == 0).all() and bool(torch.isfinite(r).all())


@pytest.mark.gpu
def test_kernels_on_a_second_stream_and_late_row_fault(cuda):
    n, b, k = 2001, 512, 218
    Xb, rw, r, h, w, scratch = _card_problem(n, b, k, 8, cuda)
    want = _card_step(Xb, rw, r, h, w, scratch, 0.7, fused=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = _card_step(Xb, rw, r, h, w, scratch, 0.7, fused=True)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(z)) for a, z in zip(want[1:], got[1:]))
    # a late row of X changed (the last 32-row stage; weighted 1 in every model) moves G beyond the limit
    Xf = Xb.T.contiguous()
    Xf[n - 1] += 1.0
    g64 = Xb.double() @ (rw.double() * r.double()).T
    gbb._launch_grad(gbb.block_layout(Xf, b)[0], rw, r, scratch, h, w.clone(), ETA, LAM, 0.7, fused=False)
    torch.cuda.synchronize()
    assert _gap(scratch.g, g64) > 10 * REL


@pytest.mark.gpu
def test_multi_trainer_counts_the_two_kernels_a_block(cuda):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(700, 1100)).astype(np.float32)
    Y = rng.normal(size=(700, 5)).astype(np.float32)
    hp = tgb.GBLinearParams(num_round=4)
    gbb.reset_launch_counts()
    gblinear_cd.reset_launch_counts()
    gpu = tgb.train_gblinear_multi(X, Y, hp, device="cuda")
    assert gbb.grad_update.launches_by_route == {"fused": 4 * 3, "split": 0}
    assert gbb.residual_update.launches == 4 * 3 and gblinear_cd.coord_update.launches == 0
    cpu = tgb.train_gblinear_multi(X, Y, hp, device="cpu")
    np.testing.assert_allclose(gpu.weights, cpu.weights, rtol=0, atol=REL * float(np.abs(cpu.weights).max()))
    np.testing.assert_allclose(gpu.biases, cpu.biases, rtol=0, atol=REL)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    Xb, rw, r, h, w, scratch = _card_problem(300, 128, 5, 1, cuda)
    with pytest.raises(TypeError, match="fp32"):
        gbb.grad_update(Xb.double(), rw, r, h, w, ETA, LAM, 0.0, scratch=scratch)
    with pytest.raises(ValueError, match="one device"):
        gbb.grad_update(Xb, rw.cpu(), r, h, w, ETA, LAM, 0.0, scratch=scratch)
    with pytest.raises(ValueError, match="BlockScratch"):
        gbb.grad_update(Xb, rw, r, h, w, ETA, LAM, 0.0)
    with pytest.raises(ValueError, match="layout"):
        gbb.grad_update(Xb.contiguous(), rw, r, h, w, ETA, LAM, 0.0, scratch=scratch)
    with pytest.raises(ValueError, match="layout"):
        gbb.grad_update(Xb, rw.contiguous(), r, h, w, ETA, LAM, 0.0, scratch=scratch)
    with pytest.raises(ValueError, match="another block"):
        gbb.grad_update(Xb, rw[:4], r[:4], h[:, :4].contiguous(), w[:, :4].contiguous(), ETA, LAM, 0.0,
                        scratch=scratch)
    with pytest.raises(ValueError, match="h and w"):
        gbb.grad_update(Xb, rw, r, h.t().contiguous().t(), w, ETA, LAM, 0.0, scratch=scratch)
    with pytest.raises(ValueError, match="planes"):
        gbb.residual_update(Xb, scratch.dw.clone(), r, scratch=scratch)
    with pytest.raises(ValueError, match="layout"):
        gbb.residual_update(Xb, scratch.dw, r.contiguous(), scratch=scratch)
