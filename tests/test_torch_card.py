"""The port's CUDA kernels and runner on the card: conv8_relu (its three
routes: the bf16 tensor-core kernel, the fp32 three-pass TF32 kernel, held
also against float64, and the SIMT kernel) and conv0_codes_relu
(the code-gather conv0 kernel) against their plain PyTorch versions at
ragged and short shapes, batches past 65,535 spans and misaligned views, the
route and launch counts, the wrappers' checks on CUDA tensors, and the
serving runner in fp32 on the card against the same runner on the CPU, and
the h5-contract runner methods (``predict_span_codes``,
``predict_span_pairs_diff``, ``predict_span_pair_diffs_only``) on the card
against the CPU, with their sinks, an N-dense chunk and the launch counts of
each dtype's routes; and the gene-feature path: every conv shape of a gene
chunk (16 spans of 41,800 bp) on each route, ``predict_spans_project``
against ``predict_and_project`` and the CPU on both strands, the 4-bit
route on an N-dense gene chunk, and the launch counts a chunk; and the
consensus cohort path: every conv shape of a backbone forward (one span of
41,808 bp) and of the patch batches (704-base sub-spans, N·K = 40 and 384)
on each route, ``conv6_phases_patch_sites`` against the full forward and
the CPU, ``project_spans_backbone_patch`` against ``predict_spans_project``
and the CPU on both strands, bit-equal repeat calls and the launch counts; and
gblinear training: the coordinate-update kernel (``csrc/gblinear_cd.cu``)
against its plain version bit for bit at (512, 1), (512, 128) and (512, 218)
with padded rows, the hessian guard, L1 and ties, its wrapper's checks and
launch count; the round kernel (``csrc/gblinear_round.cu``) against the
plain round at odd and even row counts, blocks of 16 and 512 and L1, over 1
and 30 rounds, bit-equal reruns, one launch a round and a planted
stale-residual fault; and the trainers with the kernels against the same
trainers with the plain versions swapped in (the round within the
card-vs-CPU limits, the K-model sweep bit for bit), against a second run
and against the CPU; and multi-process runs: the backend and device rule on
this machine's cards, and the row-sharded trainers as a 2-rank torchrun
group on the card (two ranks share one card over gloo) against the 1-rank
trainer; and the round kernel's two shared-memory plans: one round on both
sides of the "shared" plan's row cap (one launch of the kernel either way),
held to the plain round, and ``train_gblinear`` past the cap; and Beluga weights from
the ``.pth`` converter (models/convert.py) served on the card against the
torch oracle on the CPU; and the runner's pipelined execution: depth 4
against depth 1 bit for bit, depth 2 over 40 chunks with a slowed writer, a
landing buffer reused a chunk early (a planted fault that must miss), dispatch
running ahead of the first write by the launch counts, and every public
method through a warm call under torch's sync debug mode "error"; and the
pooled epilogue (``conv8_relu_pool4``) on each route, bit-equal to the
route's unfused kernel followed by ``ops/spans._pool4_from`` at the serving
conv1 and conv3 shapes, the patch sub-spans and tile edges.

These tests need a CUDA GPU and skip without one. This file imports no JAX,
so it runs where JAX is absent; on such a machine pass ``--noconftest``
(tests/conftest.py sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_card.py
"""

import functools
import json
import time

import numpy as np
import pytest
import torch

from expecto_tpu_torch.genome.windows import gene_shifts, variant_shifts
from expecto_tpu_torch.models import convert, gblinear
from expecto_tpu_torch.ops import conv0, conv8, cuda_build, gblinear_cd
from expecto_tpu_torch.ops import gblinear_round as gr
from expecto_tpu_torch.ops.conv0 import conv0_codes_relu, conv0_codes_relu_plain
from expecto_tpu_torch.ops.conv8 import conv8_relu, conv8_relu_plain, conv8_relu_pool4, conv8_relu_pool4_plain, reset_launch_counts
from expecto_tpu_torch.ops.decay import gene_pos_weights
from expecto_tpu_torch.ops.spans import _pool4_from, conv6_patch_sites_plan, conv6_phases, conv6_phases_patch_sites
from expecto_tpu_torch.parallel import mesh
from expecto_tpu_torch.parallel.runner import BelugaRunner
from torch_oracle import TorchBeluga
from torch_port_common import DIST_WORKER, narrow_params, random_codes, sed_atol, stale_residual_round, torchrun

pytestmark = pytest.mark.gpu

# kernel vs plain on the same inputs. fp32: sums of up to 8*640 products in
# another order (TF32 off). bf16: the kernel sums the bf16 inputs in fp32 and
# rounds its output to bf16 (relative step 2^-8); the reference is the fp32
# plain version on the same bf16 values.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# conv0 (Cin 4), the shortest input (L 8), ragged L - 7 and Cout that is not
# a multiple of the kernels' 160-channel tile, and the wide Beluga layers
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


# both flat-row kernels at Beluga's widths on short rows (patch sub-span
# lengths, one to five spans a tile), at a serving chunk's 227 spans (64-
# and 128-row tiles of the SIMT kernel), and at Cout that is not a multiple
# of their 160-channel tile
TC_SHAPES = ([(5, l, cin, cout) for l in (8, 9, 26, 34) for cin in (320, 480, 640) for cout in (320, 480, 640)]
             + [(227, 34, 640, 640), (227, 26, 480, 640), (227, 120, 320, 480), (3, 40, 32, 40), (2, 19, 16, 1),
                (4, 50, 64, 161), (1, 300, 320, 330)])
# the tc kernel on the bf16 main path, the tf32x3 kernel on the fp32 main
# path; the SIMT kernel forced, in fp32 and in bf16
FLAT_ROUTES = [("tc", torch.bfloat16), ("tf32x3", torch.float32), ("simt", torch.float32), ("simt", torch.bfloat16)]
FLAT_IDS = ["tc-bf16", "tf32x3-fp32", "simt-fp32", "simt-bf16"]


def _assert_route_matches_plain(x, w, b, route):
    """One launch of ``route`` (and of no other kernel), held against the
    fp32 plain version on the same inputs."""
    before = dict(conv8_relu.launches_by_route)
    got = conv8_relu(x, w, b, route=route)
    torch.cuda.synchronize()
    assert conv8_relu.launches_by_route == {r: k + (r == route) for r, k in before.items()}
    n, l, _cin = x.shape
    assert got.shape == (n, l - 7, w.shape[2]) and got.dtype == x.dtype and got.device.type == "cuda"
    want = conv8_relu_plain(x.float(), w.float(), b.float())
    torch.testing.assert_close(got.float(), want, rtol=TOL[x.dtype], atol=TOL[x.dtype])
    return got


@pytest.mark.parametrize("route,dtype", FLAT_ROUTES, ids=FLAT_IDS)
@pytest.mark.parametrize("n,l,cin,cout", TC_SHAPES)
def test_conv8_tc_kernel_matches_plain(cuda, n, l, cin, cout, route, dtype):
    x, w, b = _inputs(n, l, cin, cout, n + l + cin + cout, cuda, dtype)
    _assert_route_matches_plain(x, w, b, route)


# Cin off the SIMT kernel's 4-channel stage (zero-filled) and Cout off its
# 160-channel tile and off its 4- and 2-channel vector stores
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(cin, cout) for cin in (4, 17, 20) for cout in (1, 7, 161)])
def test_conv8_simt_kernel_at_ragged_channels(cuda, cin, cout, dtype):
    x, w, b = _inputs(3, 45, cin, cout, cin + cout, cuda, dtype)
    _assert_route_matches_plain(x, w, b, "simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv8_simt_kernel_past_65535_spans(cuda, dtype):
    """Flat rows: N is not a grid dimension, so N = 70,000 launches once."""
    x, w, b = _inputs(70_000, 8, 4, 32, 70, cuda, dtype)
    _assert_route_matches_plain(x, w, b, "simt")


@pytest.mark.parametrize("cin", [320, 17])
def test_conv8_simt_kernel_on_a_misaligned_fp32_view(cuda, cin):
    """A contiguous fp32 view 4 bytes past a 16-byte boundary stages through
    the same 4-byte copies and gives the SIMT kernel's result on the aligned
    tensor (which takes the tf32x3 route unless forced)."""
    x, w, b = _inputs(3, 30, cin, 320, cin, cuda, torch.float32)
    buf = torch.empty(x.numel() + 8, device=cuda)
    view = buf[1 : 1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    got = _assert_route_matches_plain(view, w, b, "simt")
    torch.testing.assert_close(got, conv8_relu(x, w, b, route="simt"), rtol=0, atol=0)


def test_conv8_route_counts_follow_the_dispatch(cuda):
    reset_launch_counts()
    for dtype, cin in ((torch.bfloat16, 320), (torch.bfloat16, 4), (torch.float32, 320), (torch.bfloat16, 480)):
        conv8_relu(*_inputs(2, 40, cin, 32, cin, cuda, dtype))
    torch.cuda.synchronize()
    assert conv8_relu.launches == 4
    assert conv8_relu.launches_by_route == {"simt": 1, "tc": 2, "tf32x3": 1}
    assert conv8_relu.launches_by_kind == {("tc", "bfloat16", 320): 1, ("tc", "bfloat16", 480): 1,
                                           ("simt", "bfloat16", 4): 1, ("tf32x3", "float32", 320): 1}


def test_conv8_misaligned_bf16_goes_to_simt_and_tc_refuses_it(cuda):
    x, w, b = _inputs(2, 30, 320, 320, 9, cuda, torch.bfloat16)
    buf = torch.empty(x.numel() + 8, device=cuda, dtype=torch.bfloat16)
    view = buf[1 : 1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    before = dict(conv8_relu.launches_by_route)
    got = conv8_relu(view, w, b)
    torch.cuda.synchronize()
    assert conv8_relu.launches_by_route == {**before, "simt": before["simt"] + 1}
    torch.testing.assert_close(got, conv8_relu(x, w, b), rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="tc kernel takes"):
        conv8_relu(view, w, b, route="tc")
    with pytest.raises(ValueError, match="tc kernel takes"):
        conv8_relu(x.float(), w.float(), b.float(), route="tc")


@pytest.mark.parametrize("cin", [320, 18])
def test_conv8_misaligned_or_ragged_fp32_goes_to_simt_and_tf32x3_refuses_it(cuda, cin):
    """fp32 off the tf32x3 rule, a view 4 bytes past a 16-byte boundary or a
    Cin off its 4-channel stage, runs on the SIMT kernel; the tf32x3 route
    forced on it raises and launches nothing."""
    x, w, b = _inputs(2, 30, cin, 320, 9, cuda, torch.float32)
    buf = torch.empty(x.numel() + 8, device=cuda)
    view = buf[1 : 1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    assert conv8._route("cuda", torch.float32, cin, x.data_ptr()) == ("tf32x3" if cin % 4 == 0 else "simt")
    before = dict(conv8_relu.launches_by_route)
    got = conv8_relu(view, w, b)
    torch.cuda.synchronize()
    assert conv8_relu.launches_by_route == {**before, "simt": before["simt"] + 1}
    torch.testing.assert_close(got, conv8_relu(x, w, b), rtol=TOL[torch.float32], atol=TOL[torch.float32])
    before = dict(conv8_relu.launches_by_route)
    with pytest.raises(ValueError, match="tf32x3 kernel takes"):
        conv8_relu(view, w, b, route="tf32x3")
    with pytest.raises(ValueError, match="tf32x3 kernel takes"):
        conv8_relu(x.bfloat16(), w.bfloat16(), b.bfloat16(), route="tf32x3")
    assert conv8_relu.launches_by_route == before


# fp32 conv1-conv5 shapes of the flows at Beluga's widths: the serving
# patch sub-span's conv5 (K split in 2 parts), the consensus patch at N.K =
# 40 (conv4 in 2 parts, conv5 in 3), a gene chunk's conv5 (one part)
TF32_SHAPES = [(227, 27, 640, 640), (40, 39, 480, 640), (40, 32, 640, 640), (16, 2601, 640, 640)]


@pytest.mark.parametrize("n,l,cin,cout", TF32_SHAPES)
def test_conv8_tf32x3_holds_float64_and_repeats_bit_for_bit(cuda, n, l, cin, cout):
    """Three TF32 passes within 1e-5 of max|y| of a float64 product of the
    same inputs, where one pass (x and W rounded to TF32) misses; a second
    launch gives the same bits (the parts of a split K summed in order)."""
    x, w, b = _inputs(n, l, cin, cout, n + l, cuda, torch.float32)
    got = conv8_relu(x, w, b)
    assert torch.equal(got, conv8_relu(x, w, b))
    want = conv8_relu_plain(x.double(), w.double(), b.double())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    from expecto_tpu_torch.ops.fc1 import split_tf32

    one_pass = conv8_relu_plain(split_tf32(x)[0].double(), split_tf32(w)[0].double(), b.double())
    assert float((one_pass - want).abs().max()) > 1e-5 * scale


def test_conv8_tc_weights_repacked_after_an_in_place_write(cuda):
    x, w, b = _inputs(2, 30, 32, 160, 4, cuda, torch.bfloat16)
    first = conv8_relu(x, w, b)
    w.mul_(-1)
    torch.testing.assert_close(conv8_relu(x, w, b).float(), conv8_relu_plain(x.float(), w.float(), b.float()),
                               rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    assert not torch.equal(first, conv8_relu(x, w, b))


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


# the pooled convs of the flows: serving span conv1 and conv3, the serving
# and consensus patch sub-spans, the per-window 2,000 bp; then tile edges
# (N*L just past the tc kernel's 124-row steps and the SIMT kernel's 128-
# and 64-row tiles, spans shorter than a tile, a span with no pool frame,
# Cout off the 16-byte pieces and off the 160 tile, an odd Cout)
POOL_SHAPES = [(227, 3593, 320, 320, (0,)), (227, 889, 480, 480, (0, 2)), (227, 607, 320, 320, (0,)),
               (227, 143, 480, 480, (0, 2)), (40, 697, 320, 320, (0,)), (40, 165, 480, 480, (0, 2)),
               (64, 1993, 320, 320, (0,)), (64, 489, 480, 480, (0,)),
               (1, 125, 16, 32, (0, 1, 2, 3)), (1, 61, 32, 40, (1, 3)), (1, 129, 16, 32, (0, 1, 2, 3)),
               (1, 65, 32, 40, (1, 3)), (5, 26, 16, 161, (0, 2)), (3, 9, 16, 20, (0, 3)), (7, 37, 48, 168, (0, 1, 2, 3)),
               (2, 8, 16, 32, (0, 1)), (9, 71, 16, 33, (0, 1, 2, 3))]


@pytest.mark.parametrize("route,dtype", FLAT_ROUTES[:3], ids=FLAT_IDS[:3])
@pytest.mark.parametrize("n,l,cin,cout,phases", POOL_SHAPES)
def test_conv8_pool4_equals_the_kernel_then_the_pool(cuda, n, l, cin, cout, phases, route, dtype):
    """The flows' routes (tc-bf16, tf32x3-fp32) and the SIMT kernel forced
    on fp32."""
    x, w, b = _inputs(n, l, cin, cout, n + l + cin + cout, cuda, dtype)
    assert conv8._route("cuda", dtype, cin, x.data_ptr()) == ("tf32x3" if route == "simt" else route)
    reset_launch_counts()
    got = conv8_relu_pool4(x, w, b, phases, route=route)
    torch.cuda.synchronize()
    live = any(t.shape[1] for t in got.values())
    assert conv8_relu_pool4.launches_by_route == {r: int(live and r == route) for r in conv8.ROUTES}
    assert conv8_relu.launches_by_route == conv8_relu_pool4.launches_by_route
    y = conv8_relu(x, w, b, route=route)
    want = conv8_relu_pool4_plain(x.float(), w.float(), b.float(), phases)
    assert sorted(got) == sorted(phases)
    for ph in phases:
        assert got[ph].is_contiguous() and got[ph].data_ptr() % 16 == 0 and got[ph].dtype == dtype
        assert torch.equal(got[ph], _pool4_from(y, ph)), ph
        torch.testing.assert_close(got[ph].float(), want[ph], rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("route,dtype", FLAT_ROUTES[:3], ids=FLAT_IDS[:3])
def test_conv8_pool4_bit_equal_on_a_second_stream(cuda, route, dtype):
    """The SIMT route merges groups across tile edges by atomic max (any
    order gives the same max); the tc and tf32x3 routes own whole groups. A
    repeat of each route on another stream, into a buffer the first call
    did not leave zeroed, gives the same bits."""
    x, w, b = _inputs(227, 889, 480, 480, 5, cuda, dtype)
    first = conv8_relu_pool4(x, w, b, (0, 2), route=route)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.full((227, 220, 480), 7.0, device=cuda, dtype=dtype)  # a freed block of nonzero bytes to reuse
        again = conv8_relu_pool4(x, w, b, (0, 2), route=route)
    torch.cuda.synchronize()
    for ph in (0, 2):
        assert torch.equal(first[ph], again[ph])


def test_conv8_pool4_refuses_bf16_off_the_tc_rule_and_bad_input(cuda):
    """The SIMT kernel pools fp32 alone: bf16 off the tc rule (a misaligned
    view, Cin % 16 != 0) raises and launches nothing."""
    x, w, b = _inputs(2, 30, 320, 320, 9, cuda, torch.bfloat16)
    buf = torch.empty(x.numel() + 8, device=cuda, dtype=torch.bfloat16)
    view = buf[1 : 1 + x.numel()].view(x.shape)
    view.copy_(x)
    x24, w24, b24 = _inputs(2, 30, 24, 24, 9, cuda, torch.bfloat16)
    reset_launch_counts()
    for args in ((view, w, b), (x24, w24, b24)):
        with pytest.raises(ValueError, match="only on the tc kernel"):
            conv8_relu_pool4(*args, (0, 1))
    assert conv8_relu.launches == 0 and conv8_relu_pool4.launches == 0
    with pytest.raises(ValueError, match="pool phases"):
        conv8_relu_pool4(x, w, b, (0, 4))
    with pytest.raises(ValueError, match="contiguous"):
        conv8_relu_pool4(x.transpose(0, 1).contiguous().transpose(0, 1), w, b, (0,))


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

    before, before0 = conv8_relu.launches, conv0_codes_relu.launches_by_kind["float32"]
    got = BelugaRunner(params, batch_size=16, device="cuda").score_variant_spans_packed_rows(*args)
    assert conv8_relu.launches > before
    assert conv0_codes_relu.launches_by_kind["float32"] > before0
    want = BelugaRunner(params, batch_size=16, device="cpu").score_variant_spans_packed_rows(*args)
    for name, g, w_ in zip(("REF", "ALT", "SED"), got, want):
        atol = sed_atol(want[0]) if name == "SED" else 1e-5
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=atol, err_msg=name)


# ---- conv0 over int8 codes -------------------------------------------------

# kernel vs plain on the same inputs. fp32: 8 table entries and the bias
# summed in another order. bf16: one rounding of the output (relative step
# 2^-8); the reference is the fp32 plain version on the same bf16 weights.
CONV0_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}

# the shortest inputs (L 8, 9), a ragged L, the patch sub-span (614, 622) and
# the serving span (3,600); Beluga's Cout 320, Cout 48 (6 channel groups, a
# wider block of positions) and Cout 1 (a partial group: scalar stores); and
# a serving chunk's 227 spans
CONV0_SHAPES = ([(3, l, cout) for l in (8, 9, 13, 614, 622, 3600) for cout in (320, 48, 1)]
                + [(1, 8, 320), (1, 9, 48), (227, 614, 320), (227, 622, 320), (227, 3600, 320)])


def _conv0_inputs(n, l, cout, seed, device, dtype):
    """Codes 0..4 with N runs and codes outside 0..4; He-scaled W0 and b."""
    rng = np.random.default_rng(seed)
    codes = random_codes(rng, n, l, n_frac=0.03)
    codes[:, l // 2 : l // 2 + 6] = 4
    odd = rng.random((n, l)) < 0.02
    codes[odd] = rng.choice(np.array([-128, -2, -1, 5, 17, 127], np.int8), odd.sum())
    w = (rng.standard_normal((8, 4, cout)) / np.sqrt(32)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(w).to(device=device, dtype=dtype), torch.from_numpy(b).to(device=device, dtype=dtype))


def _assert_conv0_matches_plain(got, codes, w, b):
    n, l = codes.shape
    assert got.shape == (n, l - 7, w.shape[2]) and got.dtype == w.dtype and got.device.type == "cuda"
    atol, rtol = CONV0_TOL[w.dtype]
    torch.testing.assert_close(got.float(), conv0_codes_relu_plain(codes, w.float(), b.float()), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,l,cout", CONV0_SHAPES)
def test_conv0_kernel_matches_plain(cuda, n, l, cout, dtype):
    codes, w, b = _conv0_inputs(n, l, cout, n + l + cout, cuda, dtype)
    before = conv0_codes_relu.launches
    got = conv0_codes_relu(codes, w, b)
    torch.cuda.synchronize()
    assert conv0_codes_relu.launches == before + 1
    _assert_conv0_matches_plain(got, codes, w, b)


@pytest.mark.parametrize("offset", [1, 3, 15])
def test_conv0_kernel_on_misaligned_and_strided_codes(cuda, offset):
    """A contiguous view whose data pointer is off a 16-byte boundary (byte
    loads at each tile's head), and a strided view (copied by the wrapper)."""
    codes, w, b = _conv0_inputs(5, 622, 320, offset, cuda, torch.bfloat16)
    buf = torch.full((codes.numel() + 64,), 4, dtype=torch.int8, device=cuda)
    view = buf[offset : offset + codes.numel()].view(codes.shape)
    view.copy_(codes)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    want = conv0_codes_relu(codes, w, b)
    torch.testing.assert_close(conv0_codes_relu(view, w, b), want, rtol=0, atol=0)
    pairs = torch.stack([codes, conv0.rc_codes(codes)], dim=1)  # the runner's (ref, alt) interleave
    torch.testing.assert_close(conv0_codes_relu(pairs[:, 0], w, b), want, rtol=0, atol=0)
    torch.cuda.synchronize()
    _assert_conv0_matches_plain(want, codes, w, b)


def test_conv0_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    codes, w, b = _conv0_inputs(2, 32, 16, 0, cuda, torch.float32)
    before = conv0_codes_relu.launches
    with pytest.raises(TypeError):
        conv0_codes_relu(codes.long(), w, b)
    with pytest.raises(TypeError):
        conv0_codes_relu(codes.float(), w, b)
    with pytest.raises(TypeError):
        conv0_codes_relu(codes, w.half(), b.half())
    with pytest.raises(TypeError):
        conv0_codes_relu(codes, w, b.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        conv0_codes_relu(codes, w.cpu(), b)
    with pytest.raises(ValueError):
        conv0_codes_relu(codes, torch.zeros((8, 5, 16), device=cuda), b)
    with pytest.raises(ValueError, match="contiguous"):
        conv0_codes_relu(codes, torch.zeros((8, 4, 32), device=cuda)[:, :, ::2], b)
    with pytest.raises(ValueError, match="shorter"):
        conv0_codes_relu(codes[:, :7], w, b)
    with pytest.raises(ValueError, match="Cout"):
        conv0_codes_relu(codes, torch.zeros((8, 4, 520), device=cuda), torch.zeros(520, device=cuda))
    assert conv0_codes_relu.launches == before


def test_bf16_runner_launches_conv0_on_codes_and_no_conv8_at_cin_4(cuda):
    """A bf16 serving call: every conv0 on the code-gather kernel, and no
    conv8_relu launch at Cin 4 (no float one-hot reached the card)."""
    maxshift = 400
    offsets = tuple(s + maxshift for s in variant_shifts(maxshift))
    mutpos = maxshift + 999
    rng = np.random.default_rng(6)
    spans = random_codes(rng, 3, 2 * maxshift + 2000)
    alt = ((spans[:, mutpos : mutpos + 1] + 1) % 4).astype(np.int8)
    basis = rng.random((len(offsets), 3, 10)).astype(np.float32)
    W = (rng.standard_normal((10 * 2002, 2)) * 0.05).astype(np.float32)
    runner = BelugaRunner(narrow_params(3, convs=TC_WIDTHS), batch_size=16, device="cuda",
                          compute_dtype=torch.bfloat16, out_dtype=np.float16)
    reset_launch_counts()
    conv0.reset_launch_counts()
    runner.score_variant_spans_packed(spans, mutpos, alt, offsets, basis, W, np.zeros(2, np.float32))
    runner.predict_codes(spans[:, :2000], average_rc=True)
    torch.cuda.synchronize()
    # the packed route runs 4 conv stacks (ref and alt patch, each forward
    # and reverse complement) per chunk; predict_codes 2
    assert conv0_codes_relu.launches == 6
    assert conv0_codes_relu.launches_by_kind == {"bfloat16": 6}
    assert conv8_relu.launches > 0
    assert not [k for k in conv8_relu.launches_by_kind if k[2] == 4]


# ---- h5-contract runner methods ---------------------------------------------

H5_MAXSHIFT = 400
H5_OFFSETS = tuple(s + H5_MAXSHIFT for s in variant_shifts(H5_MAXSHIFT))
H5_SPAN = 2 * H5_MAXSHIFT + 2000
# every Cin of conv1-conv5 a multiple of 16, so bf16 takes the tc kernel at
# each of them, as at Beluga's widths
TC_WIDTHS = [(4, 16), (16, 16), (16, 32), (32, 32), (32, 48), (48, 48)]


def _h5_pairs(n, seed):
    rng = np.random.default_rng(seed)
    ref = random_codes(rng, n, H5_SPAN)
    alt = ref.copy()
    mut = H5_MAXSHIFT + 999
    alt[:, mut:] = np.roll(ref[:, mut:], 2, axis=1)  # an insertion-like shifted tail
    alt[:, mut : mut + 2] = rng.integers(0, 4, (n, 2))
    return ref, alt


@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
def test_h5_runner_methods_fp32_on_card_match_cpu(cuda, budget):
    """fp32 on the card against fp32 on the CPU, rtol 1e-4 atol 1e-5 (as the
    serving runner); budget 0 sends every chunk that holds an N down the
    N-dense route."""
    params = narrow_params(7)
    card = BelugaRunner(params, batch_size=16, device="cuda")
    cpu = BelugaRunner(params, batch_size=16, device="cpu")
    if budget is not None:
        card.PACK2_SIDE_BUDGET = cpu.PACK2_SIDE_BUDGET = budget
    ref, alt = _h5_pairs(3, seed=8)
    for rc_mode in ("none", "average", "concat"):
        np.testing.assert_allclose(card.predict_span_codes(ref, H5_OFFSETS, rc_mode=rc_mode),
                                   cpu.predict_span_codes(ref, H5_OFFSETS, rc_mode=rc_mode), rtol=1e-4, atol=1e-5)
    got, want = card.predict_span_pairs_diff(ref, alt, H5_OFFSETS), cpu.predict_span_pairs_diff(ref, alt, H5_OFFSETS)
    for name, g, w_ in zip(("ref", "alt", "diff"), got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[1], got[0] + got[2])
    diff = card.predict_span_pair_diffs_only(ref, alt, H5_OFFSETS)
    np.testing.assert_allclose(diff, want[2], rtol=1e-4, atol=1e-5)


def test_h5_runner_sinks_on_card(cuda):
    """The sinks get every chunk once, in any order (the fetch workers call
    them), fp32 (real, 2, S, M), and rebuild the arrays the sink-less calls
    return."""
    runner = BelugaRunner(narrow_params(9), batch_size=16, device="cuda")
    ref, alt = _h5_pairs(3, seed=10)
    calls, parts, diffs = [], {}, {}

    def sink(start, real, r, a, d):
        calls.append((start, real))
        assert r.dtype == a.dtype == d.dtype == np.float32 and r.shape == (real, 2, len(H5_OFFSETS), 2002)
        parts[start] = (r, a, d)

    assert runner.predict_span_pairs_diff(ref, alt, H5_OFFSETS, sink=sink) is None
    assert runner.predict_span_pair_diffs_only(ref, alt, H5_OFFSETS, sink=lambda s, n, d: diffs.update({s: d})) is None
    assert sorted(calls) == [(0, 1), (1, 1), (2, 1)]
    whole = runner.predict_span_pairs_diff(ref, alt, H5_OFFSETS)
    for k in range(3):
        a = np.concatenate([parts[s][k] for s in sorted(parts)])
        np.testing.assert_array_equal(np.concatenate([a[:, 0], a[:, 1]]), whole[k])
    d = np.concatenate([diffs[s] for s in sorted(diffs)])
    np.testing.assert_array_equal(np.concatenate([d[:, 0], d[:, 1]]), whole[2])


@pytest.mark.parametrize("budget", [None, 0], ids=["pack2", "dense"])
def test_h5_runner_bf16_fp16_wire_on_card(cuda, budget):
    """bf16 compute, fp16 wire: finite, alt = ref + diff exactly on the
    host, diff as the device differenced it in fp32 (the diff-only wire
    carries the same values), and close to fp32 on the CPU (bf16
    activations: about 3 significant digits)."""
    params = narrow_params(11, convs=TC_WIDTHS)
    runner = BelugaRunner(params, batch_size=16, device="cuda", compute_dtype=torch.bfloat16, out_dtype=np.float16)
    if budget is not None:
        runner.PACK2_SIDE_BUDGET = budget
    ref, alt = _h5_pairs(3, seed=12)
    R, A, D = runner.predict_span_pairs_diff(ref, alt, H5_OFFSETS)
    assert np.isfinite(R).all() and np.isfinite(D).all()
    np.testing.assert_array_equal(A, R + D)
    np.testing.assert_array_equal(D, runner.predict_span_pair_diffs_only(ref, alt, H5_OFFSETS))
    R32, _A32, D32 = BelugaRunner(params, batch_size=16, device="cpu").predict_span_pairs_diff(ref, alt, H5_OFFSETS)
    np.testing.assert_allclose(R, R32, rtol=0, atol=3e-2)
    np.testing.assert_allclose(D, D32, rtol=0, atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_h5_runner_launch_counts(cuda, dtype):
    """Per pair chunk: ref and alt in one batch, 2 orientations x (1 conv0 +
    conv1-conv3 once + conv4/conv5 per pool-2 phase {0, 2}). fp32 runs
    conv1-conv5 on the tf32x3 kernel, bf16 on the tc kernel, none on
    another route; conv0 on the code-gather kernel in the compute dtype."""
    runner = BelugaRunner(narrow_params(13, convs=TC_WIDTHS), batch_size=16, device="cuda", compute_dtype=dtype,
                          out_dtype=np.float32 if dtype == torch.float32 else np.float16)
    ref, alt = _h5_pairs(3, seed=14)
    reset_launch_counts()
    conv0.reset_launch_counts()
    runner.predict_span_pairs_diff(ref, alt, H5_OFFSETS)
    torch.cuda.synchronize()
    chunks = 3  # one pair a chunk at batch_size 16 and 5 offsets
    kind = "float32" if dtype == torch.float32 else "bfloat16"
    assert conv0_codes_relu.launches_by_kind == {kind: 2 * chunks}
    assert conv8_relu.launches == 2 * 7 * chunks
    route = "tf32x3" if dtype == torch.float32 else "tc"
    assert conv8_relu.launches_by_route == {r: 2 * 7 * chunks * (r == route) for r in conv8.ROUTES}


# ---- gene features ------------------------------------------------------------

GENE_SPAN = 41_800
GENE_POS_WEIGHTS = gene_pos_weights(gene_shifts())
# window offsets of the 200 gene shifts in a 41,800-bp span: upward on the
# plus strand, downward on the minus strand
GENE_OFFSETS = {"plus": tuple(range(0, 39_801, 200)), "minus": tuple(range(39_800, -1, -200))}
# every conv8_relu shape of a gene chunk at Beluga's widths (16 spans:
# conv1 at 41,793, conv2/conv3 after pool-1, conv4/conv5 at pool-2 phases 0
# and 2)
GENE_CONV8_SHAPES = [(16, 41_793, 320, 320), (16, 10_446, 320, 480), (16, 10_439, 480, 480), (16, 2_608, 480, 640),
                     (16, 2_607, 480, 640), (16, 2_601, 640, 640), (16, 2_600, 640, 640)]


@pytest.mark.parametrize("route,dtype", FLAT_ROUTES[:3], ids=FLAT_IDS[:3])
@pytest.mark.parametrize("n,l,cin,cout", GENE_CONV8_SHAPES)
def test_conv8_kernels_at_gene_chunk_shapes(cuda, n, l, cin, cout, route, dtype):
    gen = torch.Generator(device=cuda).manual_seed(l + cin)
    x = torch.randn((n, l, cin), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((8, cin, cout), generator=gen, device=cuda) / (8 * cin) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=gen, device=cuda) * 0.1).to(dtype)
    _assert_route_matches_plain(x, w, b, route)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv0_kernel_at_the_gene_chunk_shape(cuda, dtype):
    codes, w, b = _conv0_inputs(16, GENE_SPAN, 320, 16, cuda, dtype)
    _assert_conv0_matches_plain(conv0_codes_relu(codes, w, b), codes, w, b)


def _gene_spans(n, seed, n_frac=0.02):
    return random_codes(np.random.default_rng(seed), n, GENE_SPAN, n_frac=n_frac)


def _feat_tol(want):
    """fp32 features: sums of up to 200 weighted track probabilities, so
    the limit scales with them, 1e-5 * max|feature|."""
    return 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("strand", ["plus", "minus"])
def test_gene_features_span_path_matches_windows_and_cpu(cuda, strand):
    """predict_spans_project on the card (fp32) against predict_and_project
    on the card (the same windows, one at a time) and against the CPU; 3
    spans at batch 400 are two chunks."""
    offsets = GENE_OFFSETS[strand]
    params = narrow_params(15)
    card = BelugaRunner(params, batch_size=400, device="cuda")
    spans = _gene_spans(3, seed=16)
    got = card.predict_spans_project(spans, offsets, GENE_POS_WEIGHTS)
    assert got.shape == (3, 20020) and got.dtype == np.float32 and np.isfinite(got).all()
    windows = np.stack([s[o : o + 2000] for s in spans for o in offsets])
    per_window = card.predict_and_project(windows, GENE_POS_WEIGHTS, len(offsets))
    np.testing.assert_allclose(got, per_window, rtol=0, atol=_feat_tol(per_window))
    cpu = BelugaRunner(params, batch_size=400, device="cpu").predict_spans_project(spans, offsets, GENE_POS_WEIGHTS)
    np.testing.assert_allclose(got, cpu, rtol=0, atol=_feat_tol(cpu))


def test_gene_features_n_dense_chunk_on_the_4bit_route(cuda):
    """A contig-edge-like chunk (the first 19,000 bases N) passes the 2-bit
    wire's N budget and ships 4 bits a base; with the budget raised it ships
    2 bits and the sideband. Same codes on the card, the same features; and
    the CPU's."""
    params = narrow_params(17)
    card = BelugaRunner(params, batch_size=400, device="cuda")
    spans = _gene_spans(2, seed=18)
    spans[0, :19_000] = 4
    offsets = GENE_OFFSETS["plus"]
    assert card._span_rows(200) == 2 and card._chunk_wire(spans)[0] == 4  # one chunk of both spans
    dense = card.predict_spans_project(spans, offsets, GENE_POS_WEIGHTS)
    card.PACK2_SIDE_BUDGET = 10**6
    assert card._chunk_wire(spans)[0] == 2
    np.testing.assert_array_equal(card.predict_spans_project(spans, offsets, GENE_POS_WEIGHTS), dense)
    cpu = BelugaRunner(params, batch_size=400, device="cpu").predict_spans_project(spans, offsets, GENE_POS_WEIGHTS)
    np.testing.assert_allclose(dense, cpu, rtol=0, atol=_feat_tol(cpu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gene_features_launch_counts(cuda, dtype):
    """Per gene chunk 16 launches: 2 orientations x (1 conv0 + conv1-conv3
    once + conv4/conv5 at pool-2 phases 0 and 2); fp32 conv1-conv5 on the
    tf32x3 kernel, bf16 on the tc kernel, none on another route; conv0 on
    the code-gather kernel."""
    runner = BelugaRunner(narrow_params(19, convs=TC_WIDTHS), batch_size=400, device="cuda", compute_dtype=dtype,
                          out_dtype=np.float32 if dtype == torch.float32 else np.float16)
    spans = _gene_spans(5, seed=20)
    reset_launch_counts()
    conv0.reset_launch_counts()
    feats = runner.predict_spans_project(spans, GENE_OFFSETS["minus"], GENE_POS_WEIGHTS)
    torch.cuda.synchronize()
    assert np.isfinite(feats).all()
    chunks = 3  # 2 spans a chunk at batch 400 and 200 offsets
    kind = "float32" if dtype == torch.float32 else "bfloat16"
    assert conv0_codes_relu.launches_by_kind == {kind: 2 * chunks}
    route = "tf32x3" if dtype == torch.float32 else "tc"
    assert conv8_relu.launches_by_route == {r: 14 * chunks * (r == route) for r in conv8.ROUTES}


# ---- consensus: backbone patching ------------------------------------------------

CONS_SPAN = 41_808  # the 200-shift span, extended to a multiple of 16
CONS_OFFSETS = {"plus": tuple(range(0, 39_801, 200)), "minus": tuple(range(39_800, -1, -200))}
# conv1-conv5 of the backbone forward (N = 1) and of the patch batches of
# 704-base sub-spans (N·K = 5·8 and 16·24): conv1, conv2/conv3 after
# pool-1, conv4/conv5 at pool-2 phases 0 and 2 (equal lengths here)
CONS_CONV8_SHAPES = ([(1, 41_801, 320, 320), (1, 10_448, 320, 480), (1, 10_441, 480, 480), (1, 2_608, 480, 640),
                      (1, 2_601, 640, 640)]
                     + [(nk, l, cin, cout) for nk in (40, 384) for l, cin, cout in
                        ((697, 320, 320), (172, 320, 480), (165, 480, 480), (39, 480, 640), (32, 640, 640))])


@pytest.mark.parametrize("route,dtype", FLAT_ROUTES[:3], ids=FLAT_IDS[:3])
@pytest.mark.parametrize("n,l,cin,cout", CONS_CONV8_SHAPES)
def test_conv8_kernels_at_consensus_shapes(cuda, n, l, cin, cout, route, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + l + cin)
    x = torch.randn((n, l, cin), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((8, cin, cout), generator=gen, device=cuda) / (8 * cin) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=gen, device=cuda) * 0.1).to(dtype)
    _assert_route_matches_plain(x, w, b, route)


@pytest.mark.parametrize("n,l", [(1, CONS_SPAN), (40, 704), (384, 704)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv0_kernel_at_consensus_shapes(cuda, n, l, dtype):
    codes, w, b = _conv0_inputs(n, l, 320, n + l, cuda, dtype)
    _assert_conv0_matches_plain(conv0_codes_relu(codes, w, b), codes, w, b)


def _cohort(n, seed, sites_per_sample=(1, 3, 12, 0, 2)):
    """A backbone span of CONS_SPAN codes and ``n`` samples differing from it
    at a few private sites each (one sample with none)."""
    rng = np.random.default_rng(seed)
    bb = random_codes(rng, 1, CONS_SPAN, n_frac=0.001)[0]
    samples = np.stack([bb] * n)
    for i in range(n):
        k = sites_per_sample[i % len(sites_per_sample)]
        sites = rng.choice(CONS_SPAN, size=k, replace=False)
        samples[i, sites] = (samples[i, sites] + 1) % 4
    return bb, samples


def _plans(bb, samples, offsets):
    """(N, K, 2) forward and reverse-complement range starts, K = 16."""
    phases_f = {(o // 4) % 4 for o in offsets}
    phases_r = {((CONS_SPAN - 2000 - o) // 4) % 4 for o in offsets}
    sf, sr = (np.zeros((len(samples), 16, 2), np.int32) for _ in range(2))
    for m, row in enumerate(samples):
        dp = np.nonzero(row != bb)[0]
        pf = conv6_patch_sites_plan(dp, CONS_SPAN, phases_f, max_ranges=16)
        pr = conv6_patch_sites_plan((CONS_SPAN - 1 - dp)[::-1], CONS_SPAN, phases_r, max_ranges=16)
        if pf:
            sf[m, : len(pf)] = pf
        if pr:
            sr[m, : len(pr)] = pr
    return sf, sr


def test_patch_sites_on_card_match_full_forward_and_cpu(cuda):
    """conv6_phases_patch_sites on the card (fp32) against the full conv6
    phases of the samples on the card and against the same patch on the
    CPU; two calls give equal bits; the backbone buffers are not written."""
    from expecto_tpu_torch.models.convert import params_from_jax

    params = narrow_params(23)
    bb, samples = _cohort(5, seed=24)
    sf, _sr = _plans(bb, samples, CONS_OFFSETS["plus"])
    phases = {0, 2}
    out = {}
    for dev in ("cuda", "cpu"):
        p = params_from_jax(params, device=dev, dtype=torch.float32)
        base = conv6_phases(p, torch.from_numpy(bb[None]).to(dev), phases)
        before = {ph: t.clone() for ph, t in base.items()}
        x, st = torch.from_numpy(samples).to(dev), torch.from_numpy(sf[..., 0]).to(dev)
        out[dev] = conv6_phases_patch_sites(p, base, x, st, phases)
        if dev == "cuda":
            again = conv6_phases_patch_sites(p, base, x, st, phases)
            full = conv6_phases(p, x, phases)
            for ph in phases:
                assert torch.equal(again[ph], out[dev][ph]) and torch.equal(base[ph], before[ph])
                torch.testing.assert_close(out[dev][ph], full[ph], rtol=1e-5, atol=1e-5)
    for ph in phases:
        torch.testing.assert_close(out["cuda"][ph].cpu(), out["cpu"][ph], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strand", ["plus", "minus"])
def test_backbone_patch_projection_matches_span_path_and_cpu(cuda, strand):
    """project_spans_backbone_patch on the card (fp32, 5 samples at batch
    400: three chunks) against predict_spans_project on the card and the
    patch on the CPU; a second call gives equal bits."""
    offsets = CONS_OFFSETS[strand]
    params = narrow_params(25)
    bb, samples = _cohort(5, seed=26)
    sf, sr = _plans(bb, samples, offsets)
    card = BelugaRunner(params, batch_size=400, device="cuda")
    got = card.project_spans_backbone_patch(bb, samples, sf, sr, offsets, GENE_POS_WEIGHTS)
    assert got.shape == (5, 20020) and got.dtype == np.float32 and np.isfinite(got).all()
    span = card.predict_spans_project(samples, offsets, GENE_POS_WEIGHTS)
    np.testing.assert_allclose(got, span, rtol=0, atol=_feat_tol(span))
    np.testing.assert_array_equal(card.project_spans_backbone_patch(bb, samples, sf, sr, offsets, GENE_POS_WEIGHTS),
                                  got)
    cpu = BelugaRunner(params, batch_size=400, device="cpu").project_spans_backbone_patch(
        bb, samples, sf, sr, offsets, GENE_POS_WEIGHTS)
    np.testing.assert_allclose(got, cpu, rtol=0, atol=_feat_tol(cpu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backbone_patch_launch_counts(cuda, dtype):
    """The backbone forward once (16 launches), then 16 a chunk of samples:
    2 orientations x (1 conv0 + conv1-conv3 + conv4/conv5 at phases 0 and
    2) over the chunk's (rows·K, 704) sub-spans; each dtype on its route."""
    runner = BelugaRunner(narrow_params(27, convs=TC_WIDTHS), batch_size=400, device="cuda", compute_dtype=dtype,
                          out_dtype=np.float32 if dtype == torch.float32 else np.float16)
    bb, samples = _cohort(5, seed=28)
    sf, sr = _plans(bb, samples, CONS_OFFSETS["plus"])
    reset_launch_counts()
    conv0.reset_launch_counts()
    feats = runner.project_spans_backbone_patch(bb, samples, sf, sr, CONS_OFFSETS["plus"], GENE_POS_WEIGHTS)
    torch.cuda.synchronize()
    assert np.isfinite(feats).all()
    calls = 1 + 3  # the backbone, then 3 chunks of 2 samples
    kind = "float32" if dtype == torch.float32 else "bfloat16"
    assert conv0_codes_relu.launches_by_kind == {kind: 2 * calls}
    route = "tf32x3" if dtype == torch.float32 else "tc"
    assert conv8_relu.launches_by_route == {r: 14 * calls * (r == route) for r in conv8.ROUTES}


# ---- gblinear training -----------------------------------------------------


def _cd_inputs(b: int, k: int, alpha: float, seed: int):
    """(g, h, w) of shape (b, k) on the card: hessians around the 1e-5 guard
    and zero (the padded rows of a last block), ties tmp == 0 (g = w = 0),
    and gradients at +-alpha (gl2 -+ alpha == 0)."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(b, k)) * 30).astype(np.float32)
    h = (rng.random((b, k)) * 50 + 1e-3).astype(np.float32)
    w = (rng.normal(size=(b, k)) * 0.05).astype(np.float32)
    h[:6] = np.array([0.0, 5e-6, 9.99e-6, 1e-5, 1.01e-5, 2e-5], np.float32)[:, None]
    h[-36:] = 0.0
    g[8:16], w[8:16] = 0.0, 0.0
    g[16:24], w[16:24] = alpha, 0.0
    g[24:32], w[24:32] = -alpha, 0.0
    return tuple(torch.from_numpy(a).cuda() for a in (g, h, w))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("alpha", [0.0, 0.7, 25.0])
@pytest.mark.parametrize("k", [1, 128, 218])
def test_gblinear_cd_kernel_equals_plain_bit_for_bit(cuda, k, alpha):
    g, h, w = _cd_inputs(512, k, alpha, seed=k)
    w_plain = w.clone()
    before = gblinear_cd.coord_update.launches
    dw = gblinear_cd.coord_update(g, h, w, 0.01, 100.0, alpha)
    want = gblinear_cd.coord_update_plain(g, h, w_plain, 0.01, 100.0, alpha)
    torch.cuda.synchronize()
    assert gblinear_cd.coord_update.launches == before + 1
    assert torch.equal(_bits(dw), _bits(want)) and torch.equal(_bits(w), _bits(w_plain))
    assert (dw[h < 1e-5] == 0).all() and (dw[-36:] == 0).all()


def test_gblinear_cd_wrapper_checks_on_cuda(cuda):
    g, h, w = _cd_inputs(512, 8, 0.0, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        gblinear_cd.coord_update(g.t(), h.t(), w.t(), 0.01, 100.0, 0.0)
    with pytest.raises(ValueError, match="one device"):
        gblinear_cd.coord_update(g.cpu(), h, w, 0.01, 100.0, 0.0)
    with pytest.raises(TypeError, match="fp32"):
        gblinear_cd.coord_update(g.half(), h, w, 0.01, 100.0, 0.0)


def _round_state(n: int, f: int, b: int, seed: int):
    """The round's inputs on the card: a standard-normal (n, f) X padded to
    blocks of b (the last block padded when b does not divide f), its
    column hessians, zero weights and bias, and r = base_score - y for
    labels from a sparse linear model."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (2.0 + X @ np.where(rng.random(f) < 0.05, rng.normal(size=f), 0.0) + rng.normal(size=n) * 0.3)
    Xt, n_blocks = gblinear._pad_blocks(torch.from_numpy(X).cuda().T, b)
    hess = torch.stack([Xb.double().square().sum(1) for Xb in Xt]).float()
    w = torch.zeros((n_blocks, b), device="cuda")
    r = torch.from_numpy((2.0 - y).astype(np.float32)).cuda()
    return Xt, hess, w, torch.zeros(1, device="cuda"), r


def _run_rounds(state, rounds: int, alpha: float, round_fn):
    """``rounds`` rounds of ``round_fn`` on copies of ``state`` (eta 0.01,
    lambda 100, lambda_bias 2): the final weights, bias and the training
    RMSE after each round (sqrt(mean(r^2)): r is the residual)."""
    Xt, hess, w, bias, r = state
    w, bias, r = w.clone(), bias.clone(), r.clone()
    scratch, history = gr.round_scratch(Xt), []
    denom = float(np.float32(r.numel()) + np.float32(2.0))
    for _ in range(rounds):
        round_fn(Xt, hess, w, bias, r, scratch, denom, 0.01, 100.0, alpha)
        history.append(r.square().mean().sqrt())
    torch.cuda.synchronize()
    return w.cpu().numpy(), float(bias), torch.stack(history).cpu().numpy()


def _round_gaps(got, want) -> tuple[float, float, float]:
    """Weights over max|w|, bias and RMSE history: the card-vs-CPU limits
    are 1e-5, 1e-6 and 1e-5."""
    return (float(np.abs(got[0] - want[0]).max() / np.abs(want[0]).max()), abs(got[1] - want[1]),
            float(np.abs(got[2] - want[2]).max()))


@pytest.mark.parametrize("rounds", [1, 30])
@pytest.mark.parametrize("alpha", [0.0, 5.0])
@pytest.mark.parametrize("b", [16, 512])
@pytest.mark.parametrize("n", [2000, 2001])
def test_gblinear_round_kernel_matches_plain(cuda, n, b, alpha, rounds):
    state = _round_state(n, 1100, b, seed=n + b)
    gr.reset_launch_counts()
    got = _run_rounds(state, rounds, alpha, gr.gblinear_round)
    assert gr.gblinear_round.launches == rounds
    again = _run_rounds(state, rounds, alpha, gr.gblinear_round)
    for a, z in zip(got, again):
        np.testing.assert_array_equal(a, z)  # deterministic: fixed reduction orders
    want = _run_rounds(state, rounds, alpha, gr.gblinear_round_plain)
    w_gap, b_gap, h_gap = _round_gaps(got, want)
    assert w_gap <= 1e-5 and b_gap <= 1e-6 and h_gap <= 1e-5, (w_gap, b_gap, h_gap)
    assert (got[0].reshape(-1)[1100:] == 0).all()


def test_gblinear_round_stale_residual_fault_misses_the_limits(cuda):
    state = _round_state(2001, 1100, 512, seed=3)
    kernel = _run_rounds(state, 30, 0.0, gr.gblinear_round)
    w_gap, b_gap, h_gap = _round_gaps(_run_rounds(state, 30, 0.0, stale_residual_round), kernel)
    assert w_gap > 1e-5 and h_gap > 1e-5, (w_gap, b_gap, h_gap)


def test_gblinear_round_wrapper_checks_on_cuda(cuda):
    Xt, hess, w, bias, r = _round_state(300, 100, 64, seed=1)
    with pytest.raises(ValueError, match="scratch"):
        gr.gblinear_round(Xt, hess, w, bias, r, None, 300.0, 0.01, 100.0, 0.0)
    with pytest.raises(ValueError, match="scratch"):
        gr.gblinear_round(Xt, hess, w, bias, r, gr.round_scratch(Xt)[:10], 300.0, 0.01, 100.0, 0.0)
    with pytest.raises(ValueError, match="one device"):
        gr.gblinear_round(Xt, hess, w, bias, r.cpu(), gr.round_scratch(Xt), 300.0, 0.01, 100.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        gr.gblinear_round(Xt.transpose(1, 2).contiguous().transpose(1, 2), hess, w, bias, r, gr.round_scratch(Xt),
                          300.0, 0.01, 100.0, 0.0)
    assert gr.round_ctas(0, 300, 64) == torch.cuda.get_device_properties(0).multi_processor_count


@pytest.fixture(scope="module")
def train_problem():
    """n 2,000 rows, F 1,100 features (three blocks of 512, the last one
    padded), labels from a sparse linear model plus noise, and a held-out
    eval set."""
    rng = np.random.default_rng(77)
    X = rng.normal(size=(2300, 1100)).astype(np.float32)
    w_true = np.where(rng.random(1100) < 0.05, rng.normal(size=1100), 0.0)
    y = (2.0 + X @ w_true + rng.normal(size=2300) * 0.3).astype(np.float32)
    return X[:2000], y[:2000], X[2000:], y[2000:]


def _train_k1(problem, device):
    X, y, Xe, ye = problem
    hp = gblinear.GBLinearParams(num_round=30)
    return gblinear.train_gblinear(X, y, hp, evals=[(Xe, ye, "eval"), (X, y, "train")], device=device)


def _train_multi(problem, device):
    X, y, _, _ = problem
    Y = np.stack([y, y * 0.5 + 1.0, y[::-1].copy()], axis=1)
    hp = gblinear.GBLinearParams(num_round=30, reg_alpha=5.0)
    return gblinear.train_gblinear_multi(X, Y, hp, row_weights=gblinear.bootstrap_row_weights(len(y), [0, 1, 2]),
                                         device=device)


def test_trainers_with_the_kernel_equal_the_plain_version_and_a_rerun(cuda, train_problem, monkeypatch):
    """K = 1 launches the round kernel once a round and no coordinate
    update; with the plain round swapped in it stays within the card-vs-CPU
    limits (weights 1e-5 of max|w|, bias 1e-6, RMSE 1e-5), and a rerun is
    equal bit for bit. K = 3 launches the block step's two kernels once a
    block each (the fused route: no coordinate-update launch), equals a
    rerun bit for bit and, with the plain block step (SGEMM and the plain
    update) swapped in, stays within the card-vs-CPU limits (weights 1e-5
    of max|w|, biases 1e-5)."""
    from expecto_tpu_torch.ops import gblinear_block as gbb

    gblinear_cd.reset_launch_counts()
    gr.reset_launch_counts()
    gbb.reset_launch_counts()
    k1 = _train_k1(train_problem, "cuda")
    assert gr.gblinear_round.launches == 30 and gblinear_cd.coord_update.launches == 0
    multi = _train_multi(train_problem, "cuda")
    assert gblinear_cd.coord_update.launches == 0 and gr.gblinear_round.launches == 30
    assert gbb.grad_update.launches_by_route == {"fused": 30 * 3, "split": 0}  # 3 blocks, 30 rounds
    assert gbb.residual_update.launches == 30 * 3
    k1_again, multi_again = _train_k1(train_problem, "cuda"), _train_multi(train_problem, "cuda")
    monkeypatch.setattr(gblinear, "gblinear_round", gr.gblinear_round_plain)
    monkeypatch.setattr(gblinear, "coord_update", gblinear_cd.coord_update_plain)
    monkeypatch.setattr(gblinear, "grad_update", gbb.grad_update_plain)
    monkeypatch.setattr(gblinear, "residual_update", gbb.residual_update_plain)
    gblinear_cd.reset_launch_counts()
    gr.reset_launch_counts()
    gbb.reset_launch_counts()
    k1_plain, multi_plain = _train_k1(train_problem, "cuda"), _train_multi(train_problem, "cuda")
    assert gblinear_cd.coord_update.launches == 0 and gr.gblinear_round.launches == 0
    assert gbb.grad_update.launches == 0 and gbb.residual_update.launches == 0
    np.testing.assert_array_equal(k1_again.weight, k1.weight)
    assert k1_again.bias == k1.bias and k1_again.eval_history == k1.eval_history
    np.testing.assert_allclose(k1_plain.weight, k1.weight, rtol=0, atol=1e-5 * float(np.abs(k1.weight).max()))
    assert abs(k1_plain.bias - k1.bias) <= 1e-6
    for name in ("eval", "train"):
        np.testing.assert_allclose(k1_plain.eval_history[name], k1.eval_history[name], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(multi_again.weights, multi.weights)
    np.testing.assert_array_equal(multi_again.biases, multi.biases)
    np.testing.assert_allclose(multi_plain.weights, multi.weights, rtol=0,
                               atol=1e-5 * float(np.abs(multi_plain.weights).max()))
    np.testing.assert_allclose(multi_plain.biases, multi.biases, rtol=0, atol=1e-5)


def test_trainers_on_card_match_cpu(cuda, train_problem):
    """fp32 products with TF32 off, summed in other orders on the card and on
    the CPU: weights within 1e-5 of max|w|, the per-round RMSE within 1e-5."""
    k1_gpu, k1_cpu = _train_k1(train_problem, "cuda"), _train_k1(train_problem, "cpu")
    tol = 1e-5 * float(np.abs(k1_cpu.weight).max())
    np.testing.assert_allclose(k1_gpu.weight, k1_cpu.weight, rtol=0, atol=tol)
    assert abs(k1_gpu.bias - k1_cpu.bias) < 1e-5
    for name in ("eval", "train"):
        np.testing.assert_allclose(k1_gpu.eval_history[name], k1_cpu.eval_history[name], rtol=0, atol=1e-5)
    m_gpu, m_cpu = _train_multi(train_problem, "cuda"), _train_multi(train_problem, "cpu")
    np.testing.assert_allclose(m_gpu.weights, m_cpu.weights, rtol=0, atol=1e-5 * float(np.abs(m_cpu.weights).max()))
    np.testing.assert_allclose(m_gpu.biases, m_cpu.biases, rtol=0, atol=1e-5)


def test_backend_and_device_rule_on_this_machine(cuda):
    """Two local ranks: NCCL when each has a card, gloo when they share one;
    the second rank's bare ``cuda`` is card 1 % cards."""
    cards = torch.cuda.device_count()
    assert mesh.choose_backend("cuda", 2, cards) == ("nccl" if cards >= 2 else "gloo")
    assert mesh.choose_backend("cuda", 1, cards) == "nccl"
    assert mesh.rank_device(torch.device("cuda"), 1, cards) == torch.device("cuda", 1 % cards)
    assert mesh.local_device("cuda") == torch.device("cuda", 0)


def test_two_rank_sharded_trainer_on_the_card_matches_one_rank(cuda, train_problem, tmp_path):
    """The sharded trainers as a 2-rank group on the card (this rule's
    backend, one card shared over gloo where there is one) against
    train_gblinear_multi on the card at one rank: weights within 1e-5 of
    max|w|, biases 1e-6, watchlist 1e-5; the coordinate-update kernel ran
    once a block a round on each rank, and the identity all-reduce misses."""
    X, y, Xe, ye = train_problem
    rounds, block = 10, 512
    Y8 = np.stack([y + 0.1 * j for j in range(8)], axis=1).astype(np.float32)
    rw8 = gblinear.bootstrap_row_weights(len(y), list(range(8)))
    np.savez(tmp_path / "inputs.npz", X=X, y1=y, Y8=Y8, rw8=rw8, Xe=Xe, ye=ye)
    cfg = {"inputs": str(tmp_path / "inputs.npz"), "out": str(tmp_path / "out.npz"), "num_round": rounds,
           "block_size": block, "alpha": 0.5, "device": "cuda"}
    torchrun([DIST_WORKER, "train", json.dumps(cfg)], backend=mesh.choose_backend("cuda", 2, torch.cuda.device_count()),
             timeout=600)
    got = np.load(tmp_path / "out.npz")
    hp = gblinear.GBLinearParams(num_round=rounds, block_size=block, reg_alpha=0.5)
    k1 = gblinear.train_gblinear_multi(X, y, hp, device="cuda")
    k8 = gblinear.train_gblinear_multi(X, Y8, hp, row_weights=rw8, device="cuda")
    n_blocks = -(-X.shape[1] // block)
    assert int(got["k1_launches"]) == rounds * n_blocks
    assert int(got["k1_calls"]) == 3 + rounds * (1 + n_blocks)
    for prefix, sound in (("", True), ("identity_", False)):
        gaps = [np.abs(got[f"{prefix}k1_w"] - k1.weights[:, 0]).max() / np.abs(k1.weights).max(),
                np.abs(got[f"{prefix}k8_w"] - k8.weights).max() / np.abs(k8.weights).max(),
                10 * abs(float(got[f"{prefix}k1_b"]) - float(k1.biases[0])),
                10 * np.abs(got[f"{prefix}k8_b"] - k8.biases).max()]
        assert (max(gaps) <= 1e-5) == sound, (prefix, gaps)
    single = gblinear.train_gblinear(X, y, hp, evals=[(Xe, ye, "eval"), (X, y, "train")], device="cuda")
    for name in ("eval", "train"):
        np.testing.assert_allclose(got[f"k1_hist_{name}"], single.eval_history[name], rtol=0, atol=1e-5)


# ---- the round kernel's two shared-memory plans ---------------------------------

def _shared_plan_cap(b: int) -> int:
    """The most rows the round kernel runs in its "shared" plan at blocks of
    ``b`` on this card (8,192 rows a CTA: about 1.08 million on an H100)."""
    lo, hi = 1, 1 << 26
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if gr.round_plan(0, mid, b) == "shared" else (lo, mid - 1)
    return lo


def test_round_plan_turns_streamed_one_row_past_the_shared_cap(cuda):
    """Past the "shared" plan's cap the kernel still plans a cooperative
    grid of one CTA an SM: r's slice in shared memory up to 8,192 rows a
    CTA, one tile of it past the cap, where the ring takes at least the
    slots the "shared" plan leaves at its cap."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (16, 512):
        cap = _shared_plan_cap(b)
        assert cap == 8192 * sms
        at, past = gr.device_geometry(0, cap, b), gr.device_geometry(0, cap + 1, b)
        assert not at.streamed and at.r_floats == at.tile * at.tiles_max and at.slots - at.cache >= 2
        assert past.streamed and past.r_floats == past.tile and past.slots - past.cache >= at.slots - at.cache
        assert (gr.round_plan(0, cap + 1, b), gr.round_plan(0, 2**31 - 1, b)) == ("streamed", "streamed")
        assert gr.round_ctas(0, cap + 1, b) == sms
        g = gr.device_geometry(0, cap + 1, b)
        assert g.smem <= g.optin


@pytest.mark.parametrize("b", [1, 8, 16, 100, 512, 4096])
def test_round_plan_fits_the_card_and_covers_every_cta(cuda, b):
    """The kernel's plan at row counts from 1 to 2^31 - 1: one CTA an SM,
    every CTA's rows within its tiles of float4s, whole stages over the
    block, at least two ring slots beside the cache, (C)'s groups within the
    512 consumer threads, r's floats as the plan says, and the shared memory
    within the card's limit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (1, 4, 132, 401, 2001, 22_296, 44_592, 1_081_344, 1_081_345, 3_799_356, 3_799_357, 2**31 - 1):
        g = gr.device_geometry(0, n, b)
        lo, hi = gr.row_plan(n, g.ctas)
        assert g.ctas == sms and (hi - lo).max() <= g.rows_max <= g.tile * g.tiles_max, (n, b, g)
        assert g.tile % 4 == 0 and 0 < g.tile <= 256 and g.stage_rows * g.stages >= b > g.stage_rows * (g.stages - 1)
        assert 0 <= g.cache <= min(g.slots - 2, g.stages) and 1 <= g.groups and g.groups * g.tile // 4 <= 512
        assert g.r_floats == (g.tile if g.streamed else g.tile * g.tiles_max) and g.smem <= g.optin, (n, b, g)


def test_round_plan_at_the_published_shape(cuda):
    """22,296 rows of 40 blocks of 512 on an H100: one 172-row tile a CTA,
    32 stages of 16 feature rows a block, 20 slots, 16 of them cache slots
    (the ring the other 4), the "shared" plan."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the published plan is an H100's (132 SMs)")
    g = gr.device_geometry(0, 22_296, 512)
    assert (g.ctas, g.rows_max, g.tile, g.tiles_max, g.stage_rows, g.stages) == (132, 172, 172, 1, 16, 32)
    assert (g.slots, g.cache, g.groups, g.streamed) == (20, 16, 8, False) and g.smem <= g.optin


def test_round_kernel_refuses_a_graph_capture(cuda):
    """A CUDA graph would replay the captured tags, and the kernel would
    read the replay before's words as its own: the wrapper raises while the
    stream captures, and the scratch's tags go on after it."""
    Xt, hess, w, bias, r = _round_state(2001, 40, 16, seed=7)
    scratch = gr.round_scratch(Xt)
    gr.gblinear_round(Xt, hess, w, bias, r, scratch, 2001.0, 0.3, 5.0, 0.0)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            gr.gblinear_round(Xt, hess, w, bias, r, scratch, 2001.0, 0.3, 5.0, 0.0)
    gr.gblinear_round(Xt, hess, w, bias, r, scratch, 2001.0, 0.3, 5.0, 0.0)
    torch.cuda.synchronize()
    assert torch.isfinite(w).all() and torch.isfinite(r).all()


@pytest.mark.parametrize("past", [0, 1], ids=["at_cap", "past_cap"])
def test_round_kernel_on_both_sides_of_the_shared_cap(cuda, past):
    """At the "shared" plan's cap and one row past it (the "streamed" plan)
    a round is one launch of the round kernel, no coordinate-update launch,
    within the card-vs-CPU limits of the plain round."""
    n = _shared_plan_cap(16) + past
    state = _round_state(n, 40, 16, seed=n % 97)  # three blocks, the last one padded
    gr.reset_launch_counts()
    gblinear_cd.reset_launch_counts()
    got = _run_rounds(state, 2, 0.0, functools.partial(gr.gblinear_round, update=gblinear_cd.coord_update))
    assert gblinear_cd.coord_update.launches == 0
    assert gr.gblinear_round.launches_by_plan == {"shared": 0 if past else 2, "streamed": 2 if past else 0}
    want = _run_rounds(state, 2, 0.0, gr.gblinear_round_plain)
    w_gap, b_gap, h_gap = _round_gaps(got, want)
    assert w_gap <= 1e-5 and b_gap <= 1e-6 and h_gap <= 1e-5, (w_gap, b_gap, h_gap)


def test_train_gblinear_past_the_shared_cap(cuda, monkeypatch):
    """train_gblinear one row past the "shared" plan's cap trains through the
    round kernel's "streamed" plan, one launch a round, within the limits of
    the plain round swapped in."""
    rng = np.random.default_rng(41)
    n = _shared_plan_cap(16) + 1
    X = rng.normal(size=(n, 16)).astype(np.float32)
    y = (2.0 + X @ rng.normal(size=16) + rng.normal(size=n) * 0.3).astype(np.float32)
    hp = gblinear.GBLinearParams(num_round=3, block_size=16)
    gr.reset_launch_counts()
    gblinear_cd.reset_launch_counts()
    got = gblinear.train_gblinear(X, y, hp, evals=[(X[:5000], y[:5000], "train")], device="cuda")
    assert gr.gblinear_round.launches_by_plan["streamed"] == 3 and gblinear_cd.coord_update.launches == 0
    monkeypatch.setattr(gblinear, "gblinear_round", gr.gblinear_round_plain)
    monkeypatch.setattr(gblinear, "coord_update", gblinear_cd.coord_update_plain)
    want = gblinear.train_gblinear(X, y, hp, evals=[(X[:5000], y[:5000], "train")], device="cuda")
    np.testing.assert_allclose(got.weight, want.weight, rtol=0, atol=1e-5 * float(np.abs(want.weight).max()))
    assert abs(got.bias - want.bias) <= 1e-6
    np.testing.assert_allclose(got.eval_history["train"], want.eval_history["train"], rtol=0, atol=1e-5)


# ---- converted weights ----------------------------------------------------------

def test_converted_weights_serve_on_card_as_the_oracle(cuda):
    """The oracle's state dict (published widths, He-scaled seeded weights)
    through state_dict_to_params, served in fp32 on the card: the tracks
    within 1e-5 (the h5 contract's card-vs-CPU limit) of the torch oracle on
    the CPU; an fc1 converted without fc1_permutation misses it."""
    torch.manual_seed(5)
    net = TorchBeluga().eval()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.normal_(0.0, float(np.sqrt(2.0 / p[0].numel())) if name.endswith("weight") else 0.05)
    params = convert.state_dict_to_params(net.state_dict_reference_keys())
    codes = random_codes(np.random.default_rng(6), 6, 2000, n_frac=0.02)
    before = conv0_codes_relu.launches_by_kind["float32"]
    got = BelugaRunner(params, batch_size=16, device="cuda").predict_codes(codes)
    assert conv0_codes_relu.launches_by_kind["float32"] > before
    x = np.eye(5, 4, dtype=np.float32)[codes]  # code 4 (N) is all zeros
    with torch.no_grad():
        want = net(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))[:, :, None, :]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    params["fc1"]["w"] = np.ascontiguousarray(net.fc1.weight.detach().numpy().T)
    bad = BelugaRunner(params, batch_size=16, device="cuda").predict_codes(codes)
    assert np.abs(bad - want).max() > 1e-3


# ---- pipelined execution --------------------------------------------------------

PIPE_MUT = H5_MAXSHIFT + 999
PIPE_BATCH = 2 * len(H5_OFFSETS)  # two spans, or one pair, a chunk


def _pipe_inputs(n, seed):
    """Inputs of every public runner method at the h5 tests' span: ``n``
    spans, pairs, unique variants (two rows each) or genes."""
    rng = np.random.default_rng(seed)
    ref, alt = _h5_pairs(n, seed)
    alleles = ((ref[:, PIPE_MUT : PIPE_MUT + 1] + 1) % 4).astype(np.int8)
    backbone = random_codes(rng, 1, H5_SPAN, n_frac=0.0)[0]
    samples = np.repeat(backbone[None], n, axis=0)
    for i in range(1, n):
        sites = rng.choice(np.arange(1200, 1600), size=1 + i % 3, replace=False)
        samples[i, sites] = (samples[i, sites] + 1) % 4
    phases_f = {(o // 4) % 4 for o in H5_OFFSETS}
    phases_r = {((H5_SPAN - 2000 - o) // 4) % 4 for o in H5_OFFSETS}
    sf, sr = (np.zeros((n, 8, 2), np.int32) for _ in range(2))
    for m, row in enumerate(samples):
        dp = np.nonzero(row != backbone)[0]
        for starts, plan in ((sf, conv6_patch_sites_plan(dp, H5_SPAN, phases_f, max_ranges=8)),
                             (sr, conv6_patch_sites_plan((H5_SPAN - 1 - dp)[::-1], H5_SPAN, phases_r, max_ranges=8))):
            if plan:
                starts[m, : len(plan)] = plan
    return {"ref": ref, "alt": alt, "alleles": alleles, "row_uidx": np.repeat(np.arange(n), 2),
            "basis": rng.random((len(H5_OFFSETS), n, 10)).astype(np.float32),
            "basis_rows": rng.random((len(H5_OFFSETS), 2 * n, 10)).astype(np.float32),
            "W": (rng.standard_normal((10 * 2002, 3)) * 0.05).astype(np.float32),
            "bias": np.array([2.0, 2.1, 1.9], np.float32),
            "pw": rng.random((10, len(H5_OFFSETS))).astype(np.float32),
            "codes": random_codes(rng, 4 * n, 2000), "backbone": backbone, "samples": samples, "starts": (sf, sr)}


def _sunk(call, n_arrays):
    """What ``call(sink)`` streamed, assembled in row order."""
    got = {}
    assert call(lambda start, real, *arrays: got.__setitem__(start, arrays)) is None
    return tuple(np.concatenate([got[s][k] for s in sorted(got)]) for k in range(n_arrays))


PIPE_CALLS = {
    "predict_codes": lambda r, d: r.predict_codes(d["codes"]),
    "predict_codes_fwd_rc_concat": lambda r, d: r.predict_codes_fwd_rc_concat(d["codes"]),
    "predict_span_codes": lambda r, d: r.predict_span_codes(d["ref"], H5_OFFSETS, rc_mode="concat"),
    "predict_spans_project": lambda r, d: r.predict_spans_project(d["ref"], H5_OFFSETS, d["pw"]),
    "project_spans_backbone_patch": lambda r, d: r.project_spans_backbone_patch(
        d["backbone"], d["samples"], *d["starts"], H5_OFFSETS, d["pw"]),
    "predict_and_project": lambda r, d: r.predict_and_project(d["codes"][: 5 * (len(d["codes"]) // 5)], d["pw"][:, :5],
                                                              5),
    "predict_span_pairs_diff": lambda r, d: r.predict_span_pairs_diff(d["ref"], d["alt"], H5_OFFSETS),
    "predict_span_pairs_diff_sink": lambda r, d: _sunk(
        lambda sink: r.predict_span_pairs_diff(d["ref"], d["alt"], H5_OFFSETS, sink=sink), 3),
    "predict_span_pair_diffs_only_sink": lambda r, d: _sunk(
        lambda sink: r.predict_span_pair_diffs_only(d["ref"], d["alt"], H5_OFFSETS, sink=sink), 1),
    "score_variant_spans": lambda r, d: r.score_variant_spans(
        d["ref"], d["alt"], H5_OFFSETS, d["basis"], d["W"], d["bias"]),
    "score_variant_spans_packed": lambda r, d: r.score_variant_spans_packed(
        d["ref"], PIPE_MUT, d["alleles"], H5_OFFSETS, d["basis"], d["W"], d["bias"]),
    "score_variant_spans_packed_rows": lambda r, d: r.score_variant_spans_packed_rows(
        d["ref"], PIPE_MUT, d["alleles"], H5_OFFSETS, d["basis_rows"], d["row_uidx"], d["W"], d["bias"]),
    "score_variant_span_pairs_rows": lambda r, d: r.score_variant_span_pairs_rows(
        d["ref"], d["alt"], H5_OFFSETS, d["basis_rows"], d["row_uidx"], d["W"], d["bias"]),
}


def _pipe_runner(dtype, depth, batch=PIPE_BATCH):
    return BelugaRunner(narrow_params(17, convs=TC_WIDTHS), batch_size=batch, device="cuda", compute_dtype=dtype,
                        out_dtype=np.float32 if dtype == torch.float32 else np.float16, pipeline_depth=depth)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _assert_bit_equal(got, want):
    for g, w in zip(_as_tuple(got), _as_tuple(want), strict=True):
        assert np.isfinite(w).all()
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("method", ["score_variant_spans_packed_rows", "predict_span_pairs_diff_sink",
                                    "predict_spans_project"])
def test_pipeline_depth_4_equals_depth_1_on_card(cuda, method, dtype):
    """12 spans (6 span chunks, 12 pair chunks): compute stays on one stream
    in the same order at every depth, so the outputs are equal bit for bit."""
    d = _pipe_inputs(12, seed=21)
    _assert_bit_equal(PIPE_CALLS[method](_pipe_runner(dtype, 4), d), PIPE_CALLS[method](_pipe_runner(dtype, 1), d))


def _slowed_landings(monkeypatch, seconds: float):
    """Every write sleeps ``seconds`` after its copy has landed, before it
    reads the pinned buffer."""
    from expecto_tpu_torch.parallel import runner as prunner

    wait = prunner._Landing.wait

    def slow(self):
        host = wait(self)
        time.sleep(seconds)
        return host

    monkeypatch.setattr(prunner._Landing, "wait", slow)


def test_pipeline_depth_2_with_a_slowed_writer_over_40_chunks(cuda, monkeypatch):
    d = _pipe_inputs(40, seed=22)
    want = PIPE_CALLS["predict_span_pairs_diff_sink"](_pipe_runner(torch.float32, 1), d)
    _slowed_landings(monkeypatch, 0.005)
    _assert_bit_equal(PIPE_CALLS["predict_span_pairs_diff_sink"](_pipe_runner(torch.float32, 2), d), want)


def test_pipeline_reusing_a_landing_slot_a_chunk_early_misses(cuda, monkeypatch):
    """A planted fault: one landing buffer a shape for every chunk, so chunk
    i lands where chunk i - 1 did while i - 1's slowed write still reads it
    (the caching host allocator would hand that block out only after the
    write had released it)."""
    from expecto_tpu_torch.parallel import runner as prunner

    d = _pipe_inputs(12, seed=23)
    want = PIPE_CALLS["predict_span_pairs_diff_sink"](_pipe_runner(torch.float32, 1), d)
    _slowed_landings(monkeypatch, 0.02)
    shared = {}

    def one_buffer(y):
        key = (tuple(y.shape), y.dtype)
        if key not in shared:
            shared[key] = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        return shared[key]

    monkeypatch.setattr(prunner, "_pinned_like", one_buffer)
    got = PIPE_CALLS["predict_span_pairs_diff_sink"](_pipe_runner(torch.float32, 2), d)
    assert not all(np.array_equal(g, w) for g, w in zip(got, want))


def test_pipeline_dispatch_runs_ahead_of_the_first_write(cuda):
    """The sink of chunk 0 waits until the launch counts show the conv0
    launches of ``pipeline_depth`` chunks (two a pair chunk), then the call
    completes with the rows of an unblocked call; a loop that wrote each
    chunk before making the next would time out here."""
    depth = 3
    d = _pipe_inputs(8, seed=24)
    runner = _pipe_runner(torch.float32, depth)
    want = PIPE_CALLS["predict_span_pair_diffs_only_sink"](runner, d)
    before, seen = conv0_codes_relu.launches, []
    got = {}

    def sink(start, real, diff):
        if start == 0:
            deadline = time.monotonic() + 20
            while conv0_codes_relu.launches - before < 2 * depth and time.monotonic() < deadline:
                time.sleep(0.001)
            seen.append(conv0_codes_relu.launches - before)
        got[start] = diff

    runner.predict_span_pair_diffs_only(d["ref"], d["alt"], H5_OFFSETS, sink=sink)
    assert seen and seen[0] >= 2 * depth
    np.testing.assert_array_equal(np.concatenate([got[s] for s in sorted(got)]), want[0])


@pytest.mark.parametrize("method", list(PIPE_CALLS))
def test_pipelined_calls_never_synchronize(cuda, method):
    """With torch's sync debug mode set to "error", a warm call of every
    public method runs through: no pageable upload, no blocking fetch, no
    ``.item()`` or boolean mask on the host's path through the chunks."""
    d = _pipe_inputs(6, seed=25)
    runner = _pipe_runner(torch.float32, 4)
    want = PIPE_CALLS[method](runner, d)  # warm: kernels built, weights packed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = PIPE_CALLS[method](runner, d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_bit_equal(got, want)
