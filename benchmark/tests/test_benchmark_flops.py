"""Operation and byte counts against hand counts at Beluga's widths."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import flops

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = json.load(open(os.path.join(HERE, "configs", "expecto-beluga-bf16.json")))
SCORE = json.load(open(os.path.join(HERE, "traffic", "vcf-8192.json")))
GENES = json.load(open(os.path.join(HERE, "traffic", "genes-1024.json")))
TRAIN = json.load(open(os.path.join(HERE, "traffic", "train-218.json")))
# 2 * 8 * Cin * Cout a conv output position
PER_POS = [2 * 8 * 4 * 320, 2 * 8 * 320 * 320, 2 * 8 * 320 * 480, 2 * 8 * 480 * 480, 2 * 8 * 480 * 640,
           2 * 8 * 640 * 640]


def test_one_window_is_beluga():
    # 2000 -> 1993 -> 1986 -> pool 496 -> 489 -> 482 -> pool 120 -> 113 -> 106
    counts, frames = flops.span_conv_outputs(2000, [0], CFG)
    assert counts == [1993, 1986, 489, 482, 113, 106]
    assert frames == {0: 106}
    assert flops.conv_layer_flops(CFG) == PER_POS


def test_score_span_shares_its_windows():
    # 9 windows 200 bp apart on a 3,600-bp span: conv0-conv1 over the span,
    # conv2-conv3 over the first pool's 896 positions, conv4-conv5 on the two
    # phases of the second pool (offsets/4 = 0, 50, ..., 400: phases 0 and 2)
    offsets = list(range(0, 1601, 200))
    counts, _ = flops.span_conv_outputs(3600, offsets, CFG)
    phase0 = (100 + 113) + (100 + 106)  # starts 0..100 on phase 0's grid
    phase2 = (87 - 12 + 113) + (87 - 12 + 106)  # starts 12..87 on phase 2's grid
    assert counts == [3593, 3586, 896 - 7, 896 - 14, 213 + 188, 206 + 181]
    assert counts[4] + counts[5] == phase0 + phase2


def test_snv_cone():
    # one changed base reaches 8 conv0 outputs, 15 conv1 outputs, and 19
    # conv5 frames of a window that holds it in its middle
    offsets = list(range(0, 1601, 200))
    counts, frames = flops.span_conv_outputs(3600, offsets, CFG, (1799, 1800))
    assert counts[:2] == [8, 15]
    assert frames[800] == 19
    assert max(frames.values()) <= 106


def test_score_call_hand_count():
    n, n_ind = 8192, 819
    n_snv = n - n_ind
    w = flops.score_call_work(CFG, SCORE)
    full = sum(c * f for c, f in zip([3593, 3586, 889, 882, 401, 387], PER_POS))
    offsets = list(range(0, 1601, 200))
    cone_f, _ = flops.span_conv_outputs(3600, offsets, CFG, (1799, 1800))
    cone_r, _ = flops.span_conv_outputs(3600, offsets, CFG, (1800, 1801))  # the RC span's changed column
    cone = sum(c * f for c, f in zip(cone_f, PER_POS)) + sum(c * f for c, f in zip(cone_r, PER_POS))
    assert w.flops["conv"] == (n + n_ind) * 2 * full + n_snv * cone
    assert cone < 0.05 * 2 * full
    assert w.flops["fc1"] == (n + n_ind) * 2 * 9 * 2.0 * 67840 * 2003
    assert w.flops["fc2"] == n * 36 * 2.0 * 2003 * 2002
    assert w.flops["head"] == n * 2 * (2.0 * 9 * 20020 + 2.0 * 20020 * 218)
    assert w.flops["fc1_delta"] > 0 and w.flops["fc1_delta"] < n_snv * 18 * 2.0 * 67840 * 2003
    per_variant = w.total_flops / n
    assert 40e9 < per_variant < 44e9
    # bytes: the fc1 weight in bf16 once a call
    assert w.bytes["fc1"] > 67840 * 2003 * 2


def test_gene_call_hand_count():
    w = flops.gene_call_work(CFG, GENES)
    n = 1024
    assert w.flops["fc1"] == n * 400 * 2.0 * 67840 * 2003
    assert w.flops["fc2"] == n * 400 * 2.0 * 2003 * 2002
    counts, _ = flops.span_conv_outputs(41800, list(range(0, 40000, 200)), CFG)
    assert counts[0] == 41793 and counts[1] == 41786
    assert w.flops["conv"] == n * 2 * sum(c * f for c, f in zip(counts, PER_POS))
    assert 490e9 < w.total_flops / n < 505e9


def test_train_call_hand_count():
    w = flops.train_call_work(CFG, TRAIN)
    n, f, k = 21202, 20020, 218
    assert w.flops["block"] == 100 * 4.0 * n * f * k
    assert w.flops["hessian"] == 2.0 * n * f * k
    assert w.total_flops / 100 == pytest.approx(0.3720e12, rel=1e-3)
    assert w.bytes["block"] >= 100 * n * f * 4


def test_peaks():
    p = flops.peaks()
    assert p["flops"]["bf16"] == 989e12 and p["flops"]["tf32"] == 495e12 and p["hbm_bytes_per_s"] == 3.35e12
