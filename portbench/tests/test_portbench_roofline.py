"""The frozen operation and byte counts against counts made by hand at
small shapes, and against published totals."""

from __future__ import annotations

import pytest

from portbench.roofline.flops import (
    cellvit_branch_flops,
    conv,
    deconv2,
    resnet_flops,
    sam_encoder_flops,
)
from portbench.roofline.k1 import k1_bound_s, k1_counts, pil_taps
from portbench.roofline.k2 import k2_bound_s, k2_counts, sam_launches

PEAKS = {"bytes": 3.35e12, "float32": 67e12, "bfloat16": 989e12, "tf32": 494.7e12}


def test_pil_taps_by_hand():
    # 4 -> 2: scale 2, support 2; output 0 is centred at 1.0 and takes
    # inputs 0..2, output 1 at 3.0 takes 1..3 (the window is clipped at 4)
    assert pil_taps(4, 2) == [3, 3]
    # 2 -> 4: upsampling keeps the support 1: each output takes 1 or 2 inputs
    assert pil_taps(2, 4) == [1, 2, 2, 1]
    assert pil_taps(5, 5) == [1] * 5


def test_k1_counts_by_hand():
    flops, nbytes = k1_counts(1, 4, 4, 2, 2, 2)
    assert nbytes == 4 * 4 * 3 + 2 * 2 * 3 * 2
    # horizontal: 4 rows x (3 + 3) taps; vertical: 2 columns x (3 + 3) taps;
    # 2 FLOP each, 3 channels; the affine: 2 per output value
    assert flops == 2 * 3 * (4 * 6 + 2 * 6) + 2 * 2 * 2 * 3


def test_k1_bound_at_the_main_path_shape():
    # B=256 350 -> 224 in bf16 is byte-bound: 94.1 MB in, 77.1 MB out at 3.35 TB/s
    assert k1_bound_s(256, 350, 350, 224, 224, 2, PEAKS) == pytest.approx(51.09e-6, rel=1e-3)


def test_k2_counts_by_hand():
    # one window of 2 x 2 tokens, 2 heads of 4: 4 rows x 2 heads x (4*4*4 + 2*(2+2)*4)
    flops, nbytes = k2_counts(1, (2, 2), 8, 2, 2, None, True, 2)
    assert flops == 4 * 2 * (4 * 4 * 4 + 2 * 4 * 4)
    assert nbytes == (4 * 2 * 8 + 2 * 4 * 8) * 2 + (4 + 4) * 4 * 2
    # without rel-pos, the global case over a 1 x 3 row
    flops, _ = k2_counts(1, (1, 3), 4, 1, 0, None, False, 4)
    assert flops == 3 * 1 * 4 * 3 * 4


def test_k2_bounds_of_sam_h():
    launches = sam_launches(32, 256, 16, 1280, 16, 14, 4, 32)
    assert [n for n, _ in launches] == [28, 4]
    windowed, global_ = (k2_bound_s(*a, "bfloat16", PEAKS) for _, a in launches)
    assert windowed == pytest.approx(50.88e-6, rel=1e-3)
    assert global_ == pytest.approx(25.07e-6, rel=1e-3)


def test_resnet34_is_torchvisions_3_66_gmacs():
    assert resnet_flops((3, 4, 6, 3), 224, 1000) / 2 == pytest.approx(3.67e9, rel=0.01)


def test_resnet_by_hand_at_a_small_shape():
    # one block per stage at 32 px: conv1 -> 16, pool -> 8, stages at 8, 4, 2, 1
    want = conv(3, 64, 7, 16, 16)
    want += 2 * conv(64, 64, 3, 8, 8)
    want += conv(64, 128, 3, 4, 4) + conv(128, 128, 3, 4, 4) + conv(64, 128, 1, 4, 4)
    want += conv(128, 256, 3, 2, 2) + conv(256, 256, 3, 2, 2) + conv(128, 256, 1, 2, 2)
    want += conv(256, 512, 3, 1, 1) + conv(512, 512, 3, 1, 1) + conv(256, 512, 1, 1, 1)
    assert resnet_flops((1, 1, 1, 1), 32, 2) == want + 2 * 512 * 2


def test_sam_encoder_by_hand_at_a_small_shape():
    # 32 px, patch 16: 2 x 2 tokens, width 8, one windowed block (window 1) and one global
    t, c = 4, 8
    dense = 2 * t * c * 3 * c + 2 * t * c * c + 2 * 2 * t * c * 32
    want = conv(3, c, 16, 2, 2) + 2 * dense
    want += 4 * t * 1 * c + 2 * t * 2 * 1 * c  # windowed
    want += 4 * t * t * c + 2 * t * 2 * 2 * c  # global
    assert sam_encoder_flops(c, 2, 2, 1, 1, 4.0, 16, 32) == want


def test_cellvit_branch_is_its_blocks():
    # at a width under 512 the ViT-256 widths (312, 256, 128) apply
    total = cellvit_branch_flops(64, 32, 2)
    assert total > conv(128, 64, 3, 32, 32) + deconv2(64, 312, 2, 2)
