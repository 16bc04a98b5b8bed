"""The work formulas on small cases worked by hand."""

import pytest

from kzgbench import workcount as W


def test_fr_ntt():
    # n = 8: 4 butterflies in each of 3 stages, one Fr product each
    assert W.products({"op": "fr_ntt", "n": 8, "count": 2}) == (0, 24)
    with pytest.raises(ValueError):
        W.products({"op": "fr_ntt", "n": 12, "count": 1})


def test_msm_fixed():
    # 3 points, c = 2: w = ceil(256 / 2) = 128 windows, 3 * 128 mixed
    # additions of 10 products, then 2 additions of 14 for each of 2 buckets
    assert W.products({"op": "msm_fixed", "points": 3, "window": 2, "count": 1}) == (3840 + 56, 0)


def test_msm_variable():
    # 2 points, c = 4: w = 64 windows, each 2 * 10 + 2 * 8 * 14 = 244;
    # 63 joins of 4 doublings (9) and an addition (14) = 50
    assert W.products({"op": "msm_variable", "points": 2, "window": 4, "count": 1}) == (64 * 244 + 63 * 50, 0)


def test_g1_fft_and_to_affine():
    # n = 4: 2 butterflies in 2 stages; each 255 doublings + 78 additions + 2 additions
    per = 255 * 9 + 78 * 14 + 2 * 14
    assert W.products({"op": "g1_fft", "n": 4, "count": 1}) == (4 * per, 0)
    assert W.products({"op": "to_affine", "points": 5, "count": 1}) == (35 + W.FP_INV, 0)


def test_inversions():
    # Fermat: bit_length - 1 squarings and popcount - 1 products
    assert W.FR_INV == (W.R - 2).bit_length() - 1 + bin(W.R - 2).count("1") - 1
    assert 300 < W.FR_INV < 510 and 450 < W.FP_INV < 770


def test_madds_and_files():
    ops = [{"op": "fr_products", "count": 10}, {"op": "msm_fixed", "points": 1, "window": 2, "count": 1}]
    assert W.call_madds(ops) == 10 * 264 + (128 * 10 + 2 * 2 * 14) * 588
    for traffic in ("cells-produce-block", "blobs-commit-prove", "cells-verify-column", "blobs-verify-block"):
        assert W.load(W.os.path.dirname(W.os.path.dirname(W.__file__)), traffic) > 0
    with pytest.raises(ValueError):
        W.products({"op": "nope", "count": 1})
