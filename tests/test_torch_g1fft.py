"""kzg_tpu_torch.ops.g1fft against the oracle's G1 FFT and the JAX
package's kzg_tpu.ops.g1fft, on the CPU. Points are compared as affine
ints (XYZZ coordinates are not unique); host tables exactly. The ladder's
wrapper (kernel B8 on a card, its plain version on the CPU) limb for limb
against the loop it replaced; its cases on a card are marked `gpu` and
skip without one. The JAX package is imported inside the tests that
compare with it, so that the card's tests run where JAX is missing."""

import numpy as np
import pytest
import torch

from kzg_tpu.constants import R_MOD as R
from kzg_tpu.oracle.curve import G1, G1_GENERATOR
from kzg_tpu.oracle.fft import fft_g1 as oracle_fft_g1
from kzg_tpu_torch import native
from kzg_tpu_torch.ops import field as fl
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.ops import g1fft as tgf
from kzg_tpu_torch.ops import launch
from kzg_tpu_torch.ops.field import FP

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(41)
    pts = [G1.mul_scalar(G1_GENERATOR, int(rng.integers(1, 1 << 62)) * 7919 % R) for _ in range(16)]
    pts[3] = None  # an identity lane
    pts[9] = pts[8]  # equal lanes
    return pts


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_g1_matches_oracle(points, inverse):
    n = 8
    p = tg.from_affine(tg.affine_from_ints(points[:n], "cpu"))
    assert tg.xyzz_to_ints(tgf.fft_g1(p, inverse)) == oracle_fft_g1(points[:n], inverse=inverse)


def test_fft_g1_batch_dims_are_independent(points):
    """A (2, 4) batch of length-4 transforms equals each row alone."""
    p = tg.from_affine(tg.affine_from_ints(points[:8], "cpu"))
    p = tg.map_coords(lambda c: c.reshape(c.shape[:-1] + (2, 4)), p)
    got = tg.xyzz_to_ints(tgf.fft_g1(p))
    assert got == oracle_fft_g1(points[:4]) + oracle_fft_g1(points[4:8])


def test_half_convolution_matches_jax(points):
    """fk20_half_convolution at n = 16 against the JAX package's (its jnp
    form on XLA:CPU), and both against the oracle's
    fft_g1(zero_top_half(ifft_g1(.)))."""
    from kzg_tpu.ops import g1 as jg
    from kzg_tpu.ops import g1fft as jgf

    n = 16
    got = tg.xyzz_to_ints(tgf.fk20_half_convolution(tg.from_affine(tg.affine_from_ints(points, "cpu"))))
    want = jg.xyzz_to_ints(jgf.fk20_half_convolution(jg.from_affine(jg.affine_from_ints(points))))
    h = oracle_fft_g1(points, inverse=True)
    h[n // 2 :] = [None] * (n // 2)
    assert got == want == oracle_fft_g1(h)


def test_glv_beta_matches_jax():
    from kzg_tpu.ops import g1fft as jgf

    beta = tgf.glv_beta()
    np.testing.assert_array_equal(FP.const(beta), np.asarray(jgf._glv_beta_mont()).astype(np.int32))
    assert tgf.GLV_LAMBDA == jgf.GLV_LAMBDA


def test_digit_tables_match_jax():
    from kzg_tpu.ops import g1fft as jgf

    rng = np.random.default_rng(3)
    scalars = [0, 1, R - 1, tgf.GLV_LAMBDA, pow(16, R - 2, R)] + [
        int.from_bytes(rng.bytes(32), "little") % R for _ in range(8)
    ]
    for v in scalars:
        assert tgf._glv_digits_host(v) == jgf._glv_digits_host(v)
        assert tgf._signed_digits_host(v, 5) == jgf._signed_digits_host(v, 5)
    for log_n, inverse in ((3, False), (7, True)):
        for (d, s), (jd, js) in zip(tgf._stage_digit_tables(log_n, inverse), jgf._stage_digit_tables(log_n, inverse)):
            np.testing.assert_array_equal(d, jd)
            np.testing.assert_array_equal(s, js)
    for got, want in zip(tgf._half_conv_taps(128), jgf._half_conv_taps(128)):
        np.testing.assert_array_equal(got, want)



# (tables, digit columns D, lanes through src, lanes N[, windows, points]):
# one table or a GLV pair, one digit column or several, src given or not
LADDER_CASES = [(1, 1, False, 5), (1, 3, True, 7), (2, 1, True, 6), (2, 4, False, 8)]
LADDER_WIDE = [
    (2, 5, True, 77),  # lanes past a 32-lane block, the last block ragged
    (2, 65, True, 9 * 128 * 65, 26, 9 * 128),  # the 9-blob half convolution: 65 taps of 1152 points
    (1, 64, False, 64 * 64, 52),  # the last stage of a G1 FFT of the 64 x 128 column points
    (1, 1, False, 64 * 128, 52),  # its inverse's 1/n scale: one digit column for every lane
]


@pytest.fixture
def ladder_device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


def _ladder_inputs(tables, cols, with_src, lanes, windows=3, points=None):
    """Points (an identity among them), signed digits (tables, windows,
    cols) in [-16, 16] with zeros, negatives and both extremes, and the
    lanes' points (`points` of them when given, through src)."""
    rng = np.random.default_rng(7 + 100 * tables + 10 * cols + lanes)
    n_pts = points or (max(2, lanes - 2) if with_src else lanes)
    pts = [G1.mul_scalar(G1_GENERATOR, int(rng.integers(1, 1 << 40))) for _ in range(n_pts)]
    pts[1] = None
    digits = rng.integers(-16, 17, (tables, windows, cols))
    digits[:, -1, 0] = 0  # a top window of zeros: the sum stays the identity past it
    digits.reshape(-1)[1:3] = (-16, 16)
    src = rng.integers(0, n_pts, lanes) if with_src else None
    return pts, digits.astype(np.int32), src


def _plain_loop(p, digits, src):
    """The ladder as it ran before B8: each lane's point gathered first,
    then its own multiples, the phi table of those and the digit columns
    tiled over the lanes, into _ladder, on p's device."""
    lanes = p.x.shape[-1] if src is None else len(src)
    dev = p.x.device
    if src is not None:
        p = tg.map_coords(lambda c: c[..., torch.from_numpy(src).to(dev)], p)
    mult = tgf._multiples(p, 16)
    tables = [mult]
    if digits.shape[0] == 2:
        beta = torch.from_numpy(FP.const(tgf.glv_beta())).reshape(FP.n_limbs, 1, 1).to(dev)
        tables.append(tg.G1XYZZ(fl.mont_mul(FP, mult.x, beta), mult.y, mult.zz, mult.zzz))
    cols = torch.from_numpy(digits[:, :, np.arange(lanes) % digits.shape[2]].astype(np.int64)).to(dev)
    return tgf._ladder(tables, [(d.abs(), d < 0) for d in cols])


@pytest.mark.parametrize(
    "case, ladder_device",
    [(c, "cpu") for c in LADDER_CASES]
    + [pytest.param(c, "cuda", marks=pytest.mark.gpu) for c in LADDER_CASES + LADDER_WIDE],
    indirect=["ladder_device"],
)
def test_ladder_matches_the_plain_loop(case, ladder_device):
    """ladder (B8 on a card, one launch; its plain version on the CPU, no
    launch) limb for limb against the loop it replaced (on the same
    device), and each lane's result against the native core's scalar
    multiply by sum_j d_j 32^j + lambda sum_j d'_j 32^j."""
    pts, digits, src = _ladder_inputs(*case)
    dev = ladder_device
    p = tg.from_affine(tg.affine_from_ints(pts, dev))
    want = _plain_loop(p, digits, src)
    mult = tgf._multiples(p, 16)
    launch.reset_launches()
    got = tgf.ladder(mult, torch.from_numpy(digits).to(dev), None if src is None else torch.from_numpy(src.astype(np.int32)).to(dev))
    assert launch.launches()["g1_ladder"] == (dev.type == "cuda")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    lanes = len(pts) if src is None else len(src)
    scalars = []
    for lane in range(lanes):
        halves = [sum(int(d) << (5 * j) for j, d in enumerate(digits[t, :, lane % digits.shape[2]])) for t in range(digits.shape[0])]
        scalars.append(sum(h * pow(tgf.GLV_LAMBDA, t, R) for t, h in enumerate(halves)) % R)
    points = pts if src is None else [pts[i] for i in src]
    assert tg.xyzz_to_ints(want) == [native.g1_mul(q, k) if q is not None else None for q, k in zip(points, scalars)]


def test_ladder_checks_inputs_and_has_no_fallback():
    p = tg.from_affine(tg.affine_from_ints([G1_GENERATOR, None], "cpu"))
    mult = tgf._multiples(p, 16)
    digits = torch.zeros((2, 3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="digits: shape"):
        tgf.ladder(mult, torch.zeros((3, 3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="dtype"):
        tgf.ladder(mult, digits.long())
    with pytest.raises(ValueError, match="mx: shape"):
        tgf.ladder(tg.map_coords(lambda c: c[:, :16].contiguous(), mult), digits)
    with pytest.raises(ValueError, match="src: shape"):
        tgf.ladder(mult, digits, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tgf.ladder(tg.map_coords(lambda c: c.to("meta"), mult), digits.to("meta"))
    assert launch.launches()["g1_ladder"] == 0
