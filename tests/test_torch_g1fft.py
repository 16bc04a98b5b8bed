"""kzg_tpu_torch.ops.g1fft against the oracle's G1 FFT and the JAX
package's kzg_tpu.ops.g1fft, on the CPU. Points are compared as affine
ints (XYZZ coordinates are not unique); host tables exactly."""

import numpy as np
import pytest
import torch

from kzg_tpu.constants import R_MOD as R
from kzg_tpu.ops import g1 as jg
from kzg_tpu.ops import g1fft as jgf
from kzg_tpu.oracle.curve import G1, G1_GENERATOR
from kzg_tpu.oracle.fft import fft_g1 as oracle_fft_g1
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.ops import g1fft as tgf
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
    n = 16
    got = tg.xyzz_to_ints(tgf.fk20_half_convolution(tg.from_affine(tg.affine_from_ints(points, "cpu"))))
    want = jg.xyzz_to_ints(jgf.fk20_half_convolution(jg.from_affine(jg.affine_from_ints(points))))
    h = oracle_fft_g1(points, inverse=True)
    h[n // 2 :] = [None] * (n // 2)
    assert got == want == oracle_fft_g1(h)


def test_glv_beta_matches_jax():
    beta = tgf.glv_beta()
    np.testing.assert_array_equal(FP.const(beta), np.asarray(jgf._glv_beta_mont()).astype(np.int32))
    assert tgf.GLV_LAMBDA == jgf.GLV_LAMBDA


def test_digit_tables_match_jax():
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

