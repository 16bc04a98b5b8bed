"""kzg_tpu_torch.ops.fft (plain B4 + B5 on the CPU) against the JAX
package's kzg_tpu.ops.fft on XLA:CPU, and each kernel's plain version
against a stage-by-stage Python-int butterfly. Inputs are seeded random
Fr values with the edge values 0, 1 and r - 1. Tolerance: exact (both
sides reduce fully, so Montgomery limbs are compared as they are)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kzg_tpu.ops import fft as jfft
from kzg_tpu_torch.constants import R_MOD as R, root_of_unity
from kzg_tpu_torch.ops import cuda_fft, fft as tfft
from kzg_tpu_torch.ops.field import FR

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once


def _values(seed, count):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(count)]
    edge = [0, 1, R - 1][:count]
    return edge + vals[len(edge):]


def _limbs(seed, B, n):
    return FR.encode_host(_values(seed, B * n)).reshape(16, B, n)


@pytest.mark.parametrize(
    "n, B, inverse",
    [(128, 3, False), (128, 3, True), (4096, 2, True), (8192, 1, False)],
)
def test_fft_matches_jax(n, B, inverse):
    x = _limbs(n + B, B, n)
    got = tfft.fft(torch.from_numpy(x), inverse)
    want = np.asarray(jfft.fft(jnp.asarray(x.astype(np.uint32)), inverse=inverse))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_ifft_inverts_fft_with_batch_dims():
    x = torch.from_numpy(_limbs(5, 6, 256).reshape(16, 2, 3, 256))
    y = tfft.fft(x)
    assert y.shape == x.shape
    assert torch.equal(tfft.ifft(y), x)


def test_brp_indices_match_jax():
    for n in (1, 2, 64, 8192):
        np.testing.assert_array_equal(tfft.brp_indices(n), jfft.brp_indices(n))


def test_lengths_that_are_not_powers_of_two_raise():
    with pytest.raises(ValueError, match="power of two"):
        tfft.fft(torch.zeros((16, 1, 12), dtype=torch.int32))
    x = torch.from_numpy(_limbs(3, 2, 1))
    assert torch.equal(tfft.fft(x, inverse=True), x)


def _butterfly_stages(vals, n, stages, inverse):
    """Python-int DIT stages `stages` over one bit-reversed transform."""
    out = list(vals)
    for s in stages:
        h = 1 << s
        w = root_of_unity(s + 1)
        if inverse:
            w = pow(w, R - 2, R)
        for start in range(0, n, 2 * h):
            for j in range(h):
                a, b = out[start + j], out[start + j + h] * pow(w, j, R) % R
                out[start + j], out[start + j + h] = (a + b) % R, (a - b) % R
    return out


@pytest.mark.parametrize("n, inverse", [(2, False), (64, True), (4096, False), (8192, True)])
def test_tile_plain_matches_python_butterflies(n, inverse):
    """B4's plain version: bit reversal, 1/n for the inverse, stages
    0 .. min(log n, 11) - 1."""
    vals = _values(n, 2 * n)
    got = FR.decode(cuda_fft.ntt_tile(torch.from_numpy(FR.encode_host(vals).reshape(16, 2, n)), inverse))
    log_n = n.bit_length() - 1
    scale = pow(n, R - 2, R) if inverse else 1
    brp = tfft.brp_indices(n)
    want = []
    for b in range(2):
        row = [vals[b * n + int(i)] * scale % R for i in brp]
        want += _butterfly_stages(row, n, range(cuda_fft.tile_stages(log_n)), inverse)
    assert got == want


@pytest.mark.parametrize("s, inverse", [(11, False), (12, True)])
def test_stage_plain_matches_python_butterflies(s, inverse):
    """B5's plain version: one stage above the tile of an 8192 transform."""
    n = 8192
    vals = _values(s, n)
    got = FR.decode(cuda_fft.ntt_stage(torch.from_numpy(FR.encode_host(vals).reshape(16, 1, n)), s, inverse))
    assert got == _butterfly_stages(vals, n, [s], inverse)

