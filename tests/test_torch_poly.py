"""kzg_tpu_torch's polynomial ops and das_extension on the CPU, exact
against the JAX package's oracle (kzg_tpu/oracle/poly.py, oracle/das.py,
oracle/fft.py) at several lengths, and once against the JAX package's
jitted poly_fast_div on XLA:CPU at a small size. Values go in as canonical
ints and are compared as canonical ints."""

import random

import numpy as np
import pytest
import torch

from kzg_tpu.oracle import poly as opoly
from kzg_tpu.oracle.das import compute_vanishing_polynomial_from_roots
from kzg_tpu.oracle.fft import das_fft_extension, fft_fr
from kzg_tpu.ops import poly as jpoly
from kzg_tpu.ops.fft import fr_from_ints as j_from_ints, fr_to_ints as j_to_ints
from kzg_tpu_torch.constants import R_MOD as R, root_of_unity
from kzg_tpu_torch.ops import poly as tp
from kzg_tpu_torch.ops.fft import das_extension
from kzg_tpu_torch.ops.field import FR

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once


def rand_poly(rng, n, monic=False):
    c = [rng.randrange(R) for _ in range(n)]
    if monic:
        c[-1] = 1 + rng.randrange(R - 1)
    return c


def enc(*polys):
    """Polynomials of one length -> Montgomery limbs (16, len(polys), n)."""
    n = len(polys[0])
    return torch.from_numpy(FR.encode_host([v for p in polys for v in p]).reshape(16, len(polys), n))


def dec(t):
    """(16, B, n) Montgomery limbs -> B lists of canonical ints."""
    flat = FR.decode(t)
    n = t.shape[-1]
    return [flat[b * n : (b + 1) * n] for b in range(len(flat) // n)]


@pytest.mark.parametrize("na, nb, out_len", [(1, 1, 1), (3, 5, 7), (37, 91, 127), (64, 64, 100), (200, 7, 256)])
def test_poly_mul_fft_matches_oracle(na, nb, out_len):
    rng = random.Random(na * 1000 + nb)
    a = [rand_poly(rng, na), rand_poly(rng, na)]
    b = [rand_poly(rng, nb), rand_poly(rng, nb)]
    got = dec(tp.poly_mul_fft(enc(*a), enc(*b), out_len))
    assert got == [opoly.poly_mul_fft(x, y, out_len) for x, y in zip(a, b)]


@pytest.mark.parametrize("n, out_len", [(1, 5), (5, 1), (16, 16), (64, 64), (30, 100)])
def test_poly_inverse_matches_oracle(n, out_len):
    rng = random.Random(n + out_len)
    a = rand_poly(rng, n)
    a[0] |= 1  # a nonzero constant term
    assert dec(tp.poly_inverse(enc(a), out_len)) == [opoly.poly_inverse(a, out_len)]


@pytest.mark.parametrize("nl, dl", [(200, 67), (50, 1), (17, 17), (40, 2), (300, 129)])
def test_poly_fast_div_matches_long_division(nl, dl):
    rng = random.Random(nl * dl)
    num = [rand_poly(rng, nl), rand_poly(rng, nl)]
    den = [rand_poly(rng, dl, monic=True), rand_poly(rng, dl, monic=True)]
    got = dec(tp.poly_fast_div(enc(*num), enc(*den)))
    assert got == [opoly.poly_long_div(a, b) for a, b in zip(num, den)]


@pytest.mark.parametrize("n", [4, 16, 64])
def test_poly_fast_div_by_the_multiproof_divisor(n):
    """The length-(n + 1) divisor X^n - x^n of a multiproof: the quotient
    equals long division, and quotient times divisor plus remainder is the
    dividend."""
    rng = random.Random(n)
    num = rand_poly(rng, 4 * n + 3)
    x = rng.randrange(1, R)
    den = [(R - pow(x, n, R)) % R] + [0] * (n - 1) + [1]
    (q,) = dec(tp.poly_fast_div(enc(num), enc(den)))
    assert q == opoly.poly_long_div(num, den)
    prod = opoly.poly_mul_direct(q, den, len(num))
    rem = [(a - b) % R for a, b in zip(num, prod)]
    assert all(r == 0 for r in rem[n:])


def test_poly_fast_div_rejects_a_longer_divisor():
    with pytest.raises(ValueError, match="divisor longer than dividend"):
        tp.poly_fast_div(enc([1, 2]), enc([1, 2, 3]))


@pytest.mark.parametrize("n", [1, 2, 5, 33, 100])
def test_poly_eval_matches_oracle(n):
    rng = random.Random(n)
    c = [rand_poly(rng, n), rand_poly(rng, n)]
    xs = [rng.randrange(R), rng.randrange(R)]
    got = dec(tp.poly_eval(enc(*c), enc(*([x] for x in xs))))
    assert got == [[opoly.poly_eval(cc, x)] for cc, x in zip(c, xs)]


@pytest.mark.parametrize("m, masked", [(1, ()), (5, (1, 3)), (8, ()), (64, tuple(range(0, 64, 3))), (64, tuple(range(64)))])
def test_vanishing_poly_matches_oracle(m, masked):
    """Masked slots are the factor 1: the result is the oracle's product
    over the valid roots, zero-padded to m + 1 (all masked: the constant 1).
    The second lane takes the roots of 64 missing cells as recovery does."""
    rng = random.Random(m + len(masked))
    roots = [rand_poly(rng, m), [pow(root_of_unity(7), i, R) for i in range(m)]]
    valid = torch.ones(2, m, dtype=torch.bool)
    valid[0, list(masked)] = False
    got = dec(tp.vanishing_poly(enc(*roots), valid))
    for b in range(2):
        kept = [r for i, r in enumerate(roots[b]) if bool(valid[b, i])]
        want = compute_vanishing_polynomial_from_roots(kept) if kept else [1]
        assert got[b] == want + [0] * (m + 1 - len(want))


@pytest.mark.parametrize("n", [2, 16, 256])
def test_das_extension_matches_oracle(n):
    """The odd points of the 2n-domain: as the oracle's das_fft_extension,
    and as the odd half of the FFT of 2n of the zero-padded coefficients."""
    rng = random.Random(n)
    evens = [rand_poly(rng, n), rand_poly(rng, n)]
    got = dec(das_extension(enc(*evens)))
    for b in range(2):
        assert got[b] == das_fft_extension(evens[b])
        coeffs = fft_fr(evens[b], inverse=True)
        assert got[b] == fft_fr(coeffs + [0] * n)[1::2]


def test_poly_fast_div_matches_the_jax_package():
    """One call of the JAX package's jitted poly_fast_div (two Newton
    steps, on XLA:CPU), limb for limb against the port on a batch of two."""
    rng = random.Random(2)
    num = [rand_poly(rng, 6), rand_poly(rng, 6)]
    den = [rand_poly(rng, 3, monic=True), rand_poly(rng, 3, monic=True)]
    want = jpoly.poly_fast_div_jit(
        j_from_ints([v for p in num for v in p]).reshape(16, 2, 6),
        j_from_ints([v for p in den for v in p]).reshape(16, 2, 3),
    )
    got = tp.poly_fast_div(enc(*num), enc(*den))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert dec(got) == [opoly.poly_long_div(a, b) for a, b in zip(num, den)]
    assert j_to_ints(np.asarray(want).reshape(16, -1)) == [v for q in dec(got) for v in q]
