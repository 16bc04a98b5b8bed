"""Erasure recovery of a blob's polynomial from half its cells or more, as
Fulu's polynomial-commitments-sampling.md defines it
(`construct_vanishing_polynomial`, `coset_fft_field`,
`recover_polynomialcoeff`), in Python integers, independent of the
program.

The missing cells' vanishing polynomial is Z(X) = short(X^64), short the
product of (X - w^reverse_bits(k)) over the missing cells k (w a 128th
root of unity): cell k's 64 points are the roots of X^64 - w^reverse_bits(k).
The extension E, zero where a cell is missing, times Z agrees with P Z on
the 8192-point domain, and P Z has degree below 8192, so an inverse NTT
gives its coefficients; P = (P Z) / Z is divided on the coset 7 <w>, where Z
has no zero. Z's evaluations on the domain and its inverses on the coset
depend only on which cells are missing, so they are worked out once per
missing set (`vanishing`). The call's cells then follow from
`kzg.cells_from_coeffs`.
"""

from functools import lru_cache

from .fields import PRIMITIVE_ROOT, R, batch_inverse, bit_reversal_permutation, ntt, reverse_bits, roots_of_unity
from .kzg import CELL, CELLS, N, N_EXT


def vanishing_polynomialcoeff(xs: list) -> list:
    """The coefficients of the product of (X - x) over xs, lowest first."""
    p = [1]
    for x in xs:
        out = [0] * (len(p) + 1)
        for i, c in enumerate(p):
            out[i] = (out[i] - x * c) % R
            out[i + 1] = (out[i + 1] + c) % R
        p = out
    return p


def construct_vanishing_polynomial(missing: list) -> list:
    """Z's 8192 coefficients for the missing cell indices."""
    roots = roots_of_unity(CELLS)
    bits = CELLS.bit_length() - 1
    short = vanishing_polynomialcoeff([roots[reverse_bits(k, bits)] for k in missing])
    z = [0] * N_EXT
    for i, c in enumerate(short):
        z[i * CELL] = c
    return z


def _shift(values: list, factor: int) -> list:
    out, f = [], 1
    for v in values:
        out.append(v * f % R)
        f = f * factor % R
    return out


def coset_fft_field(values: list, inv: bool = False) -> list:
    """Evaluations on the coset 7 <w> of the polynomial with coefficients
    `values`, or with `inv` the coefficients of the polynomial with those
    evaluations."""
    if inv:
        return _shift(ntt(values, inverse=True), pow(PRIMITIVE_ROOT, R - 2, R))
    return ntt(_shift(values, PRIMITIVE_ROOT))


@lru_cache(maxsize=4)
def vanishing(missing: tuple) -> tuple:
    """(Z on the domain, 1 / Z on the coset) for the missing cell indices."""
    z = construct_vanishing_polynomial(list(missing))
    return ntt(z), batch_inverse(coset_fft_field(z))


def recover_polynomialcoeff(cell_indices: list, cells: list) -> list:
    """The blob's 4096 monomial coefficients from its cells at
    `cell_indices` (each a list of 64 field elements, in the cell's
    order), at least 64 of the 128."""
    if len(set(cell_indices)) < CELLS // 2:
        raise ValueError("fewer than 64 distinct cells")
    ext_rbo = [0] * N_EXT
    for k, values in zip(cell_indices, cells):
        ext_rbo[k * CELL : (k + 1) * CELL] = values
    ext = bit_reversal_permutation(ext_rbo)
    given = set(cell_indices)
    z_eval, z_coset_inv = vanishing(tuple(k for k in range(CELLS) if k not in given))
    ez_coeffs = ntt([a * b % R for a, b in zip(z_eval, ext)], inverse=True)
    quotient = [a * b % R for a, b in zip(coset_fft_field(ez_coeffs), z_coset_inv)]
    return coset_fft_field(quotient, inv=True)[:N]
