"""Polynomial arithmetic over Fr in PyTorch: products, power-series
inverses, division, evaluation and vanishing polynomials of coefficient
arrays. The counterpart of the JAX package's ops/poly.py.

Values are (16, *batch, n) int32 limb tensors in Montgomery form, the
coefficients along the last axis (lowest degree first); batch dims are
independent polynomials. Products go through ops/fft.py (kernels B4 and
B5 on the card), the rest through ops/field.py. Every size is fixed by the
input shapes: a divisor's length is its degree + 1 (its last coefficient
nonzero), which the protocol's divisors (X^n - x^n, vanishing
polynomials) have by construction.
"""

import torch

from . import field as fl
from .fft import fft, ifft
from .field import FR

L = FR.n_limbs


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """x cut or zero-padded to length n along the last axis."""
    if n <= x.shape[-1]:
        return x[..., :n]
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (n - x.shape[-1],))], dim=-1)


def poly_mul_fft(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """The product of a (16, *batch, na) and b (16, *batch, nb), cut or
    zero-padded to out_len coefficients."""
    n = _pow2_at_least(a.shape[-1] + b.shape[-1])
    prod = ifft(fl.mont_mul(FR, fft(_pad_last(a, n)), fft(_pad_last(b, n))))
    return _pad_last(prod, out_len)


def poly_inverse(a: torch.Tensor, out_len: int) -> torch.Tensor:
    """The power-series inverse of a (16, *batch, n) mod X^out_len, by
    Newton doubling: acc <- acc (2 - a acc) mod X^k for k = 2, 4, ...
    a[..., 0] must be invertible."""
    acc, _ = fl.batch_inv_tree(FR, a[..., :1])
    two = fl.to_device(FR.const(2), a.device).reshape((L,) + (1,) * (a.dim() - 1))
    k = 1
    while k < out_len:
        k = min(2 * k, out_len)
        t = fl.neg(FR, poly_mul_fft(_pad_last(a, min(k, a.shape[-1])), acc, k))
        t = torch.cat([fl.add(FR, t[..., :1], two), t[..., 1:]], dim=-1)
        acc = poly_mul_fft(acc, t, k)
    return _pad_last(acc, out_len)


def poly_fast_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The quotient num / den, (16, *batch, nl - dl + 1), by reversal and
    the power-series inverse of the reversed divisor. den's last
    coefficient must be nonzero; nl >= dl."""
    nl, dl = num.shape[-1], den.shape[-1]
    if dl > nl:
        raise ValueError("poly_fast_div: divisor longer than dividend")
    if dl == 1:
        dinv, _ = fl.batch_inv_tree(FR, den[..., :1])
        return fl.mont_mul(FR, num, dinv)
    qlen = nl - dl + 1
    dinv = poly_inverse(torch.flip(den, dims=[-1]), qlen)
    return torch.flip(poly_mul_fft(torch.flip(num, dims=[-1]), dinv, qlen), dims=[-1])


def poly_eval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """coeffs (16, *batch, n) at x (16, *batch, 1): the powers of x by
    doubling blocks (log n rounds), then a tree sum of the terms. Returns
    (16, *batch, 1)."""
    np2 = _pow2_at_least(max(coeffs.shape[-1], 1))
    coeffs = _pad_last(coeffs, np2)
    pows = fl.one_like(FR, x)
    sq = x
    while pows.shape[-1] < np2:
        pows = torch.cat([pows, fl.mont_mul(FR, pows, sq)], dim=-1)
        sq = fl.mont_mul(FR, sq, sq)
    return fl.sum_tree(FR, fl.mont_mul(FR, coeffs, pows))


def vanishing_poly(roots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The monic product of (X - r) over the valid roots, as a tree of
    batched products. roots: (16, *batch, m) Montgomery; valid: (*batch, m)
    bool, where an invalid slot is the factor 1, so that any count of roots
    runs at one shape. Returns (16, *batch, m + 1), of degree the count of
    valid roots."""
    m = roots.shape[-1]
    mp = _pow2_at_least(max(m, 1))
    negr = fl.neg(FR, _pad_last(roots, mp))
    validp = torch.cat([valid, valid.new_zeros(valid.shape[:-1] + (mp - m,))], dim=-1).unsqueeze(0)
    one = fl.one_like(FR, negr)
    # leaf factors: a valid root gives X - r = [-r, 1], an invalid slot [1, 0]
    c0 = torch.where(validp, negr, one)
    c1 = torch.where(validp, one, torch.zeros_like(negr))
    polys = torch.stack([c0, c1], dim=-1)  # (16, *batch, mp, 2)
    width = 2
    while polys.shape[-2] > 1:
        # a product of two factors of length width has length 2 width - 1
        polys = poly_mul_fft(polys[..., 0::2, :], polys[..., 1::2, :], 2 * width - 1)
        width = 2 * width - 1
    return _pad_last(polys[..., 0, :], m + 1)
