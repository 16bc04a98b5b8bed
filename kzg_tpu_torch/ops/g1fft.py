"""Radix-2 FFT over G1 points, and the FK20 half-zeroing convolution, in
PyTorch. The counterpart of the JAX package's ops/g1fft.py, with the same
algorithm:

  - an iterative stage loop over bit-reversed input, as the Fr FFT;
  - the twiddles are host constants (roots of unity), so each is given as
    signed window digits (c = 5, digits in [-16, 16]) and a twiddle
    multiply is a windowed double-and-add over the 16 multiples of the
    lane's point, all lanes at once;
  - the convolution's taps are split by the GLV endomorphism
    phi(x, y) = (beta x, y) = lambda P into two ~128-bit halves that share
    one table of multiples, halving the ladder's depth.

Additions go through g1.add_unified (kernel B2 on the card); doublings,
gathers and selects are plain PyTorch. Point batches are XYZZ (24, *batch)
limb tensors; everything batches over leading dims.
"""

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import native, tracing
from ..constants import (
    BLS_X,
    G1_GENERATOR_X,
    G1_GENERATOR_Y,
    P_MOD,
    R_MOD as R,
    root_of_unity,
)
from . import field as fl
from . import g1
from .cuda_fft import bit_reverse
from .field import FP
from .g1 import G1XYZZ, map_coords

TWIDDLE_WINDOW = 5  # digits in [-16, 16]

# ---------------------------------------------------------------------------
# GLV: phi(x, y) = (beta x, y) satisfies phi(P) = lambda P with
# lambda = x_bls^2 - 1 (r = x^4 - x^2 + 1, so lambda^2 + lambda + 1 = 0 mod
# r). A fixed scalar t splits as t1 + t2 lambda by divmod (t1 < lambda ~
# 2^127, t2 <= r / lambda ~ 2^129).
# ---------------------------------------------------------------------------

GLV_LAMBDA = (BLS_X * BLS_X - 1) % R
assert (GLV_LAMBDA * GLV_LAMBDA + GLV_LAMBDA + 1) % R == 0


@lru_cache(maxsize=None)
def glv_beta() -> int:
    """The cube root of unity in Fp that matches lambda: beta * x(G) ==
    x(lambda G), with lambda G from the native core's scalar multiply."""
    g = 2
    while pow(g, (P_MOD - 1) // 3, P_MOD) == 1:
        g += 1
    root = pow(g, (P_MOD - 1) // 3, P_MOD)
    lam_g = native.g1_mul((G1_GENERATOR_X, G1_GENERATOR_Y), GLV_LAMBDA)
    for beta in (root, root * root % P_MOD):
        if lam_g == (beta * G1_GENERATOR_X % P_MOD, G1_GENERATOR_Y):
            return beta
    raise RuntimeError("no cube root of unity in Fp matches the GLV lambda")


def _glv_digits_host(value: int, c: int = TWIDDLE_WINDOW):
    """Fixed scalar -> (digits1, digits2) of t = t1 + t2 lambda, each
    ceil(130 / c) signed c-bit windows."""
    t2, t1 = divmod(value % R, GLV_LAMBDA)
    # both halves < 2^129
    return _signed_digits_host(t1, c, bits=130), _signed_digits_host(t2, c, bits=130)


def _signed_digits_host(value: int, c: int, bits: int = 256):
    """Signed c-bit windows of a scalar below 2^(bits - 1): ceil(bits / c)
    windows, so the top window always has room for the last borrow."""
    w = -(-bits // c)
    half, full = 1 << (c - 1), 1 << c
    digits = []
    carry = 0
    for j in range(w):
        d = ((value >> (c * j)) & (full - 1)) + carry
        carry = int(d > half)
        digits.append(d - full if carry else d)
    if carry or sum(x << (c * j) for j, x in enumerate(digits)) != value:
        raise ValueError("signed digit encoding overflowed")
    return digits


def _digit_table(scalars, split) -> Tuple[np.ndarray, np.ndarray]:
    """Scalars -> (|digits| (w, count) int64, signs (w, count) bool)."""
    d = np.array([split(s) for s in scalars], dtype=np.int64).T
    return np.abs(d), d < 0


@lru_cache(maxsize=None)
def _stage_digit_tables(log_n: int, inverse: bool, c: int = TWIDDLE_WINDOW):
    """Per stage s (h = 2^s twiddles w^0 .. w^(h-1) of the 2^(s+1)-th root
    w): (|digits| (w, h), signs (w, h))."""
    out = []
    for s in range(log_n):
        wroot = root_of_unity(s + 1)
        if inverse:
            wroot = pow(wroot, R - 2, R)
        tws = [pow(wroot, j, R) for j in range(1 << s)]
        out.append(_digit_table(tws, lambda t: _signed_digits_host(t, c)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Fixed-scalar ladders
# ---------------------------------------------------------------------------


def _multiples(p: G1XYZZ, count: int) -> G1XYZZ:
    """m * p for m = 0 .. count, stacked on axis 1: (24, count + 1, *batch)."""
    mult = [g1.infinity(p.x.shape[1:], p.x.device)]
    for _ in range(count):
        mult.append(g1.add_unified(mult[-1], p))
    return G1XYZZ(*(torch.stack([m[k] for m in mult], dim=1) for k in range(4)))


def _select(mult: G1XYZZ, idx: torch.Tensor, neg: torch.Tensor) -> G1XYZZ:
    """Lane-wise mult[idx], negated where `neg`; idx and neg broadcast to
    the lanes' batch shape."""
    batch = mult.x.shape[2:]
    ix = idx.expand(batch).reshape((1, 1) + tuple(batch)).expand((FP.n_limbs, 1) + tuple(batch))
    sel = G1XYZZ(*(torch.gather(m, 1, ix)[:, 0] for m in mult))
    return G1XYZZ(sel.x, fl.select(neg.expand(batch), fl.neg(FP, sel.y), sel.y), sel.zz, sel.zzz)


def _ladder(tables, digit_sets) -> G1XYZZ:
    """Windowed double-and-add from the top window: c doublings, then one
    complete addition per (table, digits) pair. digit_sets: (|digits|,
    signs) as (w, ...) tensors on the device, one per table."""
    c = TWIDDLE_WINDOW
    batch = tables[0].x.shape[2:]
    acc = g1.infinity(batch, tables[0].x.device)
    w = digit_sets[0][0].shape[0]
    for j in range(w - 1, -1, -1):
        for _ in range(c):
            acc = g1.dbl(acc)
        for mult, (digs, sgns) in zip(tables, digit_sets):
            acc = g1.add_unified(acc, _select(mult, digs[j], sgns[j]))
    return acc


def _on(dev, digits: np.ndarray, signs: np.ndarray):
    return fl.to_device(digits, dev), fl.to_device(signs, dev)


def _mul_fixed_scalars(p: G1XYZZ, digits: np.ndarray, signs: np.ndarray) -> G1XYZZ:
    """Each lane of p (24, ..., h) times its fixed scalar, given as signed
    window digits ((w, h) host arrays, broadcast over the leading dims)."""
    mult = _multiples(p, 1 << (TWIDDLE_WINDOW - 1))
    return _ladder([mult], [_on(p.x.device, digits, signs)])


def _mul_fixed_scalars_glv(p: G1XYZZ, digs1, sgns1, digs2, sgns2) -> G1XYZZ:
    """GLV-split fixed-scalar multiply: each lane times t1 + t2 lambda, with
    one table of multiples shared by both halves (phi maps the multiples
    for one product per point: x *= beta)."""
    mult = _multiples(p, 1 << (TWIDDLE_WINDOW - 1))
    beta = fl.to_device(FP.const(glv_beta()), p.x.device)
    beta = beta.reshape((FP.n_limbs,) + (1,) * (mult.x.dim() - 1))
    mult_phi = G1XYZZ(fl.mont_mul(FP, mult.x, beta), mult.y, mult.zz, mult.zzz)
    dev = p.x.device
    return _ladder([mult, mult_phi], [_on(dev, digs1, sgns1), _on(dev, digs2, sgns2)])


# ---------------------------------------------------------------------------
# G1 FFT
# ---------------------------------------------------------------------------


def _ifft_scale(p: G1XYZZ, ninv: int) -> G1XYZZ:
    """Scale every lane by the fixed scalar 1/n."""
    digits, signs = _digit_table([ninv], lambda t: _signed_digits_host(t, TWIDDLE_WINDOW))
    return _mul_fixed_scalars(p, digits, signs)  # (w, 1) broadcasts over the lanes


@tracing.span("kzg.g1fft")
def fft_g1(p: G1XYZZ, inverse: bool = False) -> G1XYZZ:
    """Radix-2 FFT over G1 along the last axis (n a power of two), the
    inverse with the inverse roots and the 1/n scale. Stage 0's twiddle is
    one, so its products are skipped (the same points, in another XYZZ
    representation)."""
    n = p.x.shape[-1]
    if n & (n - 1) or n == 0:
        raise ValueError(f"fft_g1: length {n} is not a power of two")
    log_n = n.bit_length() - 1
    p = map_coords(bit_reverse, p)
    tables = _stage_digit_tables(log_n, inverse)
    for s in range(log_n):
        h = 1 << s
        parts = [c.reshape(c.shape[:-1] + (n >> (s + 1), 2, h)) for c in p]
        a = G1XYZZ(*(c[..., 0, :] for c in parts))
        b = G1XYZZ(*(c[..., 1, :] for c in parts))
        t = b if s == 0 else _mul_fixed_scalars(b, *tables[s])
        lo = g1.add_unified(a, t)
        hi = g1.add_unified(a, g1.neg(t))
        # (..., blocks, 2, h) -> (..., n): the in-place DIT layout
        p = G1XYZZ(*(torch.stack([u, v], dim=-2).reshape(u.shape[:-2] + (n,)) for u, v in zip(lo, hi)))
    if inverse:
        p = _ifft_scale(p, pow(n, R - 2, R))
    return p


# ---------------------------------------------------------------------------
# FK20 half-zeroing convolution: FFT . zero_top_half . IFFT as one circulant
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _half_conv_taps(n: int):
    """Taps of the circulant M = F . diag([1]*n/2 + [0]*n/2) . F^-1:
    m[0] = 1/2, m[d] = 0 for even d != 0, m[d] = -(2/n) / (w^d - 1) for
    odd d. Returns (offsets (n/2 + 1,), then |digits| and signs (w, taps)
    of the two GLV halves)."""
    w_root = root_of_unity(n.bit_length() - 1)
    two_over_n = 2 * pow(n, R - 2, R) % R
    offsets = [0] + [d for d in range(1, n) if d % 2 == 1]
    taps = [pow(2, R - 2, R)]
    for d in offsets[1:]:
        taps.append((-two_over_n) * pow(pow(w_root, d, R) - 1, R - 2, R) % R)
    halves = [_glv_digits_host(t) for t in taps]
    d1, s1 = _digit_table([h[0] for h in halves], lambda v: v)
    d2, s2 = _digit_table([h[1] for h in halves], lambda v: v)
    return np.array(offsets, dtype=np.int64), d1, s1, d2, s2


@tracing.span("kzg.g1fft")
def fk20_half_convolution(h_ext: G1XYZZ) -> G1XYZZ:
    """fft_g1(zero_top_half(ifft_g1(h_ext))) along the last axis as ONE
    circulant convolution with n/2 + 1 fixed taps:
    out[k] = sum_d m[d] * h_ext[k - d]."""
    n = h_ext.x.shape[-1]
    offsets, d1, s1, d2, s2 = _half_conv_taps(n)
    taps = offsets.shape[0]
    src = (np.arange(n)[:, None] - offsets[None, :]) % n  # (n, taps)
    src = fl.to_device(src.reshape(-1), h_ext.x.device)
    gathered = map_coords(lambda c: c[..., src], h_ext)  # (..., n * taps)

    def tile(t):  # (w, taps) -> (w, n * taps), lane k * taps + d
        return np.tile(t[:, None, :], (1, n, 1)).reshape(t.shape[0], n * taps)

    prods = _mul_fixed_scalars_glv(gathered, tile(d1), tile(s1), tile(d2), tile(s2))
    prods = map_coords(lambda c: c.reshape(c.shape[:-1] + (n, taps)), prods)
    return map_coords(lambda c: c[..., 0], g1.tree_reduce(prods))
