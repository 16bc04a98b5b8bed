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

The ladder is one launch of kernel B8 on the card (`ladder`; its plain
version `_ladder` on the CPU), over the multiples of each distinct point,
built by g1.add_unified (kernel B2 on the card), as the butterflies' and
the tap sum's additions are. Point batches are XYZZ (24, *batch) limb
tensors; everything batches over leading dims.
"""

from functools import lru_cache
from typing import Optional, Tuple

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
from . import g1, launch
from .cuda_fft import bit_reverse
from .field import FP
from .g1 import G1XYZZ, map_coords

TWIDDLE_WINDOW = 5  # digits in [-16, 16]
_TABLE = (1 << (TWIDDLE_WINDOW - 1)) + 1  # a point's multiples 0 .. 16

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


@lru_cache(maxsize=None)
def _beta_limbs(device: str) -> torch.Tensor:
    return fl.to_device(FP.const(glv_beta()), device)


def ladder_ref(mult: G1XYZZ, digits: torch.Tensor, src: Optional[torch.Tensor] = None) -> G1XYZZ:
    """Plain version of B8: each lane's multiples gathered through src,
    the phi table beside them for a GLV split, the lanes' digit columns
    tiled, then _ladder."""
    N = mult.x.shape[-1] if src is None else src.shape[0]
    if src is not None:
        mult = map_coords(lambda c: c[..., src.long()], mult)
    tables = [mult]
    if digits.shape[0] == 2:
        beta = _beta_limbs(str(mult.x.device)).reshape(FP.n_limbs, 1, 1)
        tables.append(G1XYZZ(fl.mont_mul(FP, mult.x, beta), mult.y, mult.zz, mult.zzz))
    cols = digits[:, :, torch.arange(N, device=digits.device) % digits.shape[2]]  # (T, w, N)
    return _ladder(tables, [(d.abs().long(), d < 0) for d in cols])


@launch.counted("g1_ladder")
def ladder(mult: G1XYZZ, digits: torch.Tensor, src: Optional[torch.Tensor] = None) -> G1XYZZ:
    """Fixed-scalar multiplies, one a lane, by the windowed ladder of
    _ladder (c = TWIDDLE_WINDOW): kernel B8 (csrc/g1fft_kernels.cu) for
    CUDA tensors, counted as `launch.g1_ladder`; the plain version,
    ladder_ref, for CPU tensors. Nothing falls back.

    mult: the multiples 0 .. 2^(c-1) of P points, each coordinate a
    contiguous (24, 2^(c-1) + 1, P) int32 tensor (_multiples); digits:
    (T, w, D) int32 signed c-bit digits, table t of lane l reading column
    l mod D, with T = 1, or 2 for a GLV split whose second table is phi of
    mult; src: (N,) int32, the point of each lane, or None for N = P lanes,
    lane l on point l. The digits and src are this module's own tables and
    are not checked on the card. Returns XYZZ (24, N)."""
    dev = mult.x.device
    if mult.x.dim() != 3:
        raise ValueError(f"mx: shape {tuple(mult.x.shape)}, expected (24, m, P)")
    P = mult.x.shape[-1]
    for name, t in zip(("mx", "my", "mzz", "mzzz"), mult):
        launch.check(t, name, torch.int32, (FP.n_limbs, _TABLE, P), dev)
    if digits.dim() != 3 or digits.shape[0] not in (1, 2) or 0 in digits.shape:
        raise ValueError(f"digits: shape {tuple(digits.shape)}, expected (1 or 2, w, D)")
    launch.check(digits, "digits", torch.int32, tuple(digits.shape), dev)
    N = P
    if src is not None:
        if src.dim() != 1:
            raise ValueError(f"src: shape {tuple(src.shape)}, expected (N,)")
        N = src.shape[0]
        launch.check(src, "src", torch.int32, (N,), dev)
    if dev.type == "cpu":
        return ladder_ref(mult, digits, src)
    launch.require_cuda(dev)
    out = [torch.empty((FP.n_limbs, N), dtype=fl.LIMB_DTYPE, device=dev) for _ in range(4)]
    if N == 0:
        return G1XYZZ(*out)
    rows = torch.stack(tuple(mult)).permute(3, 2, 0, 1).contiguous()  # (P, m, 4, 24)
    T, w, D = digits.shape
    rc = launch.kernels().kzg_g1_ladder(
        rows.data_ptr(), digits.data_ptr(), None if src is None else src.data_ptr(),
        _beta_limbs(str(dev)).data_ptr(), *(o.data_ptr() for o in out), T, w, D, N, TWIDDLE_WINDOW,
        launch.stream(),
    )
    tracing.count("launch.g1_ladder")
    launch.check_launch(rc, "g1_ladder")
    return G1XYZZ(*out)


def _signed(digits: np.ndarray, signs: np.ndarray) -> np.ndarray:
    """(|digits|, signs) host tables -> signed int32 digits."""
    return np.ascontiguousarray(np.where(signs, -digits, digits), dtype=np.int32)


def _mul_fixed_scalars(p: G1XYZZ, digits: torch.Tensor) -> G1XYZZ:
    """Each lane of p (24, ..., D) times its fixed scalar, given as signed
    window digits ((1, w, D) on p's device, broadcast over the leading
    dims; D = 1 serves any shape)."""
    flat = map_coords(lambda c: c.reshape(FP.n_limbs, -1), p)
    out = ladder(_multiples(flat, _TABLE - 1), digits)
    return map_coords(lambda c: c.reshape(p.x.shape), out)


# ---------------------------------------------------------------------------
# G1 FFT
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _stage_digits(log_n: int, inverse: bool, s: int, device: str) -> torch.Tensor:
    """Stage s's twiddle digits as B8 takes them, (1, w, 2^s), on `device`."""
    return fl.to_device(_signed(*_stage_digit_tables(log_n, inverse)[s])[None], device)


@lru_cache(maxsize=None)
def _scale_digits(n: int, device: str) -> torch.Tensor:
    """The digits of 1/n as B8 takes them, (1, w, 1), on `device`."""
    digits, signs = _digit_table([pow(n, R - 2, R)], lambda t: _signed_digits_host(t, TWIDDLE_WINDOW))
    return fl.to_device(_signed(digits, signs)[None], device)


def _ifft_scale(p: G1XYZZ) -> G1XYZZ:
    """Scale every lane by the fixed scalar 1/n (n: the last axis); one
    digit column serves every lane."""
    return _mul_fixed_scalars(p, _scale_digits(p.x.shape[-1], str(p.x.device)))


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
    for s in range(log_n):
        h = 1 << s
        parts = [c.reshape(c.shape[:-1] + (n >> (s + 1), 2, h)) for c in p]
        a = G1XYZZ(*(c[..., 0, :] for c in parts))
        b = G1XYZZ(*(c[..., 1, :] for c in parts))
        t = b if s == 0 else _mul_fixed_scalars(b, _stage_digits(log_n, inverse, s, str(p.x.device)))
        lo = g1.add_unified(a, t)
        hi = g1.add_unified(a, g1.neg(t))
        # (..., blocks, 2, h) -> (..., n): the in-place DIT layout
        p = G1XYZZ(*(torch.stack([u, v], dim=-2).reshape(u.shape[:-2] + (n,)) for u, v in zip(lo, hi)))
    if inverse:
        p = _ifft_scale(p)
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


@lru_cache(maxsize=None)
def _half_conv_lanes(n: int, batch: int, device: str):
    """B8's tables for `batch` half convolutions of length n, on `device`:
    the taps' GLV digits (2, w, n/2 + 1) and the point of each lane (k,
    d) of each convolution b, lane (b n + k)(n/2 + 1) + d: point b n + (k -
    offset d) mod n."""
    offsets, d1, s1, d2, s2 = _half_conv_taps(n)
    src = (np.arange(n)[:, None] - offsets[None, :]) % n  # (n, taps)
    src = (np.arange(batch)[:, None, None] * n + src[None]).reshape(-1).astype(np.int32)
    return fl.to_device(np.stack([_signed(d1, s1), _signed(d2, s2)]), device), fl.to_device(src, device)


@tracing.span("kzg.g1fft")
def fk20_half_convolution(h_ext: G1XYZZ) -> G1XYZZ:
    """fft_g1(zero_top_half(ifft_g1(h_ext))) along the last axis as ONE
    circulant convolution with n/2 + 1 fixed taps:
    out[k] = sum_d m[d] * h_ext[k - d]. The multiples are built once a
    point, and one B8 launch multiplies every (point, tap) lane."""
    shape = h_ext.x.shape
    n = shape[-1]
    taps = n // 2 + 1
    digits, src = _half_conv_lanes(n, h_ext.x[0].numel() // n, str(h_ext.x.device))
    pts = map_coords(lambda c: c.reshape(FP.n_limbs, -1), h_ext)
    prods = ladder(_multiples(pts, _TABLE - 1), digits, src)  # (24, lanes)
    prods = map_coords(lambda c: c.reshape(shape + (taps,)), prods)
    return map_coords(lambda c: c[..., 0], g1.tree_reduce(prods))
