"""Batched G1 point arithmetic on extended XYZZ coordinates, in PyTorch.

The counterpart of the JAX package's ops/g1.py, with the same formulas in
the same multiplication rounds, so that points come out limb for limb the
same:
  - XYZZ point batch: (x, y, zz, zzz), each a (24, *batch) int32 limb
    tensor in Montgomery form; the identity is encoded as zz == 0
    (x = X/ZZ, y = Y/ZZZ with ZZ^3 = ZZZ^2).
  - Affine point batch: (x, y, inf) with inf a (*batch,) bool mask.

Additions are unified: identity operands, P == Q and P == -Q resolve
through masked selects, never branches.

`add_unified` is the complete addition every caller uses. On a CUDA
tensor it launches the hand-written kernel (ops/cuda_msm.add_points),
whatever the batch size; on a CPU tensor it runs `add_unified_plain`.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from . import cuda_msm
from . import field as fl
from .field import FP


class G1XYZZ(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    zz: torch.Tensor
    zzz: torch.Tensor


class G1Aff(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor  # bool, batch shape


def _mul_many(pairs):
    return fl.mul_many(FP, pairs)


def _add(a, b):
    return fl.add(FP, a, b)


def _sub(a, b):
    return fl.sub(FP, a, b)


def infinity(batch_shape, device) -> G1XYZZ:
    z = torch.zeros((FP.n_limbs,) + tuple(batch_shape), dtype=fl.LIMB_DTYPE, device=device)
    return G1XYZZ(z, z, z, z)


def is_inf(p: G1XYZZ) -> torch.Tensor:
    return fl.is_zero(FP, p.zz)


def select_point(mask, a: G1XYZZ, b: G1XYZZ) -> G1XYZZ:
    return G1XYZZ(*(fl.select(mask, u, v) for u, v in zip(a, b)))


def map_coords(fn, p):
    """Apply fn to every coordinate tensor of a point batch."""
    return type(p)(*(fn(c) for c in p))


def neg(p: G1XYZZ) -> G1XYZZ:
    return G1XYZZ(p.x, fl.neg(FP, p.y), p.zz, p.zzz)


def from_affine(a: G1Aff) -> G1XYZZ:
    zz = torch.where(a.inf.unsqueeze(0), torch.zeros_like(a.x), fl.one_like(FP, a.x))
    return G1XYZZ(a.x, a.y, zz, zz)


def dbl(p: G1XYZZ) -> G1XYZZ:
    """XYZZ doubling (dbl-2008-s, a = 0): 6M + 3S in 4 stacked product
    rounds. The identity doubles to the identity (zz3 = V * zz = 0)."""
    u = _add(p.y, p.y)
    v, xx = _mul_many([(u, u), (p.x, p.x)])
    w, s = _mul_many([(u, v), (p.x, v)])
    m = _add(_add(xx, xx), xx)
    mm, wy, zz3, zzz3 = _mul_many([(m, m), (w, p.y), (v, p.zz), (w, p.zzz)])
    x3 = _sub(mm, _add(s, s))
    (y3a,) = _mul_many([(m, _sub(s, x3))])
    return G1XYZZ(x3, _sub(y3a, wy), zz3, zzz3)


def dbl_n(p: G1XYZZ, n: int) -> G1XYZZ:
    """2^n p by n doublings."""
    for _ in range(n):
        p = dbl(p)
    return p


def add_unified_plain(p: G1XYZZ, q: G1XYZZ) -> G1XYZZ:
    """Branchless complete XYZZ addition (add-2008-s plus the doubling of
    p), in 4 stacked product rounds with the doubling's rounds fused in, as
    ops/g1.py:add_unified of the JAX package. P == -Q lands on the identity
    (PP == 0 -> zz3 == 0); P == Q takes the doubling; identity operands are
    selected through."""
    u = _add(p.y, p.y)
    out = _mul_many(
        [(p.x, q.zz), (q.x, p.zz), (p.y, q.zzz), (q.y, p.zzz), (u, u), (p.x, p.x)]
    )
    u1, u2, s1, s2, v, xx = out
    pd = _sub(u2, u1)
    r = _sub(s2, s1)

    inf1 = is_inf(p)
    inf2 = is_inf(q)
    both = ~inf1 & ~inf2
    need_dbl = both & fl.is_zero(FP, pd) & fl.is_zero(FP, r)

    pp, w, s = _mul_many([(pd, pd), (u, v), (p.x, v)])
    m = _add(_add(xx, xx), xx)
    ppp, q0, zza, zzza, rr, mm, wy, zz3d, zzz3d = _mul_many(
        [(pd, pp), (u1, pp), (p.zz, q.zz), (p.zzz, q.zzz), (r, r),
         (m, m), (w, p.y), (v, p.zz), (w, p.zzz)]
    )
    x3 = _sub(_sub(rr, ppp), _add(q0, q0))
    x3d = _sub(mm, _add(s, s))
    y3a, sppp, zz3, zzz3, y3da = _mul_many(
        [(r, _sub(q0, x3)), (s1, ppp), (zza, pp), (zzza, ppp), (m, _sub(s, x3d))]
    )
    res = G1XYZZ(x3, _sub(y3a, sppp), zz3, zzz3)
    dbl_res = G1XYZZ(x3d, _sub(y3da, wy), zz3d, zzz3d)

    res = select_point(need_dbl, dbl_res, res)
    res = select_point(inf2, p, res)
    return select_point(inf1, q, res)


def add_unified(p: G1XYZZ, q: G1XYZZ) -> G1XYZZ:
    """Complete addition over broadcast batch shapes through the kernel
    wrapper (the kernel on a CUDA tensor, the plain version on the CPU)."""
    shape = fl._bshape(p.x, q.x)
    flat = lambda c: c.expand(shape).reshape(shape[0], -1).contiguous()
    out = cuda_msm.add_points(map_coords(flat, p), map_coords(flat, q))
    return map_coords(lambda c: c.reshape(shape), out)


def madd_unified(p: G1XYZZ, a: G1Aff) -> G1XYZZ:
    """Branchless mixed addition XYZZ + affine (madd-2008-s). The P == Q
    fallback doubles the affine operand (mdbl: ZZ3 and ZZZ3 come out as V
    and W)."""
    U = _add(a.y, a.y)
    u2, s2, V, xx = _mul_many([(a.x, p.zz), (a.y, p.zzz), (U, U), (a.x, a.x)])
    pd = _sub(u2, p.x)
    r = _sub(s2, p.y)

    inf1 = is_inf(p)
    inf2 = a.inf
    need_dbl = ~inf1 & ~inf2 & fl.is_zero(FP, pd) & fl.is_zero(FP, r)

    pp, W, Sd = _mul_many([(pd, pd), (U, V), (a.x, V)])
    M = _add(_add(xx, xx), xx)
    ppp, q0, rr, MM = _mul_many([(pd, pp), (p.x, pp), (r, r), (M, M)])
    x3 = _sub(_sub(rr, ppp), _add(q0, q0))
    x3d = _sub(MM, _add(Sd, Sd))
    y3a, sppp, zz3, zzz3, msd, wy = _mul_many(
        [(r, _sub(q0, x3)), (p.y, ppp), (p.zz, pp), (p.zzz, ppp),
         (M, _sub(Sd, x3d)), (W, a.y)]
    )
    res = G1XYZZ(x3, _sub(y3a, sppp), zz3, zzz3)
    dbl_res = G1XYZZ(x3d, _sub(msd, wy), V, W)

    res = select_point(need_dbl, dbl_res, res)
    res = select_point(inf2, p, res)
    return select_point(inf1, from_affine(a), res)


def repeat_batch(a: G1Aff, k: int) -> G1Aff:
    """k copies of a point batch (24, n) along a new batch axis: (24, k, n),
    the points of k MSMs over the same bases."""
    return G1Aff(
        torch.stack([a.x] * k, dim=1), torch.stack([a.y] * k, dim=1), torch.stack([a.inf] * k, dim=0)
    )


@tracing.span("kzg.body.to_affine")
def to_affine(p: G1XYZZ) -> G1Aff:
    """Batch conversion to affine through one shared inversion (a protocol
    body's own glue wherever it is called)."""
    inf = is_inf(p)
    t = fl.mont_mul(FP, p.zz, p.zzz)
    batch = t.shape[1:]
    tinv, _ = fl.batch_inv_tree(FP, t.reshape(FP.n_limbs, -1), zero_to_one=True)
    tinv = tinv.reshape((FP.n_limbs,) + batch)
    zz_inv, zzz_inv = _mul_many([(tinv, p.zzz), (tinv, p.zz)])  # 1/zz, 1/zzz
    x, y = _mul_many([(p.x, zz_inv), (p.y, zzz_inv)])
    zeros = torch.zeros_like(x)
    return G1Aff(fl.select(inf, zeros, x), fl.select(inf, zeros, y), inf)


def tree_reduce(p: G1XYZZ) -> G1XYZZ:
    """Sum along the last batch axis by halving (n - 1 additions, log n
    rounds). Returns (..., 1)."""
    n = p.x.shape[-1]
    m = 1 << max(0, n - 1).bit_length()
    if m != n:
        p = map_coords(lambda c: fl._pad_last(c, m), p)
    while m > 1:
        h = m // 2
        p = add_unified(map_coords(lambda c: c[..., :h], p), map_coords(lambda c: c[..., h:], p))
        m = h
    return p


def suffix_scan_add(p: G1XYZZ) -> G1XYZZ:
    """Inclusive reverse (suffix) cumulative point sum along the last axis,
    Hillis-Steele with rolls."""
    n = p.x.shape[-1]
    if n == 1:
        return p
    idx = torch.arange(n, device=p.x.device)
    for d in range((n - 1).bit_length()):
        s = 1 << d
        rolled = map_coords(lambda c: torch.roll(c, -s, dims=-1), p)
        added = add_unified(p, rolled)
        p = select_point(idx <= n - 1 - s, added, p)  # lanes with a right partner
    return p


def scalar_mul(a: G1Aff, scalar_limbs: torch.Tensor, nbits: int = 255) -> G1XYZZ:
    """Per-lane scalar multiplication out[i] = scalar[i] * a[i], MSB-first
    double and add: one dbl and one madd_unified with a select per bit.
    scalar_limbs: (16, *batch) canonical Fr limbs."""
    acc = infinity(a.x.shape[1:], a.x.device)
    for i in range(nbits):
        bit_idx = nbits - 1 - i
        bit = (scalar_limbs[bit_idx // 16] >> (bit_idx % 16)) & 1
        acc = dbl(acc)
        acc = select_point(bit == 1, madd_unified(acc, a), acc)
    return acc


# ---------------------------------------------------------------------------
# Host conversions (python ints <-> limb tensors)
# ---------------------------------------------------------------------------


def affine_from_ints(points, device) -> G1Aff:
    """List of affine points ((x, y) ints or None) -> limb batch."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    inf = fl.to_device(np.array([p is None for p in points], dtype=bool), device)
    return G1Aff(FP.encode(xs, device), FP.encode(ys, device), inf)


def affine_to_ints(a: G1Aff):
    """Affine batch -> list of affine points (None = infinity)."""
    xs = FP.decode(a.x)
    ys = FP.decode(a.y)
    infs = fl.to_host(a.inf.reshape(-1)).tolist()
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def xyzz_to_ints(p: G1XYZZ):
    return affine_to_ints(to_affine(p))
