"""The optimal ate pairing on BLS12-381 in plain Python integers: G2 points
are untwisted into E(Fp12) and the Miller loop runs with affine formulas
over Fp12. A frozen copy of the JAX package's oracle
(`kzg_tpu/oracle/pairing.py`), written for obvious correctness."""

from . import fields as F
from .curve import neg

_XI_INV = F.fp2_inv(F.XI)


def _untwist(q):
    x, y = q
    xs = F.fp2_mul(x, _XI_INV)
    ys = F.fp2_mul(y, _XI_INV)
    return (((F.FP2_ZERO, F.FP2_ZERO, xs), F.FP6_ZERO), (F.FP6_ZERO, (F.FP2_ZERO, ys, F.FP2_ZERO)))


def _embed(a: int):
    return (((a % F.P, 0), F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)


def _line(t, q, p12):
    """The line through t and q (the tangent at t when q is None) at p12,
    and t + q (or 2 t)."""
    tx, ty = t
    px, py = p12
    if q is None:
        num = F.fp12_mul(F.fp12_sq(tx), _embed(3))
        den = F.fp12_add(ty, ty)
    else:
        num = F.fp12_sub(q[1], ty)
        den = F.fp12_sub(q[0], tx)
    lam = F.fp12_mul(num, F.fp12_inv(den))
    line = F.fp12_sub(F.fp12_sub(py, ty), F.fp12_mul(lam, F.fp12_sub(px, tx)))
    ox = q[0] if q is not None else tx
    x3 = F.fp12_sub(F.fp12_sub(F.fp12_sq(lam), tx), ox)
    y3 = F.fp12_sub(F.fp12_mul(lam, F.fp12_sub(tx, x3)), ty)
    return line, (x3, y3)


def miller_loop(p, q):
    """f_{|x|,Q}(P), conjugated for the negative x; 1 at infinity."""
    if p is None or q is None:
        return F.FP12_ONE
    p12 = (_embed(p[0]), _embed(p[1]))
    q12 = _untwist(q)
    t = q12
    f = F.FP12_ONE
    x = -F.BLS_X
    for bit in range(x.bit_length() - 2, -1, -1):
        line, t = _line(t, None, p12)
        f = F.fp12_mul(F.fp12_sq(f), line)
        if (x >> bit) & 1:
            line, t = _line(t, q12, p12)
            f = F.fp12_mul(f, line)
    return F.fp12_conj(f)


_E_HARD = (F.P**4 - F.P**2 + 1) // F.R
_LAMBDAS = []
_tmp = _E_HARD
for _ in range(4):
    _LAMBDAS.append(_tmp % F.P)
    _tmp //= F.P


def final_exponentiation(f):
    m = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))
    m = F.fp12_mul(F.fp12_frobenius(F.fp12_frobenius(m)), m)
    bases = [m]
    for _ in range(3):
        bases.append(F.fp12_frobenius(bases[-1]))
    table = [F.FP12_ONE] * 16
    for mask in range(1, 16):
        low = mask & (-mask)
        table[mask] = F.fp12_mul(table[mask ^ low], bases[low.bit_length() - 1])
    acc = F.FP12_ONE
    for i in range(max(v.bit_length() for v in _LAMBDAS) - 1, -1, -1):
        acc = F.fp12_sq(acc)
        mask = sum(((_LAMBDAS[j] >> i) & 1) << j for j in range(4))
        if mask:
            acc = F.fp12_mul(acc, table[mask])
    return acc


def pairings_equal(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2), with a1, b1 in G1 and a2, b2 in G2 (affine),
    through one shared final exponentiation."""
    f = F.fp12_mul(miller_loop(neg(a1), a2), miller_loop(b1, b2))
    return final_exponentiation(f) == F.FP12_ONE
