"""BLS12-381's fields in plain Python integers: Fr (the scalars), its roots
of unity, the bit-reversal permutation and radix-2 NTTs; Fp (the base
field) and the tower Fp2, Fp6, Fp12 that the pairing needs.

Representation: Fr and Fp elements are ints in [0, modulus); Fp2 is (c0,
c1) for c0 + c1 u with u^2 = -1; Fp6 is (a0, a1, a2) of Fp2 for a0 + a1 v
+ a2 v^2 with v^3 = xi = 1 + u; Fp12 is (b0, b1) of Fp6 for b0 + b1 w with
w^2 = v. The tower is a frozen copy of the JAX package's pure-Python
oracle (`kzg_tpu/oracle/field.py`), kept here so that the benchmark's
reference imports nothing of either package.
"""

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BLS_X = -0xD201000000010000
PRIMITIVE_ROOT = 7  # the consensus specs' PRIMITIVE_ROOT_OF_UNITY
TWO_ADICITY = 32

assert R == BLS_X**4 - BLS_X**2 + 1
assert P == (BLS_X - 1) ** 2 * R // 3 + BLS_X


# ---------------------------------------------------------------------------
# Fr
# ---------------------------------------------------------------------------


def root_of_unity(n: int) -> int:
    """A primitive n-th root of unity of Fr, n a power of two, as the specs
    derive it: 7^((r - 1) / n)."""
    if n < 1 or n & (n - 1) or n > 1 << TWO_ADICITY:
        raise ValueError(f"no root of unity of order {n}")
    return pow(PRIMITIVE_ROOT, (R - 1) // n, R)


def roots_of_unity(n: int) -> list:
    """w^0 .. w^(n-1) for w = root_of_unity(n), natural order."""
    w = root_of_unity(n)
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * w % R
    return out


def reverse_bits(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def bit_reversal_permutation(values: list) -> list:
    n = len(values)
    if n == 0 or n & (n - 1):
        raise ValueError("bit_reversal_permutation: length must be a power of two")
    bits = n.bit_length() - 1
    return [values[reverse_bits(i, bits)] for i in range(n)]


def batch_inverse(values: list) -> list:
    """Inverses of nonzero Fr elements with one exponentiation."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % R
    inv = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * values[i] % R
    return out


def ntt(values: list, inverse: bool = False) -> list:
    """Evaluations at w^0 .. w^(n-1) of the polynomial with coefficients
    `values` (natural order), or with `inverse` the coefficients of the
    polynomial with those evaluations: iterative radix-2."""
    n = len(values)
    if n & (n - 1):
        raise ValueError("ntt: length must be a power of two")
    bits = n.bit_length() - 1
    a = [values[reverse_bits(i, bits)] % R for i in range(n)]
    w_n = root_of_unity(n)
    if inverse:
        w_n = pow(w_n, R - 2, R)
    half = 1
    while half < n:
        w_step = pow(w_n, n // (2 * half), R)
        tw = [1] * half
        for j in range(1, half):
            tw[j] = tw[j - 1] * w_step % R
        for start in range(0, n, 2 * half):
            for j in range(half):
                u = a[start + j]
                v = a[start + j + half] * tw[j] % R
                a[start + j] = (u + v) % R
                a[start + j + half] = (u - v) % R
        half *= 2
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [x * n_inv % R for x in a]
    return a


# ---------------------------------------------------------------------------
# Fp and its tower (frozen copy of the JAX package's oracle)
# ---------------------------------------------------------------------------


def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int):
    """Square root in Fp (p = 3 mod 4), or None if a is not a square."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (1, 1)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sq(a):
    t = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    ninv = fp_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def fp2_pow(a, e: int):
    result, base = FP2_ONE, a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sq(base)
        e >>= 1
    return result


def fp2_sqrt(a):
    """Square root in Fp2 (p = 3 mod 4), or None if a is not a square."""
    if a == FP2_ZERO:
        return FP2_ZERO
    a1 = fp2_pow(a, (P - 3) // 4)
    x0 = fp2_mul(a1, a)
    alpha = fp2_mul(a1, x0)
    if alpha == ((-1) % P, 0):
        x = (P - x0[1], x0[0])
    else:
        x = fp2_mul(fp2_pow(fp2_add(FP2_ONE, alpha), (P - 1) // 2), x0)
    return x if fp2_sq(x) == a else None


def fp2_mul_by_xi(a):
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    t0 = fp2_mul(a[0], b[0])
    t1 = fp2_mul(a[1], b[1])
    t2 = fp2_mul(a[2], b[2])
    c0 = fp2_add(t0, fp2_mul_by_xi(fp2_sub(fp2_mul(fp2_add(a[1], a[2]), fp2_add(b[1], b[2])), fp2_add(t1, t2))))
    c1 = fp2_add(fp2_sub(fp2_mul(fp2_add(a[0], a[1]), fp2_add(b[0], b[1])), fp2_add(t0, t1)), fp2_mul_by_xi(t2))
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a[0], a[2]), fp2_add(b[0], b[2])), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_mul_by_v(a):
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    c0 = fp2_sub(fp2_sq(a[0]), fp2_mul_by_xi(fp2_mul(a[1], a[2])))
    c1 = fp2_sub(fp2_mul_by_xi(fp2_sq(a[2])), fp2_mul(a[0], a[1]))
    c2 = fp2_sub(fp2_sq(a[1]), fp2_mul(a[0], a[2]))
    t = fp2_add(fp2_mul(a[0], c0), fp2_mul_by_xi(fp2_add(fp2_mul(a[2], c1), fp2_mul(a[1], c2))))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    t0 = fp6_mul(a[0], b[0])
    t1 = fp6_mul(a[1], b[1])
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a[0], a[1]), fp6_add(b[0], b[1])), t0), t1)
    return (c0, c1)


def fp12_sq(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    t = fp6_inv(fp6_sub(fp6_mul(a[0], a[0]), fp6_mul_by_v(fp6_mul(a[1], a[1]))))
    return (fp6_mul(a[0], t), fp6_neg(fp6_mul(a[1], t)))


FROB_GAMMA_12 = fp2_pow(XI, (P - 1) // 6)
FROB_GAMMA_6_1 = fp2_pow(XI, (P - 1) // 3)
FROB_GAMMA_6_2 = fp2_pow(XI, 2 * (P - 1) // 3)


def fp6_frobenius(a):
    return (fp2_conj(a[0]), fp2_mul(fp2_conj(a[1]), FROB_GAMMA_6_1), fp2_mul(fp2_conj(a[2]), FROB_GAMMA_6_2))


def fp12_frobenius(a):
    b0 = fp6_frobenius(a[0])
    b1 = fp6_frobenius(a[1])
    return (b0, tuple(fp2_mul(c, FROB_GAMMA_12) for c in b1))
