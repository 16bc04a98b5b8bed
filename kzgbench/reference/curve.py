"""BLS12-381's G1 in plain Python integers: Jacobian arithmetic (a = 0),
scalar multiplication, a Pippenger multi-scalar multiplication, and the
compressed encodings of G1 and G2 points (ZCash format, as the consensus
specs use them).

An affine point is (x, y), or None for the point at infinity; a Jacobian
point is (X, Y, Z) with x = X / Z^2, y = Y / Z^3, and Z = 0 at infinity.
"""

from .fields import P, R, fp2_add, fp2_mul, fp2_neg, fp2_sq, fp_sqrt, fp2_sqrt

B = 4
B2 = (4, 4)  # the twist's b: 4 (1 + u)
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)
INF = (1, 1, 0)
_HALF_P = (P - 1) // 2


def neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % P)


def to_jac(pt):
    return INF if pt is None else (pt[0], pt[1], 1)


def to_affine(q):
    X, Y, Z = q
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def dbl(q):
    """dbl-2009-l (a = 0)."""
    X1, Y1, Z1 = q
    if Z1 == 0 or Y1 == 0:
        return INF
    A = X1 * X1 % P
    Bq = Y1 * Y1 % P
    C = Bq * Bq % P
    t = X1 + Bq
    D = 2 * (t * t - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return (X3, Y3, Z3)


def add_mixed(q, pt):
    """Jacobian q plus affine pt (madd-2007-bl), complete by case."""
    if pt is None:
        return q
    X1, Y1, Z1 = q
    x2, y2 = pt
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1 * Z1Z1 % P
    H = (U2 - X1) % P
    rr = 2 * (S2 - Y1) % P
    if H == 0:
        return dbl(q) if rr == 0 else INF
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % P
    t = Z1 + H
    Z3 = (t * t - Z1Z1 - HH) % P
    return (X3, Y3, Z3)


def add(q1, q2):
    """Jacobian plus Jacobian (add-2007-bl), complete by case."""
    X1, Y1, Z1 = q1
    X2, Y2, Z2 = q2
    if Z1 == 0:
        return q2
    if Z2 == 0:
        return q1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    H = (U2 - U1) % P
    rr = 2 * (S2 - S1) % P
    if H == 0:
        return dbl(q1) if rr == 0 else INF
    I = 4 * H * H % P
    J = H * I % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    t = Z1 + Z2
    Z3 = (t * t - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def mul(pt, k: int):
    """k pt for an affine point, as an affine point (k taken mod r)."""
    k %= R
    acc = INF
    for bit in bin(k)[2:] if k else "":
        acc = dbl(acc)
        if bit == "1":
            acc = add_mixed(acc, pt)
    return to_affine(acc)


def affine_add(p1, p2):
    return to_affine(add_mixed(to_jac(p1), p2))


def _window(n: int) -> int:
    """The window that minimises n w mixed additions plus 2 w 2^c bucket
    additions (about 1.4 times as dear), w = ceil(255 / c)."""
    best, best_cost = 1, None
    for c in range(1, 17):
        w = -(-255 // c)
        cost = n * w + 2.8 * w * (1 << c)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def msm(points: list, scalars: list):
    """sum_i scalars[i] points[i] over affine points (None allowed), as an
    affine point: Pippenger's bucket method with unsigned windows."""
    if len(points) != len(scalars):
        raise ValueError("msm: points and scalars differ in length")
    pairs = [(p, s % R) for p, s in zip(points, scalars) if p is not None and s % R]
    if not pairs:
        return None
    c = _window(len(pairs))
    mask = (1 << c) - 1
    w = -(-255 // c)
    result = INF
    for win in range(w - 1, -1, -1):
        for _ in range(c):
            result = dbl(result)
        shift = win * c
        buckets = [None] * (1 << c)
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = (p[0], p[1], 1) if b is None else add_mixed(b, p)
        running = INF
        total = INF
        for d in range(mask, 0, -1):
            b = buckets[d]
            if b is not None:
                running = add(running, b)
            total = add(total, running)
        result = add(result, total)
    return to_affine(result)


# ---------------------------------------------------------------------------
# Compressed encodings (flags in the top three bits of the first byte)
# ---------------------------------------------------------------------------

_COMPRESSED, _INFINITY, _SIGN = 0x80, 0x40, 0x20


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(47)
    x, y = pt
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED | (_SIGN if y > _HALF_P else 0)
    return bytes(out)


def g1_from_bytes(b: bytes):
    """The point of a compressed G1 encoding; raises ValueError on an
    encoding that is not canonical or a point not on the curve. The
    subgroup is not checked (a 255-bit multiplication a point): the
    program's points are judged through the batch equations instead."""
    if len(b) != 48:
        raise ValueError("g1: expected 48 bytes")
    flags = b[0]
    if not flags & _COMPRESSED:
        raise ValueError("g1: not compressed")
    if flags & _INFINITY:
        if flags != _COMPRESSED | _INFINITY or any(b[1:]):
            raise ValueError("g1: malformed infinity")
        return None
    x = int.from_bytes(b, "big") & ((1 << 381) - 1)
    if x >= P:
        raise ValueError("g1: x not canonical")
    y = fp_sqrt((x * x * x + B) % P)
    if y is None:
        raise ValueError("g1: not on the curve")
    if bool(flags & _SIGN) != (y > _HALF_P):
        y = P - y
    return (x, y)


def _fp2_larger(y) -> bool:
    return y[1] > _HALF_P if y[1] else y[0] > _HALF_P


def g2_from_bytes(b: bytes):
    if len(b) != 96:
        raise ValueError("g2: expected 96 bytes")
    flags = b[0]
    if not flags & _COMPRESSED or flags & _INFINITY:
        raise ValueError("g2: not a compressed finite point")
    x = (int.from_bytes(b[48:], "big"), int.from_bytes(b[:48], "big") & ((1 << 381) - 1))
    if x[0] >= P or x[1] >= P:
        raise ValueError("g2: x not canonical")
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sq(x), x), B2))
    if y is None:
        raise ValueError("g2: not on the curve")
    if bool(flags & _SIGN) != _fp2_larger(y):
        y = fp2_neg(y)
    return (x, y)
