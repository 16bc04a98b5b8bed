"""g1_fft (n): n/2 log2 n butterflies, each a 255-bit scalar multiplication
by a twiddle (4-bit fixed window: 255 doublings, 64 additions and a table
of 14) and two additions."""

from kzgbench.workcount import ADD, DBL, log2

SCALAR_MUL = 255 * DBL + (64 + 14) * ADD


def products(op):
    n = op["n"]
    return op["count"] * n // 2 * log2(n) * (SCALAR_MUL + 2 * ADD), 0
