"""fr_ntt (n): a radix-2 NTT of length n, n/2 log2 n Fr products."""

from kzgbench.workcount import log2


def products(op):
    return 0, op["count"] * op["n"] // 2 * log2(op["n"])
