"""msm_fixed (points, window c): Pippenger over precomputed window
multiples 2^(c j) P_i with signed digits (w = ceil(256 / c) windows of a
255-bit scalar): points * w mixed additions, then the running sum over
2^(c-1) buckets, two additions a bucket."""

from kzgbench.workcount import ADD, MADD


def products(op):
    n, c = op["points"], op["window"]
    w = -(-256 // c)
    return op["count"] * (n * w * MADD + 2 * (1 << (c - 1)) * ADD), 0
