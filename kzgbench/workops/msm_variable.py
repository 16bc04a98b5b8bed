"""msm_variable (points, window c): per window of w = ceil(256 / c), points
mixed additions and the running sum over 2^(c-1) buckets (two additions a
bucket); the windows joined by c doublings and one addition each."""

from kzgbench.workcount import ADD, DBL, MADD


def products(op):
    n, c = op["points"], op["window"]
    w = -(-256 // c)
    return op["count"] * (w * (n * MADD + 2 * (1 << (c - 1)) * ADD) + (w - 1) * (c * DBL + ADD)), 0
