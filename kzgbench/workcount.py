"""The least work of a call, counted from its inputs by textbook algorithms,
so that it reads the same whatever implements them. Each traffic's counts
are a data file, work/<traffic>.json, a list of operations:

    {"op": "msm_fixed", "points": 4096, "window": 13, "count": 6, "why": "..."}

Each operation is a file of its own, workops/<op>.py, found by name, with
`products(op) -> (Fp products, Fr products)` for one entry, its count
included; a new operation is a new file. The costs they share are here.

G1 operations in XYZZ coordinates (the explicit-formulas database):
mixed addition 8M + 2S (madd-2008-s), addition 12M + 2S (add-2008-s),
doubling 6M + 3S (dbl-2008-s-1, a = 0). An Fp product is 588 32-bit
multiply-adds and an Fr product 264: 16-bit limbs in 32-bit lanes, 24^2 +
12 and 16^2 + 8, as the port's kernel table counts them. An inversion is
by Fermat's little theorem: a squaring a bit of p - 2 (or r - 2) below
the top, and a product a further set bit.
"""

import json
import math
import os

from . import byname
from .reference.fields import P, R

FP_PRODUCT_MADDS = 588
FR_PRODUCT_MADDS = 264
MADD, ADD, DBL = 10, 14, 9  # Fp products of a mixed addition, an addition, a doubling
FP_INV = (P - 2).bit_length() - 1 + bin(P - 2).count("1") - 1
FR_INV = (R - 2).bit_length() - 1 + bin(R - 2).count("1") - 1


def log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    return int(math.log2(n))


def products(op: dict) -> tuple:
    """(Fp products, Fr products) of one entry, count included."""
    return byname.load("workops", op["op"]).products(op)


def call_madds(ops: list) -> float:
    """32-bit multiply-adds of one call."""
    fp = fr = 0
    for op in ops:
        a, b = products(op)
        fp += a
        fr += b
    return float(fp * FP_PRODUCT_MADDS + fr * FR_PRODUCT_MADDS)


def load(root: str, traffic: str):
    """The multiply-adds of one call of `traffic`, or None where the
    traffic has no work file."""
    path = os.path.join(root, "kzgbench", "work", traffic + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return call_madds(json.load(f)["per_call"])
