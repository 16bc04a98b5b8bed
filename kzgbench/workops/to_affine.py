"""to_affine (points): a batch inversion (3 products a point and one Fp
inversion by Fermat) and 4 products a point to scale x and y."""

from kzgbench.workcount import FP_INV


def products(op):
    return op["count"] * (op["points"] * 7 + FP_INV), 0
