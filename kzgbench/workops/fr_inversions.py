"""fr_inversions: Fr inversions by Fermat's little theorem."""

from kzgbench.workcount import FR_INV


def products(op):
    return 0, op["count"] * FR_INV
