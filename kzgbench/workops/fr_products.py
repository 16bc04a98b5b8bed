"""fr_products: Fr products as counted in the entry."""


def products(op):
    return 0, op["count"]
