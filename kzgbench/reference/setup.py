"""The trusted setup as the reference reads it: the text file of the
consensus specs and c-kzg-4844 (the number of G1 points, the number of G2
points, the G1 points in Lagrange form, the G2 points and the G1 points in
monomial form, one compressed point a line), decompressed in plain Python.

The Lagrange points come in natural order; the blob's evaluations lie at
the bit-reversed roots of unity, so they are kept bit-reversed, as the
specs' `bit_reversal_permutation(KZG_SETUP_G1_LAGRANGE)`.
"""

from dataclasses import dataclass

from .curve import g1_from_bytes, g2_from_bytes
from .fields import bit_reversal_permutation


@dataclass
class Setup:
    g1_lagrange_brp: list  # affine G1, the blob's (bit-reversed) order
    g1_monomial: list  # affine G1, [tau^i]_1 for i < n_monomial
    g2_monomial: list  # affine G2, [tau^i]_2


def load(path: str, n_monomial: int = 64) -> Setup:
    """The setup in `path`, with the first `n_monomial` monomial G1 points
    (the checks of a run need 64; the pool's cell proofs all of them)."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    n1, n2 = int(lines[0]), int(lines[1])
    lag = lines[2 : 2 + n1]
    g2 = lines[2 + n1 : 2 + n1 + n2]
    mono = lines[2 + n1 + n2 : 2 + 2 * n1 + n2]
    if len(mono) != n1:
        raise ValueError(f"{path}: expected {n1} monomial G1 points, found {len(mono)}")
    return Setup(
        g1_lagrange_brp=bit_reversal_permutation([g1_from_bytes(bytes.fromhex(h)) for h in lag]),
        g1_monomial=[g1_from_bytes(bytes.fromhex(h)) for h in mono[:n_monomial]],
        g2_monomial=[g2_from_bytes(bytes.fromhex(h)) for h in g2],
    )
