"""Multi-point openings (coset proofs) on a torch device: the proof that a
monomial-form polynomial p takes given values on the coset x <w_n> of the
n-th roots of unity, and its check. The counterpart of the JAX package's
multiproof.py.

The proof is the commitment to the one quotient q = p / (X^n - x^n),
computed on the device by fast division (ops/poly.py) and committed with
the fixed-base MSM on the monomial table. The verifier interpolates the
values on the device (an inverse FFT of n, then the coset unshift by the
powers of 1/x), commits to the interpolant on the table's first n columns,
and checks on the host, with one pairing,

    e(C - I + x^n proof, G2) == e(proof, [s^n]_2),

which puts the one variable scalar on the G1 side, so both G2 points are
setup points.
"""

from typing import Sequence

import torch

from . import native
from .constants import P_MOD, R_MOD as R
from .eip4844 import G2_GENERATOR
from .ops import field as fl
from .ops import g1 as dg1
from .ops import msm as dmsm
from .ops.fft import ifft
from .ops.field import FR
from .ops.poly import poly_fast_div
from .settings import TorchKZGSettings
from .tracing import span


@span("kzg.body.proof_multi")
def _proof_multi_body(num_m: torch.Tensor, den_m: torch.Tensor, table: dmsm.FixedBaseTable) -> dg1.G1Aff:
    """q = num / den (16, 1, ...), Montgomery, committed on the table (its
    columns past q's length take zero scalars): the affine proof point."""
    q_can = fl.to_canonical(FR, poly_fast_div(num_m, den_m))[:, 0, :]
    q_can = torch.cat([q_can, q_can.new_zeros((FR.n_limbs, table.n - q_can.shape[-1]))], dim=-1)
    return dg1.to_affine(dmsm.msm_fixed(table, q_can))


@span("kzg.body.interp_commit")
def _interp_commit_body(ys_m: torch.Tensor, xinv_pows_m: torch.Tensor, table: dmsm.FixedBaseTable) -> dg1.G1Aff:
    """The commitment to the polynomial through the values ys_m (16, 1, n)
    on the coset x <w_n>: its coefficients are the inverse FFT of the
    values times the powers of 1/x (16, 1, n). The table has n columns."""
    sc = fl.to_canonical(FR, fl.mont_mul(FR, ifft(ys_m), xinv_pows_m))[:, 0, :]
    return dg1.to_affine(dmsm.msm_fixed(table, sc))


def compute_kzg_proof_multi(poly_coeffs: Sequence[int], x: int, n: int, s: TorchKZGSettings) -> bytes:
    """The compressed proof that p (monomial coefficients, ints) agrees
    with its values on the coset x <w_n>, n a power of two."""
    p_len = len(poly_coeffs)
    if n <= 0 or n & (n - 1):
        raise ValueError("compute_kzg_proof_multi: n must be a power of two")
    if p_len < n + 1:
        raise ValueError("compute_kzg_proof_multi: polynomial too short")
    if p_len - n > len(s.setup.g1_monomial):
        raise ValueError("compute_kzg_proof_multi: quotient exceeds setup")
    den = [0] * (n + 1)
    den[0] = (R - pow(x % R, n, R)) % R
    den[n] = 1
    aff = _proof_multi_body(
        FR.encode(poly_coeffs, s.device)[:, None, :], FR.encode(den, s.device)[:, None, :], s.monomial_table
    )
    return native.g1_compress_batch(dg1.affine_to_ints(aff))[0]


def verify_kzg_proof_multi(
    commitment_bytes: bytes, proof_bytes: bytes, x: int, ys: Sequence[int], s: TorchKZGSettings
) -> bool:
    """Check an opening of n = len(ys) values on the coset x <w_n>."""
    n = len(ys)
    if n <= 0 or n & (n - 1):
        raise ValueError("verify_kzg_proof_multi: len(ys) must be a power of two")
    if n >= len(s.g2_monomial):
        raise ValueError("verify_kzg_proof_multi: not enough G2 setup points")
    commitment, proof = native.g1_decompress_batch(commitment_bytes + proof_bytes)
    x = x % R
    xinv = pow(x, R - 2, R)
    xinv_pows = FR.encode([pow(xinv, i, R) for i in range(n)], s.device)[:, None, :]
    t = s.monomial_table
    first_n = dmsm.FixedBaseTable(*(a[..., :n].contiguous() for a in t[:3]), t.c)
    interp = dg1.affine_to_ints(_interp_commit_body(FR.encode(ys, s.device)[:, None, :], xinv_pows, first_n))[0]
    neg_interp = None if interp is None else (interp[0], (P_MOD - interp[1]) % P_MOD)
    lhs = native.g1_add(native.g1_add(commitment, neg_interp), native.g1_mul(proof, pow(x, n, R)))
    return native.pairings_verify(lhs, G2_GENERATOR, proof, s.g2_monomial[n])
