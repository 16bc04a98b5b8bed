"""The legacy FK20 settings, the reference's chunked-proof API
(FK20SingleSettings, FK20MultiSettings), on a torch device. The
counterpart of the JAX package's fk20.py, with its checks, messages and
output orders.

toeplitz_part_1 (the files of column points, one G1 FFT per chunk offset)
is built once per (n2, chunk_len) on the device and cached on disk
(settings.fk20_columns); at the cells call's layout it is the cells
call's own column tensor. Each data_availability call runs on the device:
the coefficient striding (host tables of gather indices and a zero mask),
the Fr FFTs of every chunk file at once (ops/fft: B4, and B5 above 2^11),
the per-lane variable-scalar multiplies (double and add, plain glue), the
reduction over chunk files (B2) and toeplitz_part_3 with the last G1 FFT
as one half convolution (ops/g1fft.fk20_half_convolution, B2). The
bit-reversal is trusted_setup.reverse_bit_order and the affine unpacking
ops/g1.affine_to_ints.

The half convolution works on k2 x (k2 / 2 + 1) lanes (k2 = n2 /
chunk_len): 525,312 at k2 = 1024, but 33,562,624 at the single path's
n2 = 8192 (about 13 GB of XYZZ points), which neither package can hold.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .constants import R_MOD as R
from .ops import field as fl
from .ops import g1 as dg1
from .ops.fft import fft
from .ops.field import FR
from .ops.g1fft import fk20_half_convolution
from .settings import TorchKZGSettings, resolve_device
from .trusted_setup import reverse_bit_order

Affine = Optional[Tuple[int, int]]


def _toeplitz_gather(n: int, offset: int, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host (index, keep-mask) pair reproducing the legacy
    toeplitz_coeffs_stride: tc[0] = c[n-1-offset]; tc[1..k+2] = 0;
    tc[k+2+j] = c[2*stride-offset-1+j*stride]."""
    k = n // stride
    k2 = 2 * k
    idx = np.zeros(k2, dtype=np.int64)
    keep = np.zeros(k2, dtype=bool)
    idx[0], keep[0] = n - 1 - offset, True
    i, j = k + 2, 2 * stride - offset - 1
    while i < k2:
        idx[i], keep[i] = j, True
        i += 1
        j += stride
    return idx, keep


def _fk20_da_body(poly_limbs: torch.Tensor, gather_idx: torch.Tensor, keep: torch.Tensor, cols: dg1.G1Aff) -> dg1.G1Aff:
    """Canonical coefficient limbs (16, n) -> the extended proofs, affine
    (k2,), for chunk_len stride files at once. gather_idx, keep: (chunk_len,
    k2) striding tables; cols: the files' column points, affine (24, k2,
    chunk_len)."""
    chunk_len, k2 = gather_idx.shape
    tc = poly_limbs[:, gather_idx.reshape(-1)].reshape((FR.n_limbs, chunk_len, k2))
    tc = torch.where(keep, tc, torch.zeros_like(tc))
    cfft = fft(fl.from_canonical(FR, tc))  # (16, chunk_len, k2)
    scalars = fl.to_canonical(FR, cfft).transpose(1, 2)  # lanes (k2, chunk_len), as the columns
    h_ext = dg1.tree_reduce(dg1.scalar_mul(cols, scalars))  # over the chunk files: (24, k2, 1)
    out = fk20_half_convolution(dg1.map_coords(lambda c: c[..., 0], h_ext))  # == fft(zero_top_half(ifft(.)))
    return dg1.to_affine(out)


class FK20MultiSettings:
    """FK20 multi-proof generator: the proofs of a polynomial of n2 / 2
    coefficients on the 2n / chunk_len cosets of chunk_len points."""

    def __init__(self, s: TorchKZGSettings, n2: int, chunk_len: int):
        if n2 > s.max_width:
            raise ValueError("n2 must be less than or equal to kzg settings max width")
        if n2 & (n2 - 1) or n2 < 2:
            raise ValueError("n2 must be a power of two >= 2")
        if chunk_len > n2 // 2 or chunk_len < 1 or chunk_len & (chunk_len - 1):
            raise ValueError("chunk_len must be a power of two <= n2/2")
        self.n2, self.chunk_len, self.settings = n2, chunk_len, s
        self.device = resolve_device(s.device)
        self._cols = s.fk20_columns(n2, chunk_len)
        gi, km = zip(*(_toeplitz_gather(n2 // 2, o, chunk_len) for o in range(chunk_len)))
        self._gather = torch.from_numpy(np.stack(gi)).to(self.device)
        self._keep = torch.from_numpy(np.stack(km)).to(self.device)

    def data_availability_optimized(self, poly_coeffs: Sequence[int]) -> List[Affine]:
        """The proofs in natural coset order."""
        n = len(poly_coeffs)
        if 2 * n != self.n2:
            raise ValueError("polynomial length must be n2/2")
        limbs = torch.from_numpy(fl.ints_to_limbs([c % R for c in poly_coeffs], FR.n_limbs)).to(self.device)
        return dg1.affine_to_ints(_fk20_da_body(limbs, self._gather, self._keep, self._cols))

    def data_availability(self, poly_coeffs: Sequence[int]) -> List[Affine]:
        """The proofs in bit-reversed order."""
        return reverse_bit_order(self.data_availability_optimized(poly_coeffs))


class FK20SingleSettings(FK20MultiSettings):
    """FK20 single-proof generator: the multi path at chunk_len = 1, whose
    one file's points x[i] = g1_monomial[n - 2 - i] are the single path's
    toeplitz_part_1 input."""

    def __init__(self, s: TorchKZGSettings, n2: int):
        super().__init__(s, n2, 1)
