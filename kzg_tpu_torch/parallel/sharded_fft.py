"""The Fr FFT sharded over a device mesh: the four-step (Bailey)
factorization with one all_to_all between its two rounds of local FFTs.
The counterpart of the JAX package's parallel/sharded_fft.py.

    n = n1 * n2, the input x[i1 + n1 i2] read as an (n1, n2) matrix with
    its rows i1 cut over the mesh's "points" axis:
      1. FFTs of length n2 along the rows (each rank n1 / d of them);
      2. the twiddles w_n^(i1 k2), on each rank's rows;
      3. all_to_all over the axis: from rows (i1) to columns (k2);
      4. FFTs of length n1 along the now local i1.
    X[k2 + n2 k1] = result[k2, k1].

The inverse takes the inverse roots; its 1/n is 1/n2 from step 1 and 1/n1
from step 4, each local FFT scaling by its own length. The local FFTs are
ops/fft.py's (kernel B4, and B5 where a length exceeds 2^11). Every rank
calls with the same full input and gets back the whole transform, limb for
limb the one of ops/fft.fft on the whole array.
"""

from functools import lru_cache

import numpy as np
import torch

from ..constants import R_MOD as R, root_of_unity
from ..ops import field as fl
from ..ops.fft import fft
from ..ops.field import FR
from .distributed import all_to_all, axis_size, gather_shards, shard


@lru_cache(maxsize=None)
def _outer_twiddles(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """(16, n1, n2) Montgomery-form w_n^(i1 k2) table (w_n^-(i1 k2) for the
    inverse), int32 limbs."""
    n = n1 * n2
    w = root_of_unity(n.bit_length() - 1)
    if inverse:
        w = pow(w, R - 2, R)
    vals = []
    for i1 in range(n1):
        base, acc = pow(w, i1, R), 1
        for _ in range(n2):
            vals.append(acc)
            acc = acc * base % R
    return FR.encode_host(vals).reshape(FR.n_limbs, n1, n2)


def split(n: int, d: int) -> tuple:
    """(n1, n2): n1 = 2^(log n / 2), at least d, and n2 = n / n1."""
    n1 = max(1 << ((n.bit_length() - 1) // 2), d)
    n2 = n // n1
    if n & (n - 1) or n1 % d or n1 * n2 != n:
        raise ValueError(f"fft_sharded: length {n} does not split over {d} ranks")
    return n1, n2


def fft_sharded(x: torch.Tensor, mesh, inverse: bool = False) -> torch.Tensor:
    """FFT along the last axis of Montgomery-form Fr limbs (16, n), the
    transform's rows cut over the mesh's "points" axis. The inverse
    includes the 1/n scale."""
    n = x.shape[-1]
    n1, n2 = split(n, axis_size(mesh, "points"))
    y = x.reshape(FR.n_limbs, n2, n1).transpose(1, 2)  # y[i1, i2] = x[i1 + n1 i2]
    tw = shard(torch.from_numpy(_outer_twiddles(n1, n2, inverse)), mesh, "points", 1).to(x.device)
    a = fft(shard(y, mesh, "points", 1).contiguous(), inverse)  # step 1: (16, n1 / d, n2)
    b = fl.mont_mul(FR, a, tw)  # step 2
    c = all_to_all(b, mesh, "points", split_dim=2, concat_dim=1)  # step 3: (16, n1, n2 / d)
    out = fft(c.transpose(1, 2).contiguous(), inverse)  # step 4: (16, n2 / d, n1)
    full = gather_shards(out, mesh, "points", 1)  # (16, n2, n1)
    return full.transpose(1, 2).reshape(FR.n_limbs, n)  # X[k2 + n2 k1] = full[k2, k1]


def ifft_sharded(x: torch.Tensor, mesh) -> torch.Tensor:
    return fft_sharded(x, mesh, inverse=True)
