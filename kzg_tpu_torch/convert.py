"""Carry the JAX package's state, given as numpy arrays, into this
package's tensors. The limb layout and the Montgomery radix are the same,
so this is a change of dtype (uint32 -> int32, every limb < 2^16) and of
container only."""

import numpy as np
import torch

from .ops.msm import FixedBaseTable


def limbs_from_jax(a, device="cpu") -> torch.Tensor:
    """A JAX limb array (L, *batch) uint32 -> int32 tensor on `device`."""
    a = np.asarray(a)
    if a.size and int(a.max()) >= 1 << 16:
        raise ValueError("not a 16-bit limb array")
    return torch.from_numpy(a.astype(np.int32)).to(device)  # astype copies


def table_from_jax(x, y, inf, c: int, device="cpu") -> FixedBaseTable:
    """A JAX FixedBaseTable's (x, y, inf, c) -> this package's table: the
    flat one (24, w, n) of a point set, or one with the table's own batch
    dims, such as the JAX package's FK20 column tables (24, w, 128, 64)
    (kzg_tpu/eip7594.py:_column_tables), which keep their layout."""
    x, y, inf = np.asarray(x), np.asarray(y), np.asarray(inf)
    if x.ndim < 3 or y.shape != x.shape or inf.shape != x.shape[1:]:
        raise ValueError(f"table shapes x {x.shape}, y {y.shape}, inf {inf.shape} do not match")
    return FixedBaseTable(
        limbs_from_jax(x, device),
        limbs_from_jax(y, device),
        torch.from_numpy(inf.astype(bool)).to(device),
        int(c),
    )


def interp_consts_from_jax(inv_shifts, table_slice, device="cpu"):
    """The JAX package's cell-verify constants (kzg_tpu/eip7594.py:
    _interp_consts: the inverse coset-shift powers (16, 128, 64) and the
    64-column (x, y, inf, c) slice of its monomial table) -> this package's
    (TorchKZGSettings.inv_coset_shift_pows, .monomial64_table)."""
    return limbs_from_jax(inv_shifts, device), table_from_jax(*table_slice, device=device)
