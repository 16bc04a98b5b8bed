"""EIP-7594 (PeerDAS) cells and FK20 cell proofs on a torch device.

The counterpart of the JAX package's eip7594.py for compute_cells and
compute_cells_and_kzg_proofs. Per blob, on the settings' device and batched
over blobs: byte -> limb conversion with the canonicality check, the
Lagrange -> monomial conversion (inverse FFT of 4096), the extension (FFT of
8192 over the zero-padded polynomial) that gives the 128 cells, and the
FK20 proofs of all 128 cells: the Toeplitz coefficients (64 FFTs of 128),
the column MSM (fixed-base, one table per column) and the G1 half
convolution. The cells and the proofs share one Lagrange -> monomial
conversion. The host does the 48-byte point codec (native core). Batches
run in chunks of BATCH_CHUNK blobs.
"""

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import bytes as bs
from . import native
from .constants import (
    BYTES_PER_CELL,
    CELLS_PER_EXT_BLOB,
    FIELD_ELEMENTS_PER_BLOB,
)
from .eip4844 import _bytes_to_limbs, _check_blob_length
from .ops import field as fl
from .ops import g1 as dg1
from .ops import msm as dmsm
from .ops.fft import bit_reverse, fft, ifft
from .ops.field import FR
from .ops.g1fft import fk20_half_convolution
from .settings import TorchKZGSettings

N = FIELD_ELEMENTS_PER_BLOB
K2 = CELLS_PER_EXT_BLOB  # 128
# Blobs per device pass. The column MSM of one blob scans 32 x 128 x 64 =
# 262,144 elements and the half convolution runs 128 x 65 ladders, so a
# chunk bounds the working set (peak device memory in PERF.md).
BATCH_CHUNK = 16


@lru_cache(maxsize=None)
def _toeplitz_gather(n: int, cell: int) -> Tuple[np.ndarray, np.ndarray]:
    """Index and mask arrays of the strided Toeplitz coefficients (the JAX
    package's _toeplitz_gather): (idx (cell, 2r), mask (cell, 2r)) into the
    length-n monomial polynomial, r = n / cell. Row i is
    [p[d - i], 0, ..., 0, p[d - i - (r - 2) cell], ..., p[d - i - cell]]
    with d = n - 1."""
    r_ = n // cell
    idx = np.zeros((cell, 2 * r_), dtype=np.int64)
    mask = np.zeros((cell, 2 * r_), dtype=bool)
    d = n - 1
    for i in range(cell):
        idx[i, 0] = d - i
        mask[i, 0] = True
        for j in range(1, r_ - 1):
            idx[i, 2 * r_ - j] = d - i - j * cell
            mask[i, 2 * r_ - j] = True
    return idx, mask


def _lagrange_to_monomial(blob_m: torch.Tensor) -> torch.Tensor:
    """(16, B, n) Lagrange form (natural wire order, Montgomery) ->
    monomial coefficients (Montgomery)."""
    return ifft(bit_reverse(blob_m))


def _cells_body(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 4096, 32) uint8 blob bytes -> (cells, poly): the 8192 extension
    values in wire (bit-reversed) order as canonical limbs (16, B, 8192),
    and the monomial coefficients (16, B, 4096) in Montgomery form. Raises
    before any FFT if a scalar is not canonical."""
    limbs, ok = _bytes_to_limbs(raw)
    if not bool(ok.all()):
        raise ValueError("Invalid blob: scalar is not canonical")
    poly = _lagrange_to_monomial(fl.from_canonical(FR, limbs))
    ext = fft(torch.cat([poly, torch.zeros_like(poly)], dim=-1))
    return fl.to_canonical(FR, bit_reverse(ext)), poly


def column_scalars(poly_m: torch.Tensor, cell: int) -> torch.Tensor:
    """The column MSM's scalars: the FFTs of the strided Toeplitz rows of
    monomial polys (16, B, n) (Montgomery), as canonical limbs
    (16, B, 2r, cell), r = n / cell: column j's scalars are entry j of
    every row's FFT."""
    L, B, n = poly_m.shape
    idx, mask = _toeplitz_gather(n, cell)
    dev = poly_m.device
    toeplitz = poly_m[..., torch.from_numpy(idx.reshape(-1)).to(dev)].reshape(L, B, cell, idx.shape[1])
    toeplitz = torch.where(torch.from_numpy(mask).to(dev), toeplitz, torch.zeros_like(toeplitz))
    coeffs = fft(toeplitz).transpose(2, 3).contiguous()  # (16, B, 2r, cell)
    return fl.to_canonical(FR, coeffs)


def _fk20_body(poly_m: torch.Tensor, table: dmsm.FixedBaseTable) -> dg1.G1XYZZ:
    """FK20 proofs of every cell of monomial polys (16, B, n) (Montgomery)
    against the column tables (24, w, 2r, cell): XYZZ (B, 2r) in
    bit-reversed (wire) order, r = n / cell. n comes from the polys and the
    cell size from the table, so the same body runs the mainnet sizes
    (n = 4096, cell 64) and small test setups."""
    h_ext = dmsm.msm_fixed(table, column_scalars(poly_m, table.n))  # (24, B, 2r)
    proofs = fk20_half_convolution(h_ext)
    return dg1.map_coords(bit_reverse, proofs)


def _chunk_cells_proofs(chunk: Sequence[bytes], s: TorchKZGSettings, with_proofs: bool):
    raw = np.frombuffer(b"".join(chunk), dtype=np.uint8).reshape(len(chunk), N, 32)
    cells, poly = _cells_body(torch.from_numpy(raw.copy()).to(s.device))
    cells_np = cells.cpu().numpy()
    out_cells = []
    for b in range(len(chunk)):
        wire = bs.frs_to_bytes(cells_np[:, b, :])
        out_cells.append([wire[i * BYTES_PER_CELL : (i + 1) * BYTES_PER_CELL] for i in range(K2)])
    if not with_proofs:
        return out_cells, []
    pts = dg1.affine_to_ints(dg1.to_affine(_fk20_body(poly, s.column_tables)))
    return out_cells, [native.g1_compress_batch(pts[b * K2 : (b + 1) * K2]) for b in range(len(chunk))]


# ---------------------------------------------------------------------------
# Public API (raw bytes, c-kzg-4844 semantics)
# ---------------------------------------------------------------------------


def compute_cells_and_kzg_proofs_batch(
    blobs: Sequence[bytes], s: TorchKZGSettings, with_proofs: bool = True
) -> Tuple[List[List[bytes]], List[List[bytes]]]:
    """Cells (128 of 2048 bytes per blob) and, with `with_proofs`, their
    FK20 proofs (128 compressed points per blob), one device pass per
    chunk of BATCH_CHUNK blobs. Without proofs the second list is empty."""
    blobs = list(blobs)
    for b in blobs:
        _check_blob_length(b)
    all_cells, all_proofs = [], []
    for lo in range(0, len(blobs), BATCH_CHUNK):
        cells, proofs = _chunk_cells_proofs(blobs[lo : lo + BATCH_CHUNK], s, with_proofs)
        all_cells += cells
        all_proofs += proofs
    return all_cells, all_proofs


def compute_cells_and_kzg_proofs(
    blob_bytes: bytes, s: TorchKZGSettings, with_proofs: bool = True
) -> Tuple[List[bytes], List[bytes]]:
    cells, proofs = compute_cells_and_kzg_proofs_batch([blob_bytes], s, with_proofs)
    return cells[0], (proofs[0] if with_proofs else [])

