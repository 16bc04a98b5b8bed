"""EIP-7594 (PeerDAS) cells, FK20 cell proofs, erasure recovery and
batch verification of cell proofs on a torch device.

The counterpart of the JAX package's eip7594.py for compute_cells,
compute_cells_and_kzg_proofs, recover_cells_and_kzg_proofs and
verify_cell_kzg_proof_batch. Per blob, on the settings' device and batched
over blobs: byte -> limb conversion with the canonicality check, the
Lagrange -> monomial conversion (inverse FFT of 4096), the extension (FFT of
8192 over the zero-padded polynomial) that gives the 128 cells, and the
FK20 proofs of all 128 cells: the Toeplitz coefficients (64 FFTs of 128),
the column MSM (fixed-base, one table per column) and the G1 half
convolution. The cells and the proofs share one Lagrange -> monomial
conversion. The host does the 48-byte point codec (native core). Batches
run in chunks of BATCH_CHUNK blobs.

Recovery checks every blob's cells on the host first, then runs one device
pass per chunk of BATCH_CHUNK blobs: the missing cells' vanishing
polynomials (a tree of FFT products over their roots), the division of the
known values times that polynomial by it on a coset (FFTs of 8192 and one
batch inversion), and the FK20 proofs of the recovered coefficients, the
producer's proof step. A blob given all 128 cells rides along: its
vanishing polynomial is 1, so its cells and coefficients come back as
given.

Batch verification runs on the device: the cells' byte -> limb conversion
with the canonicality check, the proof and commitment lincombs
(variable-base MSMs), and the aggregated interpolation polynomial (the
r-weighted cells summed into their columns, an inverse FFT of 64 per
column, the coset unshift, the column sum) with its fixed-base commitment.
The host does the Fiat-Shamir challenge, the point codec and one pairing.
"""

import hashlib

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
    FIELD_ELEMENTS_PER_CELL,
    FIELD_ELEMENTS_PER_EXT_BLOB,
    P_MOD,
    RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN,
    R_MOD as R,
    root_of_unity,
)
from .eip4844 import G2_GENERATOR, _bytes_to_limbs, _check_blob_length, compute_powers, hash_to_bls_field
from .ops import field as fl
from .ops import g1 as dg1
from .ops import msm as dmsm
from .ops.fft import bit_reverse, fft, ifft
from .ops.field import FR
from .ops.g1fft import fk20_half_convolution
from .ops.poly import vanishing_poly
from .settings import CELL_INDICES_RBL, TorchKZGSettings
from .tracing import count, span

N = FIELD_ELEMENTS_PER_BLOB
N_EXT = FIELD_ELEMENTS_PER_EXT_BLOB  # 8192
K2 = CELLS_PER_EXT_BLOB  # 128
CELL = FIELD_ELEMENTS_PER_CELL  # 64
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


@span("kzg.body.cells")
def _cells_body(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 4096, 32) uint8 blob bytes -> (cells, poly): the 8192 extension
    values in wire (bit-reversed) order as canonical limbs (16, B, 8192),
    and the monomial coefficients (16, B, 4096) in Montgomery form. Raises
    before any FFT if a scalar is not canonical."""
    limbs, ok = _bytes_to_limbs(raw)
    if not bool(fl.to_host(ok.all())):
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
    toeplitz = poly_m[..., fl.to_device(idx.reshape(-1), dev)].reshape(L, B, cell, idx.shape[1])
    toeplitz = torch.where(fl.to_device(mask, dev), toeplitz, torch.zeros_like(toeplitz))
    coeffs = fft(toeplitz).transpose(2, 3).contiguous()  # (16, B, 2r, cell)
    return fl.to_canonical(FR, coeffs)


@span("kzg.body.fk20")
def _fk20_body(poly_m: torch.Tensor, table: dmsm.FixedBaseTable) -> dg1.G1XYZZ:
    """FK20 proofs of every cell of monomial polys (16, B, n) (Montgomery)
    against the column tables (24, w, 2r, cell): XYZZ (B, 2r) in
    bit-reversed (wire) order, r = n / cell. n comes from the polys and the
    cell size from the table, so the same body runs the mainnet sizes
    (n = 4096, cell 64) and small test setups."""
    h_ext = dmsm.msm_fixed(table, column_scalars(poly_m, table.n))  # (24, B, 2r)
    proofs = fk20_half_convolution(h_ext)
    return dg1.map_coords(bit_reverse, proofs)


def _cell_bytes(cells: torch.Tensor) -> List[List[bytes]]:
    """Canonical limbs (16, B, 8192) in wire order, copied to the host,
    as each blob's 128 cells of 2048 bytes."""
    cells_np = fl.to_host(cells).numpy()
    out = []
    for b in range(cells_np.shape[1]):
        wire = bs.frs_to_bytes(cells_np[:, b, :])
        out.append([wire[i * BYTES_PER_CELL : (i + 1) * BYTES_PER_CELL] for i in range(K2)])
    return out


def _proof_bytes(poly_m: torch.Tensor, s: TorchKZGSettings) -> List[List[bytes]]:
    """The 128 compressed FK20 proofs of each of B blobs' monomial
    coefficients (16, B, n >= 4096), Montgomery, the coefficients above
    4096 not read: one FK20 pass and one to_affine over the batch, one
    compression a blob. The producer and the recovery share it."""
    pts = dg1.affine_to_ints(dg1.to_affine(_fk20_body(poly_m[..., :N], s.column_tables)))
    return [native.g1_compress_batch(pts[b * K2 : (b + 1) * K2]) for b in range(poly_m.shape[1])]


def _chunk_cells_proofs(chunk: Sequence[bytes], s: TorchKZGSettings, with_proofs: bool):
    raw = np.frombuffer(b"".join(chunk), dtype=np.uint8).reshape(len(chunk), N, 32)
    cells, poly = _cells_body(fl.to_device(raw.copy(), s.device))
    return _cell_bytes(cells), (_proof_bytes(poly, s) if with_proofs else [])


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



# ---------------------------------------------------------------------------
# Erasure recovery of cells and proofs
# ---------------------------------------------------------------------------


def _recover_core(cells_nat_m, missing_mask, vanish_coeff_m, shift_pows, unshift_pows):
    """Erasure recovery of extensions (16, B, 8192) from half their values
    or more. cells_nat_m: the values in natural domain order, Montgomery,
    anything at the missing slots; missing_mask: (B, 8192) bool;
    vanish_coeff_m: the coefficients of a polynomial Z that vanishes on
    the missing slots' points and nowhere else on the domain; shift_pows,
    unshift_pows: (16, 8192) powers k^i and k^-i of the coset shift k.
    E Z is known everywhere (zero where E is missing), so E = (E Z) / Z,
    divided on the coset k <w>, where Z has no zero. Returns the recovered
    values in natural order and the coefficients, Montgomery."""
    e_times_z = fl.mont_mul(FR, cells_nat_m, fft(vanish_coeff_m))
    e_times_z = torch.where(missing_mask.unsqueeze(0), torch.zeros_like(e_times_z), e_times_z)
    coeffs = ifft(e_times_z)

    def coset_fft(x):
        return fft(fl.mont_mul(FR, x, shift_pows[:, None, :]))

    vinv, _ = fl.batch_inv_tree(FR, coset_fft(vanish_coeff_m))
    quotient = fl.mont_mul(FR, coset_fft(coeffs), vinv)
    recon_coeff = fl.mont_mul(FR, ifft(quotient), unshift_pows[:, None, :])
    return fft(recon_coeff), recon_coeff


@span("kzg.body.recover")
def _recover_body(cells_wire, missing_cells, missing_roots, roots_valid, s: TorchKZGSettings):
    """Recovered extensions of B blobs. cells_wire: canonical limbs (16, B,
    8192) in wire order, anything in the missing cells; missing_cells:
    (B, 128) bool, by cell index; missing_roots: canonical limbs (16, B,
    64) of the missing cells' 128th roots of unity (the root of cell i is
    w^CELL_INDICES_RBL[i]), roots_valid: (B, 64) bool (a blob may miss
    fewer than 64 cells). Returns the canonical cells (16, B, 8192) in wire
    order and the coefficients (16, B, 8192), Montgomery, whose top half
    is zero for a consistent input."""
    count("recover.passes")
    with span("kzg.body.vanish"):
        short = vanishing_poly(fl.from_canonical(FR, missing_roots), roots_valid)  # (16, B, 65)
    # Z(X) = short(X^64): zero on the 64 points of each missing cell
    vanish = short.new_zeros(short.shape[:-1] + (N_EXT,))
    vanish[..., : (short.shape[-1] - 1) * CELL + 1 : CELL] = short
    missing = bit_reverse(missing_cells.repeat_interleave(CELL, dim=-1))
    natural, coeffs = _recover_core(
        bit_reverse(fl.from_canonical(FR, cells_wire)), missing, vanish, *s.recovery_shift_pows
    )
    return fl.to_canonical(FR, bit_reverse(natural)), coeffs


def _check_recover_inputs(cell_indices: Sequence[int], cells_bytes: Sequence[bytes]) -> np.ndarray:
    """The JAX package's checks of recover_cells_and_kzg_proofs, with its
    messages and in its order. Returns the cells' canonical limbs (16,
    8192) in wire order, zero in the missing cells."""
    if len(cells_bytes) != len(cell_indices):
        raise ValueError("Cell indices mismatch - cells length must be equal")
    if len(cells_bytes) > K2:
        raise ValueError("Cell length cannot be larger than CELLS_PER_EXT_BLOB")
    if len(cells_bytes) < K2 // 2:
        raise ValueError("Impossible to recover - not enough cells")
    provided = set()
    cell_limbs = np.zeros((FR.n_limbs, N_EXT), dtype=np.int32)
    for i, idx in enumerate(cell_indices):
        if idx >= K2:
            raise ValueError(f"Invalid cell index {idx}")
        if i + 1 < len(cell_indices) and cell_indices[i + 1] <= idx:
            raise ValueError("Invalid cell indices: must be strictly ascending")
        if idx in provided:
            raise ValueError(f"Invalid cell indices: cell index {idx} appears twice")
        provided.add(idx)
        if len(cells_bytes[i]) != BYTES_PER_CELL:
            raise ValueError("Invalid cell length")
        limbs, ok = bs.frs_from_bytes(cells_bytes[i])
        if not ok.all():
            raise ValueError("Invalid cell: scalar not canonical")
        cell_limbs[:, idx * CELL : (idx + 1) * CELL] = limbs
    return cell_limbs


@lru_cache(maxsize=None)
def _cell_roots() -> Tuple[int, ...]:
    """Cell i's 128th root of unity, w^CELL_INDICES_RBL[i], for each i."""
    w128 = root_of_unity(K2.bit_length() - 1)
    return tuple(pow(w128, CELL_INDICES_RBL[i], R) for i in range(K2))


def _recover_inputs(cell_indices_list: Sequence[Sequence[int]], cell_limbs: Sequence[np.ndarray], device):
    """The inputs of _recover_body for B blobs given their cells (each
    blob's indices and its limbs from _check_recover_inputs)."""
    B = len(cell_indices_list)
    missing = np.ones((B, K2), dtype=bool)
    roots = np.zeros((FR.n_limbs, B, K2 // 2), dtype=np.int32)
    valid = np.zeros((B, K2 // 2), dtype=bool)
    for b, idx in enumerate(cell_indices_list):
        missing[b, list(idx)] = False
        gone = np.flatnonzero(missing[b])
        roots[:, b, : len(gone)] = fl.ints_to_limbs([_cell_roots()[i] for i in gone], FR.n_limbs)
        valid[b, : len(gone)] = True
    return (
        fl.to_device(np.stack(cell_limbs, axis=1), device),
        fl.to_device(missing, device),
        fl.to_device(roots, device),
        fl.to_device(valid, device),
    )


def recover_cells_and_kzg_proofs(
    cell_indices: Sequence[int], cells_bytes: Sequence[bytes], s: TorchKZGSettings
) -> Tuple[List[bytes], List[bytes]]:
    """All 128 cells of an extended blob and their proofs, from at least
    64 of its cells (strictly ascending indices): the batch of one."""
    cells, proofs = recover_cells_and_kzg_proofs_batch([cell_indices], [cells_bytes], s)
    return cells[0], proofs[0]


def recover_cells_and_kzg_proofs_batch(
    cell_indices_list: Sequence[Sequence[int]], cells_list: Sequence[Sequence[bytes]], s: TorchKZGSettings
) -> Tuple[List[List[bytes]], List[List[bytes]]]:
    """recover_cells_and_kzg_proofs of each blob. Every blob's inputs are
    checked, in blob order, before anything reaches the device; then one
    pass per chunk of BATCH_CHUNK blobs: one recovery body, one copy of the
    cells to the host, one FK20 proof step."""
    if len(cell_indices_list) != len(cells_list):
        raise ValueError("Cell indices & cells mismatch")
    cell_indices_list = list(cell_indices_list)
    limbs = [_check_recover_inputs(idx, cells) for idx, cells in zip(cell_indices_list, cells_list)]
    out_cells, out_proofs = [], []
    for lo in range(0, len(limbs), BATCH_CHUNK):
        idxs = cell_indices_list[lo : lo + BATCH_CHUNK]
        count("recover.blobs", sum(len(idx) < K2 for idx in idxs))
        cells, coeffs = _recover_body(*_recover_inputs(idxs, limbs[lo : lo + BATCH_CHUNK], s.device), s)
        out_cells += _cell_bytes(cells)
        out_proofs += _proof_bytes(coeffs, s)
    return out_cells, out_proofs


# ---------------------------------------------------------------------------
# Batch verification of cell proofs
# ---------------------------------------------------------------------------


def _deduplicate_with_indices(items):
    """(unique items in first-seen order, index of each item among them)."""
    unique, index_map, indices = [], {}, []
    for it in items:
        if it not in index_map:
            index_map[it] = len(unique)
            unique.append(it)
        indices.append(index_map[it])
    return unique, indices


def _batch_challenge_bytes(commitments_bytes, commitment_indices, cell_indices, cells_bytes, proofs_bytes) -> int:
    """Fiat-Shamir challenge r of verify_cell_kzg_proof_batch over the raw
    wire bytes (a cell's bytes are its scalars' 32-byte serialisations)."""
    data = bytearray()
    data += RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
    data += FIELD_ELEMENTS_PER_BLOB.to_bytes(8, "big")
    data += CELL.to_bytes(8, "big")
    data += len(commitments_bytes).to_bytes(8, "big")
    data += len(cell_indices).to_bytes(8, "big")
    for cb in commitments_bytes:
        data += cb
    for i in range(len(cell_indices)):
        data += commitment_indices[i].to_bytes(8, "big")
        data += cell_indices[i].to_bytes(8, "big")
        data += cells_bytes[i]
        data += proofs_bytes[i]
    return hash_to_bls_field(hashlib.sha256(bytes(data)).digest())


@lru_cache(maxsize=None)
def _coset_shift_pows() -> Tuple[int, ...]:
    """h_k^64 for every cell index k, h_k = w^CELL_INDICES_RBL[k] the
    shift of cell k's coset (w the 8192nd root of unity)."""
    w_cell = pow(root_of_unity(FIELD_ELEMENTS_PER_EXT_BLOB.bit_length() - 1), CELL, R)
    return tuple(pow(w_cell, CELL_INDICES_RBL[k], R) for k in range(K2))


def _cells_to_limbs(cells_bytes: Sequence[bytes], device) -> torch.Tensor:
    """Cell bytes -> canonical limbs (16, count, 64) on `device`; raises if
    a scalar is not canonical."""
    raw = np.frombuffer(b"".join(cells_bytes), dtype=np.uint8).reshape(len(cells_bytes), CELL, 32)
    limbs, ok = _bytes_to_limbs(fl.to_device(raw.copy(), device))
    if not bool(fl.to_host(ok.all())):
        raise ValueError("Invalid cell: scalar not canonical")
    return limbs


@span("kzg.body.interp")
def _agg_cells_core(cells_canon: torch.Tensor, r_limbs: torch.Tensor, cell_indices: torch.Tensor) -> torch.Tensor:
    """Per-column r-weighted cell sums. cells_canon: (16, count, 64)
    canonical limbs; r_limbs: (16, count, 1) canonical; cell_indices:
    (count,) int64. Returns (16, 128, 64) Montgomery. The weighted cells
    are summed into their columns limb by limb on int64 (index_add_), then
    reduced mod r once."""
    weighted = fl.mont_mul(FR, fl.from_canonical(FR, cells_canon), fl.from_canonical(FR, r_limbs))
    L, count, _ = weighted.shape
    slot = (cell_indices.reshape(count, 1) * CELL + torch.arange(CELL, device=weighted.device)).reshape(-1)
    acc = torch.zeros((L, K2 * CELL), dtype=torch.int64, device=weighted.device)
    acc.index_add_(1, slot, weighted.reshape(L, -1).to(torch.int64))
    return fl.reduce_sums(FR, acc).reshape(L, K2, CELL)


@span("kzg.body.interp")
def _interp_poly_core(agg_m: torch.Tensor, inv_shift_pows: torch.Tensor) -> torch.Tensor:
    """The aggregated interpolation polynomial (16, 64), Montgomery: per
    column, the inverse FFT of 64 of its sums (wire order, so bit-reversed
    first), the coset unshift by the column's powers of h^-1; then the sum
    over the columns (unused ones are zero)."""
    interp = ifft(bit_reverse(agg_m))  # (16, 128, 64)
    shifted = fl.mont_mul(FR, interp, inv_shift_pows)
    return fl.sum_tree(FR, shifted.transpose(1, 2))[..., 0]


def _verify_cell_inputs(unique_cb, commitment_indices, cell_indices, cells_bytes, proofs_bytes, r: int, device):
    """The device side's inputs: the proofs twice (24, 2, count) with the
    scalars (16, 2, count) of the proof lincomb (r^i) and of the weighted
    proofs (r^i h_i^64); the unique commitments (24, nu) with their weights
    (16, nu), each the sum of the powers r^i of its cells; the cells'
    canonical limbs (16, count, 64); r^i (16, count, 1); the cell indices
    (count,). Raises if a point does not decompress or a cell scalar is not
    canonical."""
    proofs = dg1.affine_from_ints(native.g1_decompress_batch(b"".join(proofs_bytes)), device)
    commitments = dg1.affine_from_ints(native.g1_decompress_batch(b"".join(unique_cb)), device)
    cells = _cells_to_limbs(cells_bytes, device)
    r_powers = compute_powers(r, len(cell_indices))
    h_pows = _coset_shift_pows()
    weighted_r = [rp * h_pows[ci] % R for rp, ci in zip(r_powers, cell_indices)]
    weights = [0] * commitments.x.shape[-1]
    for i, ci in enumerate(commitment_indices):
        weights[ci] = (weights[ci] + r_powers[i]) % R
    r_limbs = fl.ints_to_limbs(r_powers, FR.n_limbs)
    sc2 = np.stack([r_limbs, fl.ints_to_limbs(weighted_r, FR.n_limbs)], axis=1)
    return (
        dg1.repeat_batch(proofs, 2),
        fl.to_device(sc2, device),
        commitments,
        fl.to_device(fl.ints_to_limbs(weights, FR.n_limbs), device),
        cells,
        fl.to_device(r_limbs[:, :, None], device),
        fl.to_device(np.array(cell_indices, dtype=np.int64), device),
    )


@span("kzg.body.verify_cells")
def _verify_cell_body(p2, sc2, commitments, weights, cells, r_limbs, cell_indices, s: TorchKZGSettings) -> dg1.G1Aff:
    """The device side of verify_cell_kzg_proof_batch (the inputs of
    _verify_cell_inputs): the batch-2 proof MSM, the commitment MSM and the
    commitment to the aggregated interpolation polynomial. Returns the
    affine points [proof_lincomb, weighted_proofs, commitment_sum,
    interp_commit]. Both variable-base MSMs take the bucket path at any
    count, where the JAX package's _msm_auto takes its ladder below 8
    points (ops/msm.py msm says why)."""
    out2 = dmsm.msm(p2, sc2)  # (24, 2)
    fs = dmsm.msm(commitments, weights)  # (24,)
    agg_poly = _interp_poly_core(_agg_cells_core(cells, r_limbs, cell_indices), s.inv_coset_shift_pows)
    interp = dmsm.msm_fixed(s.monomial64_table, fl.to_canonical(FR, agg_poly))  # (24,)
    pts = dg1.G1XYZZ(*(torch.cat([a, b[:, None], c[:, None]], dim=-1) for a, b, c in zip(out2, fs, interp)))
    return dg1.to_affine(pts)


def verify_cell_kzg_proof_batch(
    commitments_bytes: Sequence[bytes],
    cell_indices: Sequence[int],
    cells_bytes: Sequence[bytes],
    proofs_bytes: Sequence[bytes],
    s: TorchKZGSettings,
) -> bool:
    """Verify many cells against their commitments and proofs with one
    pairing check:
        e(sum_k w_k C_k - [I(s)] + sum_i r^i h_i^64 pi_i, H)
            == e(sum_i r^i pi_i, [s^64]_2)
    where w_k sums the powers r^i of the cells of commitment k, and I is
    the r-weighted sum of the cells' interpolation polynomials."""
    commitments_bytes, cell_indices = list(commitments_bytes), list(cell_indices)
    cells_bytes, proofs_bytes = list(cells_bytes), list(proofs_bytes)
    count = len(cells_bytes)
    if len(cell_indices) != count:
        raise ValueError("Cell count mismatch")
    if len(commitments_bytes) != count:
        raise ValueError("Commitment count mismatch")
    if len(proofs_bytes) != count:
        raise ValueError("Proof count mismatch")
    if count == 0:
        return True
    if any(idx >= K2 for idx in cell_indices):
        raise ValueError("Invalid cell index")
    if any(len(p) != 48 for p in proofs_bytes) or any(len(c) != 48 for c in commitments_bytes):
        raise ValueError("Invalid proof/commitment length")
    unique_cb, commitment_indices = _deduplicate_with_indices(commitments_bytes)
    for cb in cells_bytes:
        if len(cb) != BYTES_PER_CELL:
            raise ValueError("Invalid cell length")
    r = _batch_challenge_bytes(unique_cb, commitment_indices, cell_indices, cells_bytes, proofs_bytes)
    inputs = _verify_cell_inputs(unique_cb, commitment_indices, cell_indices, cells_bytes, proofs_bytes, r, s.device)
    aff = _verify_cell_body(*inputs, s)
    proof_lincomb, weighted_proofs, commitment_sum, interp = dg1.affine_to_ints(aff)
    neg_interp = None if interp is None else (interp[0], (P_MOD - interp[1]) % P_MOD)
    lhs = native.g1_add(native.g1_add(commitment_sum, neg_interp), weighted_proofs)
    return native.pairings_verify(lhs, G2_GENERATOR, proof_lincomb, s.g2_monomial[CELL])


def compute_verify_cell_kzg_proof_batch_challenge(
    commitments_bytes: Sequence[bytes],
    commitment_indices: Sequence[int],
    cell_indices: Sequence[int],
    cells_bytes: Sequence[bytes],
    proofs_bytes: Sequence[bytes],
) -> int:
    """The challenge r of verify_cell_kzg_proof_batch, from deduplicated
    commitments and each cell's commitment index. Inputs are validated:
    commitments and proofs must decompress, cells must hold canonical
    scalars."""
    count = len(cells_bytes)
    if len(commitment_indices) != count or len(cell_indices) != count or len(proofs_bytes) != count:
        raise ValueError("Cell count mismatch")
    if any(len(c) != 48 for c in commitments_bytes) or any(len(p) != 48 for p in proofs_bytes):
        raise ValueError("Invalid commitment/proof length")
    if commitments_bytes:
        native.g1_decompress_batch(b"".join(commitments_bytes))
    if proofs_bytes:
        native.g1_decompress_batch(b"".join(proofs_bytes))
    for cb in cells_bytes:
        if len(cb) != BYTES_PER_CELL:
            raise ValueError("Invalid cell length")
        _, ok = bs.frs_from_bytes(cb)
        if not ok.all():
            raise ValueError("Invalid cell: scalar not canonical")
    return _batch_challenge_bytes(
        list(commitments_bytes), list(commitment_indices), list(cell_indices), list(cells_bytes), list(proofs_bytes)
    )
