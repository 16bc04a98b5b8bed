"""The c-kzg-4844 C ABI's byte structs and return codes, as ctypes
structures, and entry points over this package's api.py that take and
return them (the counterpart of the JAX package's c_abi.py).

This is the wire contract a C caller sees: fixed-size byte structs,
CKzgRet status codes and out-parameters. A ValueError of the API (bad
input) maps to BADARGS and any other exception to ERROR. The byte-level
module that the embedded-interpreter shim calls is c_abi_host.py.
"""

import ctypes
from enum import IntEnum
from typing import List, Optional, Tuple

from . import api
from .constants import BYTES_PER_BLOB, BYTES_PER_CELL


class CKzgRet(IntEnum):
    """c-kzg-4844's C_KZG_RET."""

    OK = 0
    BADARGS = 1
    ERROR = 2
    MALLOC = 3


class Bytes32(ctypes.Structure):
    _fields_ = [("bytes", ctypes.c_uint8 * 32)]


class Bytes48(ctypes.Structure):
    _fields_ = [("bytes", ctypes.c_uint8 * 48)]


class Blob(ctypes.Structure):
    _fields_ = [("bytes", ctypes.c_uint8 * BYTES_PER_BLOB)]


class Cell(ctypes.Structure):
    _fields_ = [("bytes", ctypes.c_uint8 * BYTES_PER_CELL)]


class KZGCommitment(Bytes48):
    pass


class KZGProof(Bytes48):
    pass


def _b(struct) -> bytes:
    return bytes(struct.bytes)


def _fill(struct_cls, data: bytes):
    s = struct_cls()
    ctypes.memmove(s.bytes, data, len(data))
    return s


def _wrap(fn):
    """Map the framework's ValueError convention to CKzgRet codes."""

    def call(*args):
        try:
            return CKzgRet.OK, fn(*args)
        except ValueError:
            return CKzgRet.BADARGS, None
        except Exception:
            return CKzgRet.ERROR, None

    return call


# ---------------------------------------------------------------------------
# Entry points, under the names of the C ABI's functions
# ---------------------------------------------------------------------------


def blob_to_kzg_commitment(blob: Blob, settings) -> Tuple[CKzgRet, Optional[KZGCommitment]]:
    ret, out = _wrap(api.blob_to_kzg_commitment)(_b(blob), settings)
    return ret, _fill(KZGCommitment, out) if out is not None else None


def compute_kzg_proof(
    blob: Blob, z: Bytes32, settings
) -> Tuple[CKzgRet, Optional[KZGProof], Optional[Bytes32]]:
    ret, out = _wrap(api.compute_kzg_proof)(_b(blob), _b(z), settings)
    if out is None:
        return ret, None, None
    return ret, _fill(KZGProof, out[0]), _fill(Bytes32, out[1])


def compute_blob_kzg_proof(
    blob: Blob, commitment: Bytes48, settings
) -> Tuple[CKzgRet, Optional[KZGProof]]:
    ret, out = _wrap(api.compute_blob_kzg_proof)(_b(blob), _b(commitment), settings)
    return ret, _fill(KZGProof, out) if out is not None else None


def verify_kzg_proof(
    commitment: Bytes48, z: Bytes32, y: Bytes32, proof: Bytes48, settings
) -> Tuple[CKzgRet, Optional[bool]]:
    return _wrap(api.verify_kzg_proof)(_b(commitment), _b(z), _b(y), _b(proof), settings)


def verify_blob_kzg_proof(
    blob: Blob, commitment: Bytes48, proof: Bytes48, settings
) -> Tuple[CKzgRet, Optional[bool]]:
    return _wrap(api.verify_blob_kzg_proof)(_b(blob), _b(commitment), _b(proof), settings)


def verify_blob_kzg_proof_batch(
    blobs: List[Blob], commitments: List[Bytes48], proofs: List[Bytes48], settings
) -> Tuple[CKzgRet, Optional[bool]]:
    return _wrap(api.verify_blob_kzg_proof_batch)(
        [_b(b) for b in blobs], [_b(c) for c in commitments], [_b(p) for p in proofs], settings
    )


def compute_cells_and_kzg_proofs(
    blob: Blob, settings
) -> Tuple[CKzgRet, Optional[List[Cell]], Optional[List[KZGProof]]]:
    ret, out = _wrap(api.compute_cells_and_kzg_proofs)(_b(blob), settings)
    if out is None:
        return ret, None, None
    cells, proofs = out
    return ret, [_fill(Cell, c) for c in cells], [_fill(KZGProof, p) for p in proofs]


def recover_cells_and_kzg_proofs(
    cell_indices: List[int], cells: List[Cell], settings
) -> Tuple[CKzgRet, Optional[List[Cell]], Optional[List[KZGProof]]]:
    ret, out = _wrap(api.recover_cells_and_kzg_proofs)(
        list(cell_indices), [_b(c) for c in cells], settings
    )
    if out is None:
        return ret, None, None
    rc, rp = out
    return ret, [_fill(Cell, c) for c in rc], [_fill(KZGProof, p) for p in rp]


def verify_cell_kzg_proof_batch(
    commitments: List[Bytes48],
    cell_indices: List[int],
    cells: List[Cell],
    proofs: List[Bytes48],
    settings,
) -> Tuple[CKzgRet, Optional[bool]]:
    return _wrap(api.verify_cell_kzg_proof_batch)(
        [_b(c) for c in commitments],
        list(cell_indices),
        [_b(c) for c in cells],
        [_b(p) for p in proofs],
        settings,
    )
