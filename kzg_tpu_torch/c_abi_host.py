"""The byte-level host module of the c-kzg-4844 C ABI: the functions
that the embedded-interpreter shim (csrc/c_abi_shim.cpp, built by
c_abi_build.py into libckzg_tpu.so) calls by name. The counterpart of
the JAX package's c_abi_host.py.

Every function takes and returns plain bytes and ints, so the C side
needs only PyObject_CallMethod with buffers. The shim keeps the
CKZGSettings pointer; this module keeps the live settings in a registry
keyed by an integer handle.

A C caller cannot name a device, so settings go on the card, unless
$KZG_TPU_TORCH_DEVICE names another device (such as `cpu`); this module is
the only reader of that variable. With no card and no such variable, a
load returns ERROR and nothing runs on the CPU.

The CKZGSettings arrays are produced in blst's in-memory layouts:
  - blst_fr:        4 x u64 little-endian limbs, Montgomery form R = 2^256
  - blst_p1/p2:     projective (x, y, z), each coordinate 6 x u64 (12 x u64
                    for Fp2) little-endian Montgomery limbs R = 2^384;
                    infinity encoded as z == 0 (blst convention)
"""

import os
import struct
from typing import Dict, List, Optional, Tuple

from . import api
from .constants import (
    BYTES_PER_BLOB,
    BYTES_PER_CELL,
    P_MOD,
    R_MOD,
)
from .eip7594 import compute_verify_cell_kzg_proof_batch_challenge as _challenge
from .ops.g1 import affine_to_ints
from .trusted_setup import parse_trusted_setup_string

# CKzgRet codes
OK, BADARGS, ERROR, MALLOC = 0, 1, 2, 3

_REGISTRY: Dict[int, object] = {}
_NEXT_HANDLE = [1]

_R_FR = 1 << 256
_R_FP = 1 << 384


def _fr_mont_bytes(v: int) -> bytes:
    return (v * _R_FR % R_MOD).to_bytes(32, "little")


def _fp_mont_bytes(v: int) -> bytes:
    return (v * _R_FP % P_MOD).to_bytes(48, "little")


def _p1_bytes(p) -> bytes:
    """Affine point (ints, or None) -> blst_p1 projective bytes (z=1; inf z=0)."""
    if p is None:
        return b"\x00" * 144
    return _fp_mont_bytes(p[0]) + _fp_mont_bytes(p[1]) + _fp_mont_bytes(1)


def _p2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 288
    (x0, x1), (y0, y1) = p
    return (
        _fp_mont_bytes(x0)
        + _fp_mont_bytes(x1)
        + _fp_mont_bytes(y0)
        + _fp_mont_bytes(y1)
        + _fp_mont_bytes(1)
        + _fp_mont_bytes(0)
    )


def _settings(handle: int):
    s = _REGISTRY.get(handle)
    if s is None:
        raise ValueError("unknown settings handle")
    return s


# ---------------------------------------------------------------------------
# Trusted setup
# ---------------------------------------------------------------------------


def _device():
    """The device settings go on: $KZG_TPU_TORCH_DEVICE where it is set,
    else the card (None)."""
    return os.environ.get("KZG_TPU_TORCH_DEVICE") or None


def load_trusted_setup(
    g1_monomial_bytes: bytes, g1_lagrange_bytes: bytes, g2_monomial_bytes: bytes
) -> Tuple[int, int]:
    """Returns (ret, handle)."""
    try:
        s = api.load_trusted_setup(
            g1_monomial_bytes, g1_lagrange_bytes, g2_monomial_bytes, device=_device()
        )
        h = _NEXT_HANDLE[0]
        _NEXT_HANDLE[0] += 1
        _REGISTRY[h] = s
        return OK, h
    except ValueError:
        return BADARGS, 0
    except Exception:
        return ERROR, 0


def load_trusted_setup_contents(contents: bytes) -> Tuple[int, int]:
    """Parse a trusted_setup.txt image (counts, then the Lagrange G1, the
    monomial G2 and the monomial G1 points, in hex)."""
    try:
        g1m, g1l, g2m = parse_trusted_setup_string(contents.decode("ascii"))
        return load_trusted_setup(g1m, g1l, g2m)
    except (ValueError, UnicodeDecodeError):
        return BADARGS, 0
    except Exception:
        return ERROR, 0


def load_trusted_setup_file(path: str) -> Tuple[int, int]:
    try:
        with open(path, "rb") as f:
            return load_trusted_setup_contents(f.read())
    except OSError:
        return BADARGS, 0
    except Exception:
        return ERROR, 0


def free_trusted_setup(handle: int) -> None:
    _REGISTRY.pop(handle, None)


def settings_arrays(handle: int) -> Tuple[int, Optional[List[bytes]]]:
    """blst-layout payloads for the CKZGSettings struct fields, in order:
    [roots_of_unity (8193 fr), brp_roots_of_unity (8192 fr),
     reverse_roots_of_unity (8193 fr), g1_values_monomial (4096 p1),
     g1_values_lagrange_brp (4096 p1), g2_values_monomial (65 p2),
     x_ext_fft_columns (128 cols x 64 p1, concatenated)]. The counts are
    the mainnet setup's; the column points are built on the settings'
    device (or read from the disk cache) and read back as ints."""
    try:
        s = _settings(handle)
        roots = b"".join(_fr_mont_bytes(v) for v in s.roots_of_unity)
        brp = b"".join(_fr_mont_bytes(v) for v in s.brp_roots_of_unity)
        rev = b"".join(_fr_mont_bytes(v) for v in s.reverse_roots_of_unity)
        g1m = b"".join(_p1_bytes(p) for p in s.setup.g1_monomial)
        g1l = b"".join(_p1_bytes(p) for p in s.setup.g1_lagrange_brp)
        g2m = b"".join(_p2_bytes(p) for p in s.setup.g2_monomial)
        xext = b"".join(_p1_bytes(p) for p in affine_to_ints(s.x_ext_fft_columns))
        return OK, [roots, brp, rev, g1m, g1l, g2m, xext]
    except Exception:
        return ERROR, None


def x_ext_fft_dims(handle: int) -> Tuple[int, int]:
    """(columns, points a column) of x_ext_fft_columns: (128, 64) on the
    mainnet setup."""
    cols = _settings(handle).x_ext_fft_columns
    return cols.x.shape[1], cols.x.shape[2]


# ---------------------------------------------------------------------------
# EIP-4844
# ---------------------------------------------------------------------------


def _b(x: Optional[bytes]) -> bytes:
    """NULL C pointers arrive as None (Py_BuildValue y# with a null ptr);
    with a zero count they are legal and mean 'empty'."""
    return x if x is not None else b""


def _run(fn, *args) -> Tuple[int, Optional[bytes]]:
    try:
        return OK, fn(*args)
    except ValueError:
        return BADARGS, None
    except Exception:
        return ERROR, None


def blob_to_kzg_commitment(blob: bytes, handle: int) -> Tuple[int, Optional[bytes]]:
    return _run(api.blob_to_kzg_commitment, blob, _settings(handle))


def compute_kzg_proof(blob: bytes, z: bytes, handle: int) -> Tuple[int, Optional[bytes]]:
    ret, out = _run(api.compute_kzg_proof, blob, z, _settings(handle))
    if out is None:
        return ret, None
    return ret, out[0] + out[1]  # proof(48) || y(32)


def compute_blob_kzg_proof(
    blob: bytes, commitment: bytes, handle: int
) -> Tuple[int, Optional[bytes]]:
    return _run(api.compute_blob_kzg_proof, blob, commitment, _settings(handle))


def verify_kzg_proof(
    commitment: bytes, z: bytes, y: bytes, proof: bytes, handle: int
) -> Tuple[int, int]:
    ret, out = _run(api.verify_kzg_proof, commitment, z, y, proof, _settings(handle))
    return ret, 1 if out else 0


def verify_blob_kzg_proof(
    blob: bytes, commitment: bytes, proof: bytes, handle: int
) -> Tuple[int, int]:
    ret, out = _run(api.verify_blob_kzg_proof, blob, commitment, proof, _settings(handle))
    return ret, 1 if out else 0


def verify_blob_kzg_proof_batch(
    blobs: bytes, commitments: bytes, proofs: bytes, n: int, handle: int
) -> Tuple[int, int]:
    """Flat concatenated inputs (n blobs / 48-byte commitments / proofs)."""
    blobs, commitments, proofs = _b(blobs), _b(commitments), _b(proofs)
    if len(blobs) != n * BYTES_PER_BLOB or len(commitments) != n * 48 or len(proofs) != n * 48:
        return BADARGS, 0
    bl = [blobs[i * BYTES_PER_BLOB : (i + 1) * BYTES_PER_BLOB] for i in range(n)]
    cm = [commitments[i * 48 : (i + 1) * 48] for i in range(n)]
    pf = [proofs[i * 48 : (i + 1) * 48] for i in range(n)]
    ret, out = _run(api.verify_blob_kzg_proof_batch, bl, cm, pf, _settings(handle))
    return ret, 1 if out else 0


# ---------------------------------------------------------------------------
# EIP-7594
# ---------------------------------------------------------------------------


def compute_cells_and_kzg_proofs(blob: bytes, handle: int) -> Tuple[int, Optional[bytes]]:
    ret, out = _run(api.compute_cells_and_kzg_proofs, blob, _settings(handle))
    if out is None:
        return ret, None
    cells, proofs = out
    return ret, b"".join(cells) + b"".join(proofs)


def recover_cells_and_kzg_proofs(
    cell_indices: bytes, cells: bytes, num_cells: int, handle: int
) -> Tuple[int, Optional[bytes]]:
    """cell_indices: num_cells u64 LE; cells: num_cells * BYTES_PER_CELL."""
    if len(cell_indices) != 8 * num_cells or len(cells) != num_cells * BYTES_PER_CELL:
        return BADARGS, None
    idx = list(struct.unpack(f"<{num_cells}Q", cell_indices)) if num_cells else []
    cl = [cells[i * BYTES_PER_CELL : (i + 1) * BYTES_PER_CELL] for i in range(num_cells)]
    ret, out = _run(api.recover_cells_and_kzg_proofs, idx, cl, _settings(handle))
    if out is None:
        return ret, None
    rc, rp = out
    return ret, b"".join(rc) + b"".join(rp)


def compute_verify_cell_kzg_proof_batch_challenge(
    commitments: bytes, num_commitments: int, commitment_indices: bytes,
    cell_indices: bytes, cells: bytes, proofs: bytes, num_cells: int,
) -> Tuple[int, Optional[bytes]]:
    """Returns (ret, blst_fr Montgomery LE bytes of the challenge r).
    Stateless: needs no settings handle, as the C export takes none."""
    commitments, commitment_indices = _b(commitments), _b(commitment_indices)
    cell_indices, cells, proofs = _b(cell_indices), _b(cells), _b(proofs)
    if (
        len(commitments) != 48 * num_commitments
        or len(commitment_indices) != 8 * num_cells
        or len(cell_indices) != 8 * num_cells
        or len(cells) != BYTES_PER_CELL * num_cells
        or len(proofs) != 48 * num_cells
    ):
        return BADARGS, None
    cm = [commitments[i * 48 : (i + 1) * 48] for i in range(num_commitments)]
    cidx = list(struct.unpack(f"<{num_cells}Q", commitment_indices)) if num_cells else []
    idx = list(struct.unpack(f"<{num_cells}Q", cell_indices)) if num_cells else []
    cl = [cells[i * BYTES_PER_CELL : (i + 1) * BYTES_PER_CELL] for i in range(num_cells)]
    pf = [proofs[i * 48 : (i + 1) * 48] for i in range(num_cells)]
    ret, r = _run(_challenge, cm, cidx, idx, cl, pf)
    if r is None:
        return ret, None
    return ret, _fr_mont_bytes(r)


def verify_cell_kzg_proof_batch(
    commitments: bytes, cell_indices: bytes, cells: bytes, proofs: bytes,
    num_cells: int, handle: int,
) -> Tuple[int, int]:
    commitments, cell_indices = _b(commitments), _b(cell_indices)
    cells, proofs = _b(cells), _b(proofs)
    if (
        len(commitments) != 48 * num_cells
        or len(cell_indices) != 8 * num_cells
        or len(cells) != BYTES_PER_CELL * num_cells
        or len(proofs) != 48 * num_cells
    ):
        return BADARGS, 0
    cm = [commitments[i * 48 : (i + 1) * 48] for i in range(num_cells)]
    idx = list(struct.unpack(f"<{num_cells}Q", cell_indices)) if num_cells else []
    cl = [cells[i * BYTES_PER_CELL : (i + 1) * BYTES_PER_CELL] for i in range(num_cells)]
    pf = [proofs[i * 48 : (i + 1) * 48] for i in range(num_cells)]
    ret, out = _run(
        api.verify_cell_kzg_proof_batch, cm, idx, cl, pf, _settings(handle)
    )
    return ret, 1 if out else 0
