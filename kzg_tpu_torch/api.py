"""The EIP-4844 and EIP-7594 functions under the names of the JAX
package's api.py, on a torch device: commit, prove and verify blobs;
compute cells and their proofs, recover them from half the cells, and
verify cell proofs in a batch; prove and verify multi-point openings.

    from kzg_tpu_torch import api as kzg
    s = kzg.load_trusted_setup_file()  # the mainnet setup, on the card
    commitment = kzg.blob_to_kzg_commitment(blob, s)

The parameters are the JAX package's (`kzg_tpu/api.py`), with `device`
added last where a function places data; `mesh` (the two batch EIP-4844
calls) is a torch DeviceMesh (parallel/distributed.py). With no path,
load_trusted_setup_file finds the setup as the JAX package does:
$KZG_TPU_TRUSTED_SETUP, else the repo's tests/trusted_setup.txt. Entry
points run on the card (CUDA) unless `device` names another one; with no
device given and no card present, loading the setup raises. Each function
is the span `kzg.api.<function>` (tracing.py), the root of its call's.
"""

from typing import List, Optional, Sequence, Tuple

from . import eip4844 as _e4
from . import eip7594 as _e7
from . import multiproof as _mp
from .settings import TorchKZGSettings, load_settings, resolve_device
from .tracing import span
from .trusted_setup import load_trusted_setup as _load_setup
from .trusted_setup import parse_trusted_setup_string  # noqa: F401  (the JAX package's api.py exports it too)

Settings = TorchKZGSettings


@span("kzg.api.load_trusted_setup")
def load_trusted_setup(
    g1_monomial_bytes: bytes, g1_lagrange_bytes: bytes, g2_monomial_bytes: bytes, device=None
) -> Settings:
    dev = resolve_device(device)
    return TorchKZGSettings(_load_setup(g1_monomial_bytes, g1_lagrange_bytes, g2_monomial_bytes), dev)


@span("kzg.api.load_trusted_setup_file")
def load_trusted_setup_file(path: Optional[str] = None, device: Optional[str] = None) -> Settings:
    return load_settings(path, device)


@span("kzg.api.blob_to_kzg_commitment")
def blob_to_kzg_commitment(blob: bytes, s: Settings) -> bytes:
    return _e4.blob_to_kzg_commitment(blob, s)


@span("kzg.api.blob_to_kzg_commitment_batch")
def blob_to_kzg_commitment_batch(blobs: Sequence[bytes], s: Settings, mesh=None) -> List[bytes]:
    """mesh: optional DeviceMesh with a "blobs" axis (parallel/distributed.py):
    every rank calls with the same blobs, commits to its share of them, and
    gets back every commitment."""
    return _e4.blob_to_kzg_commitment_batch(blobs, s, mesh=mesh)


@span("kzg.api.compute_blob_kzg_proof")
def compute_blob_kzg_proof(blob: bytes, commitment: bytes, s: Settings) -> bytes:
    return _e4.compute_blob_kzg_proof(blob, commitment, s)


@span("kzg.api.compute_blob_kzg_proof_batch")
def compute_blob_kzg_proof_batch(
    blobs: Sequence[bytes], commitments: Sequence[bytes], s: Settings
) -> List[bytes]:
    return _e4.compute_blob_kzg_proof_batch(blobs, commitments, s)


@span("kzg.api.compute_kzg_proof")
def compute_kzg_proof(blob: bytes, z: bytes, s: Settings) -> Tuple[bytes, bytes]:
    return _e4.compute_kzg_proof(blob, z, s)


@span("kzg.api.verify_kzg_proof")
def verify_kzg_proof(commitment: bytes, z: bytes, y: bytes, proof: bytes, s: Settings) -> bool:
    return _e4.verify_kzg_proof(commitment, z, y, proof, s)


@span("kzg.api.verify_blob_kzg_proof")
def verify_blob_kzg_proof(blob: bytes, commitment: bytes, proof: bytes, s: Settings) -> bool:
    return _e4.verify_blob_kzg_proof(blob, commitment, proof, s)


@span("kzg.api.verify_blob_kzg_proof_batch")
def verify_blob_kzg_proof_batch(
    blobs: Sequence[bytes], commitments: Sequence[bytes], proofs: Sequence[bytes], s: Settings, mesh=None
) -> bool:
    """mesh: optional DeviceMesh with a "blobs" axis: every rank calls with
    the same arguments; the evaluations and the lincomb's points are cut
    over the ranks, and every rank returns the answer."""
    return _e4.verify_blob_kzg_proof_batch(blobs, commitments, proofs, s, mesh=mesh)


@span("kzg.api.compute_cells")
def compute_cells(blob: bytes, s: Settings) -> List[bytes]:
    cells, _ = _e7.compute_cells_and_kzg_proofs(blob, s, with_proofs=False)
    return cells


@span("kzg.api.compute_cells_and_kzg_proofs")
def compute_cells_and_kzg_proofs(blob: bytes, s: Settings) -> Tuple[List[bytes], List[bytes]]:
    return _e7.compute_cells_and_kzg_proofs(blob, s)


@span("kzg.api.compute_cells_and_kzg_proofs_batch")
def compute_cells_and_kzg_proofs_batch(
    blobs: Sequence[bytes], s: Settings, with_proofs: bool = True
) -> Tuple[List[List[bytes]], List[List[bytes]]]:
    return _e7.compute_cells_and_kzg_proofs_batch(blobs, s, with_proofs)


@span("kzg.api.recover_cells_and_kzg_proofs")
def recover_cells_and_kzg_proofs(
    cell_indices: Sequence[int], cells: Sequence[bytes], s: Settings
) -> Tuple[List[bytes], List[bytes]]:
    return _e7.recover_cells_and_kzg_proofs(cell_indices, cells, s)


@span("kzg.api.recover_cells_and_kzg_proofs_batch")
def recover_cells_and_kzg_proofs_batch(
    cell_indices_list: Sequence[Sequence[int]], cells_list: Sequence[Sequence[bytes]], s: Settings
) -> Tuple[List[List[bytes]], List[List[bytes]]]:
    return _e7.recover_cells_and_kzg_proofs_batch(cell_indices_list, cells_list, s)


@span("kzg.api.verify_cell_kzg_proof_batch")
def verify_cell_kzg_proof_batch(
    commitments: Sequence[bytes],
    cell_indices: Sequence[int],
    cells: Sequence[bytes],
    proofs: Sequence[bytes],
    s: Settings,
) -> bool:
    return _e7.verify_cell_kzg_proof_batch(commitments, cell_indices, cells, proofs, s)


@span("kzg.api.compute_verify_cell_kzg_proof_batch_challenge")
def compute_verify_cell_kzg_proof_batch_challenge(
    commitments: Sequence[bytes],
    commitment_indices: Sequence[int],
    cell_indices: Sequence[int],
    cells: Sequence[bytes],
    proofs: Sequence[bytes],
) -> int:
    return _e7.compute_verify_cell_kzg_proof_batch_challenge(
        commitments, commitment_indices, cell_indices, cells, proofs
    )


@span("kzg.api.compute_kzg_proof_multi")
def compute_kzg_proof_multi(poly_coeffs: Sequence[int], x: int, n: int, s: Settings) -> bytes:
    return _mp.compute_kzg_proof_multi(poly_coeffs, x, n, s)


@span("kzg.api.verify_kzg_proof_multi")
def verify_kzg_proof_multi(commitment: bytes, proof: bytes, x: int, ys: Sequence[int], s: Settings) -> bool:
    return _mp.verify_kzg_proof_multi(commitment, proof, x, ys, s)
