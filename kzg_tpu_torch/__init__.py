"""kzg_tpu_torch: the PyTorch and CUDA port of kzg_tpu, for NVIDIA Hopper.

EIP-4844 blob commitments, proofs and their verification, and EIP-7594
cells, FK20 cell proofs and batch verification of cell proofs, with the
MSMs' bucket scan, complete point addition and window combination and the
Fr NTT's stages in hand-written CUDA kernels (csrc/); and the benches
(bench.py, benches/), with the gather probe's row gather in a kernel of
its own. Imports torch and numpy, and nothing of JAX or of the kzg_tpu
package.
"""

from .api import (
    blob_to_kzg_commitment,
    blob_to_kzg_commitment_batch,
    compute_blob_kzg_proof,
    compute_blob_kzg_proof_batch,
    compute_cells,
    compute_cells_and_kzg_proofs,
    compute_cells_and_kzg_proofs_batch,
    compute_kzg_proof,
    compute_verify_cell_kzg_proof_batch_challenge,
    load_trusted_setup,
    load_trusted_setup_file,
    verify_blob_kzg_proof,
    verify_blob_kzg_proof_batch,
    verify_cell_kzg_proof_batch,
    verify_kzg_proof,
)

__all__ = [
    "blob_to_kzg_commitment",
    "blob_to_kzg_commitment_batch",
    "compute_blob_kzg_proof",
    "compute_blob_kzg_proof_batch",
    "compute_cells",
    "compute_cells_and_kzg_proofs",
    "compute_cells_and_kzg_proofs_batch",
    "compute_kzg_proof",
    "compute_verify_cell_kzg_proof_batch_challenge",
    "load_trusted_setup",
    "load_trusted_setup_file",
    "verify_blob_kzg_proof",
    "verify_blob_kzg_proof_batch",
    "verify_cell_kzg_proof_batch",
    "verify_kzg_proof",
]
