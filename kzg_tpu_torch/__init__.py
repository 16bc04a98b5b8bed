"""kzg_tpu_torch: the PyTorch and CUDA port of kzg_tpu, for NVIDIA Hopper.

EIP-4844 blob commitments and proofs and EIP-7594 cells and FK20 cell
proofs, with the fixed-base MSM's bucket scan and complete point addition
and the Fr NTT's stages in hand-written CUDA kernels (csrc/). Imports
torch and numpy, and nothing of JAX or of the kzg_tpu package.
"""

from .api import (
    blob_to_kzg_commitment,
    blob_to_kzg_commitment_batch,
    compute_blob_kzg_proof,
    compute_blob_kzg_proof_batch,
    compute_cells,
    compute_cells_and_kzg_proofs,
    compute_cells_and_kzg_proofs_batch,
    load_trusted_setup,
    load_trusted_setup_file,
)

__all__ = [
    "blob_to_kzg_commitment",
    "blob_to_kzg_commitment_batch",
    "compute_blob_kzg_proof",
    "compute_blob_kzg_proof_batch",
    "compute_cells",
    "compute_cells_and_kzg_proofs",
    "compute_cells_and_kzg_proofs_batch",
    "load_trusted_setup",
    "load_trusted_setup_file",
]
