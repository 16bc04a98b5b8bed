"""blob_to_kzg_commitment_batch of `blobs` fresh blobs, then
compute_blob_kzg_proof_batch of those blobs with their commitments."""

from kzgbench.callkind import FreshBlobs
from kzgbench.reference import kzg as ref


class Kind(FreshBlobs):
    checks = ("commitments_malformed", "commitment_checks_failed", "proofs_malformed", "proof_checks_failed")

    def run(self, api, s, blobs):
        commitments = api.blob_to_kzg_commitment_batch(blobs, s)
        return commitments, api.compute_blob_kzg_proof_batch(blobs, commitments, s)

    def check(self, setup, blobs, outputs, rng):
        commitments, proofs = outputs
        return ref.check_commit_prove_call(blobs, commitments, proofs, setup, rng)
