"""compute_cells_and_kzg_proofs_batch of `blobs` fresh blobs."""

from kzgbench.callkind import FreshBlobs
from kzgbench.reference import kzg as ref


class Kind(FreshBlobs):
    checks = ("cells_wrong", "proofs_malformed", "proof_checks_failed")

    def run(self, api, s, blobs):
        return api.compute_cells_and_kzg_proofs_batch(blobs, s)

    def check(self, setup, blobs, outputs, rng):
        cells, proofs = outputs
        return ref.check_cells_call(blobs, cells, proofs, setup, rng)
