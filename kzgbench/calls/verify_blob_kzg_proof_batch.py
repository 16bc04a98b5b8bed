"""verify_blob_kzg_proof_batch of `blobs` pool blobs with their commitments
and proofs."""

from kzgbench.callkind import PoolCall
from kzgbench.reference import kzg as ref


class Kind(PoolCall):
    def prepare(self, seed, index):
        _, picked, bad = self.draw(seed, index)
        e = self.pool["entries"]
        proofs = [bytes.fromhex(e[b]["blob_proof"]) for b in picked]
        if bad:
            proofs[bad[0]] = bytes.fromhex(e[bad[1]]["blob_proof"])
        blobs = [self.pool["blobs"][b] for b in picked]
        commitments = [bytes.fromhex(e[b]["commitment"]) for b in picked]
        return (blobs, commitments, proofs), bad is None

    def run(self, api, s, inputs):
        return api.verify_blob_kzg_proof_batch(*inputs[0], s)

    def verify(self, setup, args, rng):
        return ref.verify_blobs(*args, setup, rng)
