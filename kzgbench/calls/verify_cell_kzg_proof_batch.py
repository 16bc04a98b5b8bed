"""verify_cell_kzg_proof_batch of one column sidecar: the cells of `blobs`
pool blobs at one column drawn from the seed, their commitments and
proofs."""

from kzgbench.callkind import PoolCall, pool_cells
from kzgbench.reference import kzg as ref


class Kind(PoolCall):
    def setup(self, seed):
        super().setup(seed)
        self.cells = pool_cells(self.root, self.traffic["pool"], self.pool)

    def prepare(self, seed, index):
        rng, picked, bad = self.draw(seed, index)
        col = int(rng.integers(ref.CELLS))
        e = self.pool["entries"]
        proofs = [bytes.fromhex(e[b]["cell_proofs"][col]) for b in picked]
        if bad:
            proofs[bad[0]] = bytes.fromhex(e[bad[1]]["cell_proofs"][col])
        commitments = [bytes.fromhex(e[b]["commitment"]) for b in picked]
        cells = [self.cells[b, col].tobytes() for b in picked]
        return (commitments, [col] * len(picked), cells, proofs), bad is None

    def run(self, api, s, inputs):
        return api.verify_cell_kzg_proof_batch(*inputs[0], s)

    def verify(self, setup, args, rng):
        return ref.verify_cells(*args, setup, rng)
