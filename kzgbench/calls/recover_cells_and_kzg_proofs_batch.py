"""recover_cells_and_kzg_proofs_batch of a supernode rebuilding a block:
`blobs` distinct pool blobs, each given the same `columns_given` of its
128 cells (ascending, drawn per call from the seed), as recover_matrix
receives a block's column sidecars. The reference recovers every blob of
a judged call itself; the proofs must be the pool's, which the reference
made from the same polynomials (a cell's proof is unique)."""

from kzgbench.callkind import PoolCall, pool_cells
from kzgbench.reference import kzg as ref
from kzgbench.reference import recovery


class Kind(PoolCall):
    checks = ("cells_wrong", "proofs_wrong")

    def setup(self, seed):
        super().setup(seed)
        self.cells = pool_cells(self.root, self.traffic["pool"], self.pool)

    def prepare(self, seed, index):
        """(the pool blobs picked, each blob's cell indices, each blob's cells)."""
        rng, picked, _ = self.draw(seed, index)
        cols = sorted(rng.choice(ref.CELLS, size=self.traffic["columns_given"], replace=False).tolist())
        return picked, [cols] * len(picked), [[self.cells[b, k].tobytes() for k in cols] for b in picked]

    def run(self, api, s, inputs):
        return api.recover_cells_and_kzg_proofs_batch(inputs[1], inputs[2], s)

    def check(self, setup, inputs, outputs, rng):
        picked, indices, given = inputs
        cells_out, proofs_out = outputs
        cells_wrong = proofs_wrong = 0
        for j, b in enumerate(picked):
            coeffs = recovery.recover_polynomialcoeff(indices[j], [ref.cell_from_bytes(c) for c in given[j]])
            want = [ref.cell_to_bytes(c) for c in ref.cells_from_coeffs(coeffs)]
            if want != [self.cells[b, k].tobytes() for k in range(ref.CELLS)]:
                raise RuntimeError(f"the reference's recovery of pool blob {b} differs from the pool's cells")
            row = cells_out[j] if j < len(cells_out) else []
            cells_wrong += sum(k >= len(row) or row[k] != want[k] for k in range(ref.CELLS))
            row = proofs_out[j] if j < len(proofs_out) else []
            pool_proofs = self.pool["entries"][b]["cell_proofs"]
            proofs_wrong += sum(k >= len(row) or row[k] != bytes.fromhex(pool_proofs[k]) for k in range(ref.CELLS))
        return {"cells_wrong": cells_wrong, "proofs_wrong": proofs_wrong}
