"""Stand-ins for the program, for tests that drive the harness: a program
made of the reference, with one fault planted where an answer is
produced, and the control, the program with one stated guarantee broken.

The producer calls of the stand-in are fast only on sparse polynomials
(few nonzero coefficients: the reference's MSMs skip zero scalars), so the
tests that use it give those traffics sparse blobs (`sparse_blobs`).
"""

import random

from kzgbench.reference import kzg as K
from kzgbench.reference.curve import g1_to_bytes, msm
from kzgbench.reference.fields import R, bit_reversal_permutation, ntt

FAULTS = ("none", "answer_altered", "half_batch_left_out")


class _Settings:
    """Answers every table attribute the harness touches with None."""

    def __getattr__(self, name):
        return None


def sparse_blobs(rng: random.Random, count: int) -> list:
    """Blobs of c + a X^(64 + j) + b X^(128 + m) (j, m < 64, a, b, c
    drawn from rng): each cell proof is a[tau^j] + h^64 b[tau^m], distinct
    across cells."""
    out = []
    for _ in range(count):
        coeffs = [0] * K.N
        coeffs[0] = rng.randrange(R)
        coeffs[K.CELL + rng.randrange(K.CELL)] = rng.randrange(1, R)
        coeffs[2 * K.CELL + rng.randrange(K.CELL)] = rng.randrange(1, R)
        evals = bit_reversal_permutation(ntt(coeffs))
        out.append(b"".join(v.to_bytes(32, "big") for v in evals))
    return out


class StandIn:
    """The program's API made of the reference (monomial setup given whole),
    with `fault` planted in every call's answer."""

    def __init__(self, setup, fault: str = "none"):
        if fault not in FAULTS:
            raise ValueError(fault)
        self.setup = setup
        self.fault = fault
        self.rng = random.Random(1)
        self.calls = 0

    def load_trusted_setup_file(self, path=None, device=None):
        return _Settings()

    def _half(self, items: list) -> list:
        """The batch with its second half left out, the first's answers reused."""
        keep = (len(items) + 1) // 2
        return items[:keep] + [items[i % keep] for i in range(keep, len(items))]

    def compute_cells_and_kzg_proofs_batch(self, blobs, s):
        cells, proofs = [], []
        for blob in blobs:
            coeffs = K.evals_to_coeffs(K.blob_to_evals(blob))
            cells.append([K.cell_to_bytes(c) for c in K.cells_from_coeffs(coeffs)])
            proofs.append([g1_to_bytes(p) for p in K.cell_proofs(coeffs, self.setup)])
        if self.fault == "answer_altered":
            proofs[0][0], proofs[0][1] = proofs[0][1], proofs[0][0]
        elif self.fault == "half_batch_left_out":
            cells, proofs = self._half(cells), self._half(proofs)
        return cells, proofs

    def blob_to_kzg_commitment_batch(self, blobs, s):
        out = [g1_to_bytes(msm(self.setup.g1_monomial, K.evals_to_coeffs(K.blob_to_evals(b)))) for b in blobs]
        if self.fault == "answer_altered":
            out[0] = out[1]
        elif self.fault == "half_batch_left_out":
            out = self._half(out)
        return out

    def compute_blob_kzg_proof_batch(self, blobs, commitments, s):
        out = []
        for b, c in zip(blobs, commitments):
            coeffs = K.evals_to_coeffs(K.blob_to_evals(b))
            out.append(g1_to_bytes(K.blob_proof(coeffs, K.challenge(b, c), self.setup)))
        if self.fault == "half_batch_left_out":
            out = self._half(out)
        return out

    def _answer(self, verify, args):
        if self.fault == "half_batch_left_out":
            keep = (len(args[0]) + 1) // 2
            args = [a[:keep] for a in args]
        answer = verify(*args, self.setup, self.rng)
        self.calls += 1
        if self.fault == "answer_altered" and self.calls == 1:
            answer = not answer
        return answer

    def verify_cell_kzg_proof_batch(self, commitments, cell_indices, cells, proofs, s):
        return self._answer(K.verify_cells, [commitments, cell_indices, cells, proofs])

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs, s):
        return self._answer(K.verify_blobs, [blobs, commitments, proofs])


def natural_order(blob: bytes) -> bytes:
    """The blob's elements as if read in natural rather than bit-reversed
    order: the control's broken guarantee for the producer calls."""
    words = [blob[i : i + 32] for i in range(0, len(blob), 32)]
    return b"".join(bit_reversal_permutation(words))


class Control:
    """The control: the program with one stated guarantee broken. Producers
    take each blob's elements in natural instead of bit-reversed order (the
    cells, commitments and proofs of another polynomial); verifiers accept
    without the pairing check."""

    def __init__(self, api):
        self.api = api

    def load_trusted_setup_file(self, path=None, device=None):
        return self.api.load_trusted_setup_file(path, device=device)

    def compute_cells_and_kzg_proofs_batch(self, blobs, s):
        return self.api.compute_cells_and_kzg_proofs_batch([natural_order(b) for b in blobs], s)

    def blob_to_kzg_commitment_batch(self, blobs, s):
        return self.api.blob_to_kzg_commitment_batch([natural_order(b) for b in blobs], s)

    def compute_blob_kzg_proof_batch(self, blobs, commitments, s):
        return self.api.compute_blob_kzg_proof_batch([natural_order(b) for b in blobs], commitments, s)

    def verify_cell_kzg_proof_batch(self, commitments, cell_indices, cells, proofs, s):
        return True

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs, s):
        return True
