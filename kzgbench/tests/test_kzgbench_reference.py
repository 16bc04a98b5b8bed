"""The reference against small known answers from the mainnet setup, and
against a corrupted proof."""

import random

from kzgbench.reference import curve as C
from kzgbench.reference import kzg as K
from kzgbench.reference.fields import R, bit_reversal_permutation, ntt


def _blob_of(coeffs):
    evals = bit_reversal_permutation(ntt(list(coeffs) + [0] * (K.N - len(coeffs))))
    return b"".join(v.to_bytes(32, "big") for v in evals)


def test_commitment_of_x_is_tau(setup64):
    # p = X: its evaluations are the bit-reversed roots themselves
    assert K.commitment(K.roots_brp(), setup64) == setup64.g1_monomial[1]
    assert K.commitment([1] * K.N, setup64) == C.G1_GEN == setup64.g1_monomial[0]


def test_cells_and_proofs_of_a_shifted_monomial(setup_full):
    # p = X^(64 + 5) = X^5 (X^64 - s_k) + s_k X^5 with s_k = h_k^64: the
    # quotient on every coset is X^5, so every cell proof is [tau^5]_1
    coeffs = [0] * K.N
    coeffs[K.CELL + 5] = 1
    proofs = K.cell_proofs(coeffs, setup_full)
    assert all(p == setup_full.g1_monomial[5] for p in proofs)
    cells = K.cells_from_coeffs(coeffs)
    for k in (0, 1, 77, 127):
        h = K.coset_shift(k)
        pts = K.roots_ext_brp()[K.CELL * k : K.CELL * (k + 1)]
        assert cells[k] == [pow(x, K.CELL + 5, R) for x in pts]
        assert all(pow(x, K.CELL, R) == pow(h, K.CELL, R) for x in pts)


def test_blob_proof_of_x(setup64):
    # p = X: (p - z) / (X - z) = 1, so the proof is the generator at any z
    assert K.blob_proof([0, 1], 12345, setup64) == C.G1_GEN


def test_verifiers_accept_valid_and_refuse_corrupted(setup_full):
    rng = random.Random(5)
    coeffs = [0] * K.N
    coeffs[0], coeffs[K.CELL + 3], coeffs[2 * K.CELL + 9] = 7, 11, 13
    blob = _blob_of(coeffs)
    commitment = C.g1_to_bytes(C.msm(setup_full.g1_monomial, coeffs))
    assert commitment == C.g1_to_bytes(K.commitment(K.blob_to_evals(blob), setup_full))
    cells = [K.cell_to_bytes(c) for c in K.cells_from_coeffs(coeffs)]
    proofs = [C.g1_to_bytes(p) for p in K.cell_proofs(coeffs, setup_full)]
    cols = [0, 9, 64, 127]
    args = [[commitment] * 4, cols, [cells[k] for k in cols], [proofs[k] for k in cols]]
    assert K.verify_cells(*args, setup_full, rng)
    swapped = list(args[3])
    swapped[1], swapped[2] = swapped[2], swapped[1]
    assert not K.verify_cells(*args[:3], swapped, setup_full, rng)
    assert not K.verify_cells(args[0], args[1], [cells[1]] + args[2][1:], args[3], setup_full, rng)
    z = K.challenge(blob, commitment)
    proof = C.g1_to_bytes(K.blob_proof(coeffs, z, setup_full))
    assert K.verify_blobs([blob], [commitment], [proof], setup_full, rng)
    assert not K.verify_blobs([blob], [commitment], [proofs[0]], setup_full, rng)


def test_call_checks_count_wrong_outputs(setup_full):
    rng = random.Random(9)
    coeffs = [0] * K.N
    coeffs[1], coeffs[K.CELL + 2], coeffs[2 * K.CELL + 40] = 3, 5, 8
    blob = _blob_of(coeffs)
    cells = [K.cell_to_bytes(c) for c in K.cells_from_coeffs(coeffs)]
    proofs = [C.g1_to_bytes(p) for p in K.cell_proofs(coeffs, setup_full)]
    good = K.check_cells_call([blob], [cells], [proofs], setup_full, rng)
    assert good == {"cells_wrong": 0, "proofs_malformed": 0, "proof_checks_failed": 0}
    bad_cells = list(cells)
    bad_cells[3] = cells[4]
    bad_proofs = list(proofs)
    bad_proofs[7] = proofs[8]
    assert K.check_cells_call([blob], [bad_cells], [proofs], setup_full, rng)["cells_wrong"] == 1
    assert K.check_cells_call([blob], [cells], [bad_proofs], setup_full, rng)["proof_checks_failed"] == 1
    assert K.check_cells_call([blob], [cells], [[b"\x00" * 48] + proofs[1:]], setup_full, rng)["proofs_malformed"] == 1
    commitment = C.g1_to_bytes(C.msm(setup_full.g1_monomial, coeffs))
    proof = C.g1_to_bytes(K.blob_proof(coeffs, K.challenge(blob, commitment), setup_full))
    ok = K.check_commit_prove_call([blob], [commitment], [proof], setup_full, rng)
    assert not any(ok.values())
    assert K.check_commit_prove_call([blob], [proofs[0]], [proof], setup_full, rng)["commitment_checks_failed"] == 1
    assert K.check_commit_prove_call([blob], [commitment], [proofs[0]], setup_full, rng)["proof_checks_failed"] == 1


def test_encodings_round_trip():
    p = C.mul(C.G1_GEN, 123456789)
    assert C.g1_from_bytes(C.g1_to_bytes(p)) == p
    assert C.g1_from_bytes(C.g1_to_bytes(C.neg(p))) == C.neg(p)
    assert C.g1_from_bytes(C.g1_to_bytes(None)) is None
    assert C.msm([p, C.G1_GEN, None], [2, 3, 5]) == C.affine_add(C.mul(p, 2), C.mul(C.G1_GEN, 3))
