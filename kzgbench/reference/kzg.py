"""The plain reference of the benchmark's calls: EIP-4844 blobs and EIP-7594
cells as the consensus specs define them (Deneb's
polynomial-commitments.md, Fulu's polynomial-commitments-sampling.md), in
Python integers, independent of the program.

It computes what a call must return and judges what the program returned:
- cells exactly, from the blob (an inverse NTT, then the NTT on the
  extended domain in bit-reversed order), compared byte for byte;
- commitments and proofs through the relations that fix them uniquely: a
  commitment is the MSM of the blob over the bit-reversed Lagrange setup,
  a blob proof the opening at the Fiat-Shamir challenge, a cell proof the
  opening on the cell's coset. A call's commitments are compared through
  one random linear combination against the reference's own MSM, and its
  proofs through the batch pairing equation of the specs' verifiers, with
  weights the reference draws itself (128 bits each), so one wrong output
  fails its check with probability 1 - 2^-128;
- verifications by the reference's own batch verifier.

It also makes the inputs of the verify calls (pool.py): commitments, blob
proofs and every cell proof of a blob, the latter through the quotient's
split into 63 partial commitments D_j (FK20's idea in plain form).
"""

import hashlib

from . import curve
from .curve import G1_GEN, G2_GEN, g1_from_bytes, msm
from .fields import R, batch_inverse, bit_reversal_permutation, ntt, roots_of_unity
from .pairing import pairings_equal

N = 4096  # FIELD_ELEMENTS_PER_BLOB
N_EXT = 2 * N  # FIELD_ELEMENTS_PER_EXT_BLOB
CELL = 64  # FIELD_ELEMENTS_PER_CELL
CELLS = N_EXT // CELL  # CELLS_PER_EXT_BLOB
BLOB_BYTES = 32 * N
FS_DOMAIN = b"FSBLOBVERIFY_V1_"

_ROOTS_BRP = []
_ROOTS_EXT_BRP = []


def roots_brp() -> list:
    """The blob's evaluation points: the 4096th roots of unity, bit-reversed."""
    if not _ROOTS_BRP:
        _ROOTS_BRP.extend(bit_reversal_permutation(roots_of_unity(N)))
    return _ROOTS_BRP


def roots_ext_brp() -> list:
    """The extended domain's points (8192nd roots of unity), bit-reversed:
    cell k holds the evaluations at entries 64 k .. 64 k + 63."""
    if not _ROOTS_EXT_BRP:
        _ROOTS_EXT_BRP.extend(bit_reversal_permutation(roots_of_unity(N_EXT)))
    return _ROOTS_EXT_BRP


def coset_shift(k: int) -> int:
    """h_k: cell k's points are h_k times the 64th roots of unity."""
    return roots_ext_brp()[CELL * k]


# ---------------------------------------------------------------------------
# Encodings and the blob's polynomial
# ---------------------------------------------------------------------------


def blob_to_evals(blob: bytes) -> list:
    """The blob's 4096 field elements; raises ValueError on a length or an
    element that is not canonical."""
    if len(blob) != BLOB_BYTES:
        raise ValueError(f"blob of {len(blob)} bytes")
    out = [int.from_bytes(blob[i : i + 32], "big") for i in range(0, BLOB_BYTES, 32)]
    if any(v >= R for v in out):
        raise ValueError("blob element not canonical")
    return out


def evals_to_coeffs(evals: list) -> list:
    """Monomial coefficients of the polynomial with these evaluations at
    the bit-reversed roots."""
    return ntt(bit_reversal_permutation(evals), inverse=True)


def cells_from_coeffs(coeffs: list) -> list:
    """The 128 cells of the extended blob, each a list of 64 field elements."""
    ext = bit_reversal_permutation(ntt(list(coeffs) + [0] * (N_EXT - len(coeffs))))
    return [ext[CELL * k : CELL * (k + 1)] for k in range(CELLS)]


def cell_to_bytes(values: list) -> bytes:
    return b"".join(v.to_bytes(32, "big") for v in values)


def cell_from_bytes(b: bytes) -> list:
    if len(b) != 32 * CELL:
        raise ValueError(f"cell of {len(b)} bytes")
    out = [int.from_bytes(b[i : i + 32], "big") for i in range(0, len(b), 32)]
    if any(v >= R for v in out):
        raise ValueError("cell element not canonical")
    return out


def challenge(blob: bytes, commitment: bytes) -> int:
    """compute_challenge of the Deneb specs: the blob's Fiat-Shamir point."""
    data = FS_DOMAIN + N.to_bytes(16, "big") + blob + commitment
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


def evaluate(evals: list, z: int) -> int:
    """The polynomial in evaluation form at z (barycentric formula)."""
    roots = roots_brp()
    if z in roots:
        return evals[roots.index(z)]
    inv = batch_inverse([(z - w) % R for w in roots])
    acc = 0
    for f, w, d in zip(evals, roots, inv):
        acc += f * w % R * d
    return acc % R * ((pow(z, N, R) - 1) % R) % R * pow(N, R - 2, R) % R


# ---------------------------------------------------------------------------
# What the producers must return (used for the pool and the tests)
# ---------------------------------------------------------------------------


def commitment(evals: list, setup):
    return msm(setup.g1_lagrange_brp, evals)


def blob_proof(coeffs: list, z: int, setup):
    """The opening of the polynomial at z: [q(tau)] for q = (p - p(z)) / (X - z)."""
    q = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (coeffs[i] + acc * z) % R
        q[i - 1] = acc
    return msm(setup.g1_monomial[: len(q)], q)


def cell_proofs(coeffs: list, setup) -> list:
    """All 128 cell proofs of a blob. Cell k's proof commits to the
    quotient of p by X^64 - s_k, s_k = h_k^64, whose coefficient i is
    sum_{j >= 1} s_k^(j-1) p_(i + 64 j); so the proof is sum_j s_k^(j-1)
    D_j with D_j = sum_i p_(i + 64 j) [tau^i]."""
    d = [msm(setup.g1_monomial[: N - CELL * j], coeffs[CELL * j :]) for j in range(1, N // CELL)]
    out = []
    for k in range(CELLS):
        s = pow(coset_shift(k), CELL, R)
        out.append(msm(d, [pow(s, j, R) for j in range(len(d))]))
    return out


# ---------------------------------------------------------------------------
# Judging a call's outputs
# ---------------------------------------------------------------------------


def _decode_all(encoded: list):
    """Points of the encodings and the number that do not decode (those
    count as infinity in the sums, so their check fails too)."""
    pts, bad = [], 0
    for b in encoded:
        try:
            pts.append(g1_from_bytes(b))
        except ValueError:
            pts.append(None)
            bad += 1
    return pts, bad


def _interpolation_commitment(weighted_cells: dict, setup):
    """[sum_k I_k(tau)]_1 where I_k interpolates the weighted sum of the
    cells at column k on its coset: `weighted_cells` maps k to the 64
    weighted values."""
    total = [0] * CELL
    for k, vals in weighted_cells.items():
        j_coeffs = ntt(bit_reversal_permutation(vals), inverse=True)
        h_inv = pow(coset_shift(k), R - 2, R)
        f = 1
        for m in range(CELL):
            total[m] = (total[m] + j_coeffs[m] * f) % R
            f = f * h_inv % R
    return msm(setup.g1_monomial[:CELL], total)


def _cell_equation(commit_sum, items, proofs, weights, setup) -> bool:
    """The specs' batch equation for cell proofs: e(sum r_i pi_i, [tau^64]_2)
    == e(sum r_i C_i - [sum r_i I_i(tau)]_1 + sum r_i h_i^64 pi_i, G2), with
    `commit_sum` = sum r_i C_i and items (column, values) per proof."""
    weighted = {}
    for (k, vals), r in zip(items, weights):
        acc = weighted.setdefault(k, [0] * CELL)
        for m, v in enumerate(vals):
            acc[m] = (acc[m] + r * v) % R
    interp = _interpolation_commitment(weighted, setup)
    lhs = msm(proofs, weights)
    shifted = msm(proofs, [r * pow(coset_shift(k), CELL, R) % R for (k, _), r in zip(items, weights)])
    rhs = curve.affine_add(curve.affine_add(commit_sum, curve.neg(interp)), shifted)
    return pairings_equal(lhs, setup.g2_monomial[CELL], rhs, G2_GEN)


def _blob_equation(commit_sum, zs, ys, proofs, weights, setup) -> bool:
    """The batch equation for blob proofs: e(sum r_i pi_i, [tau]_2) ==
    e(sum r_i C_i - [sum r_i y_i]_1 + sum r_i z_i pi_i, G2)."""
    lhs = msm(proofs, weights)
    y_sum = sum(r * y for r, y in zip(weights, ys)) % R
    zp = msm(proofs, [r * z % R for r, z in zip(weights, zs)])
    rhs = curve.affine_add(curve.affine_add(commit_sum, curve.neg(curve.mul(G1_GEN, y_sum))), zp)
    return pairings_equal(lhs, setup.g2_monomial[1], rhs, G2_GEN)


def check_cells_call(blobs: list, cells_out: list, proofs_out: list, setup, rng) -> dict:
    """Judge one compute_cells_and_kzg_proofs_batch call: counts of cells
    that differ from the reference's bytes, of proofs that do not decode,
    and 1 if the batch equation over all the call's proofs (against the
    reference's own commitments and cells) fails."""
    evals = [blob_to_evals(b) for b in blobs]
    ref_cells = [cells_from_coeffs(evals_to_coeffs(e)) for e in evals]
    cells_wrong = 0
    for b, ref in enumerate(ref_cells):
        row = cells_out[b] if b < len(cells_out) else []
        for k in range(CELLS):
            if k >= len(row) or row[k] != cell_to_bytes(ref[k]):
                cells_wrong += 1
    flat = [proofs_out[b][k] if b < len(proofs_out) and k < len(proofs_out[b]) else b"" for b in range(len(blobs)) for k in range(CELLS)]
    proofs, malformed = _decode_all(flat)
    weights = [rng.getrandbits(128) for _ in flat]
    per_blob = [sum(weights[b * CELLS : (b + 1) * CELLS]) % R for b in range(len(blobs))]
    combined = [sum(w * e[i] for w, e in zip(per_blob, evals)) % R for i in range(N)]
    commit_sum = msm(setup.g1_lagrange_brp, combined)
    items = [(k, ref_cells[b][k]) for b in range(len(blobs)) for k in range(CELLS)]
    ok = _cell_equation(commit_sum, items, proofs, weights, setup)
    return {"cells_wrong": cells_wrong, "proofs_malformed": malformed, "proof_checks_failed": int(not ok)}


def check_commit_prove_call(blobs: list, commitments_out: list, proofs_out: list, setup, rng) -> dict:
    """Judge one commit-then-prove call: 1 if the random combination of the
    commitments differs from the reference's MSM of the same combination
    of the blobs, 1 if the batch equation of the blob proofs fails, and
    the counts of outputs that do not decode."""
    evals = [blob_to_evals(b) for b in blobs]
    n = len(blobs)
    c_bytes = [commitments_out[i] if i < len(commitments_out) else b"" for i in range(n)]
    p_bytes = [proofs_out[i] if i < len(proofs_out) else b"" for i in range(n)]
    commits, bad_c = _decode_all(c_bytes)
    proofs, bad_p = _decode_all(p_bytes)
    weights = [rng.getrandbits(128) for _ in range(n)]
    combined = [sum(w * e[i] for w, e in zip(weights, evals)) % R for i in range(N)]
    ref_sum = msm(setup.g1_lagrange_brp, combined)
    commit_ok = msm(commits, weights) == ref_sum and not bad_c
    zs = [challenge(b, c) for b, c in zip(blobs, c_bytes)]
    ys = [evaluate(e, z) for e, z in zip(evals, zs)]
    proof_ok = _blob_equation(ref_sum, zs, ys, proofs, weights, setup)
    return {
        "commitments_malformed": bad_c,
        "commitment_checks_failed": int(not commit_ok),
        "proofs_malformed": bad_p,
        "proof_checks_failed": int(not proof_ok),
    }


def verify_cells(commitments: list, cell_indices: list, cells: list, proofs: list, setup, rng) -> bool:
    """verify_cell_kzg_proof_batch: True if every cell proof is valid for
    its commitment, cell index and cell (one batch equation, weights from
    rng); False if any input does not decode or a proof is invalid."""
    try:
        pts = [g1_from_bytes(b) for b in proofs]
        vals = [cell_from_bytes(c) for c in cells]
        uniq = list(dict.fromkeys(commitments))
        cpts = [g1_from_bytes(b) for b in uniq]
    except ValueError:
        return False
    weights = [rng.getrandbits(128) for _ in proofs]
    cw = [0] * len(uniq)
    for c, r in zip(commitments, weights):
        cw[uniq.index(c)] = (cw[uniq.index(c)] + r) % R
    return _cell_equation(msm(cpts, cw), list(zip(cell_indices, vals)), pts, weights, setup)


def verify_blobs(blobs: list, commitments: list, proofs: list, setup, rng) -> bool:
    """verify_blob_kzg_proof_batch: True if every blob proof opens its
    commitment at the blob's challenge (one batch equation)."""
    try:
        evals = [blob_to_evals(b) for b in blobs]
        cpts = [g1_from_bytes(b) for b in commitments]
        pts = [g1_from_bytes(b) for b in proofs]
    except ValueError:
        return False
    weights = [rng.getrandbits(128) for _ in blobs]
    zs = [challenge(b, c) for b, c in zip(blobs, commitments)]
    ys = [evaluate(e, z) for e, z in zip(evals, zs)]
    return _blob_equation(msm(cpts, weights), zs, ys, pts, weights, setup)

