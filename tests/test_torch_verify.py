"""kzg_tpu_torch's batch verification on the CPU, on the mainnet setup:
cells (verify_cell_kzg_proof_batch and its challenge) and blobs
(verify_blob_kzg_proof_batch, verify_blob_kzg_proof, verify_kzg_proof),
against the oracle (Python ints) and the JAX package's results, with its
errors. Tolerance: exact (affine points, integers, booleans).

The inputs come from the JAX package's native host core and the oracle,
which make them in milliseconds: commitments and blob proofs through
kzg_tpu.eip4844 (native-routed), cells through the oracle's FFTs, and
cell proofs as commitments to the quotients by x^64 - h^64 (native MSMs).
The JAX settings wrap the port's decoded points (the JAX package's own
file loader decodes the setup in pure Python, which takes minutes)."""

import os

import numpy as np
import pytest
import torch

from kzg_tpu import eip4844 as je4
from kzg_tpu import eip7594 as je7
from kzg_tpu import native as jn
from kzg_tpu.ops import g1 as jg
from kzg_tpu.ops import msm as jm
from kzg_tpu.oracle import das as od
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu.oracle.msm import msm as oracle_msm
from kzg_tpu.settings import DeviceKZGSettings
from kzg_tpu_torch import api, convert, tracing
from kzg_tpu_torch import eip7594 as te7
from kzg_tpu_torch.constants import R_MOD as R
from kzg_tpu_torch.ops import g1 as tg

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SETUP = os.path.join(os.path.dirname(__file__), "trusted_setup.txt")


def _blob(seed):
    a = np.random.default_rng(seed).integers(0, 256, (4096, 32), dtype=np.uint8)
    a[:, 0] &= 0x3F  # below r
    return a.tobytes()


BLOBS = [_blob(31), _blob(32), _blob(33), _blob(34)]
# (blob, column) of the cells under test: two blobs, columns 5 and 64 from both
CELLS = [(0, 0), (0, 5), (1, 5), (0, 64), (0, 100), (0, 127), (1, 3), (1, 9), (1, 64), (1, 77), (1, 126), (0, 1)]
FEW = [1, 2, 9]  # three cells: proof and commitment MSMs of fewer than 8 points
# one column of a block: up to 6 blobs (EIP-7691's target), and a seventh
# blob whose proof at the column is foreign to each of them
COLUMN, COLUMN_BLOBS = 77, BLOBS + [_blob(35), _blob(36), _blob(37)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    yield api.load_trusted_setup_file(SETUP, device="cpu")
    mp.undo()


@pytest.fixture(scope="module")
def oracle(port):
    st = port.setup
    return KZGSettingsOracle(FFTSettingsOracle.new(13), st.g1_monomial, st.g1_lagrange_brp, st.g2_monomial)


@pytest.fixture(scope="module")
def reference(oracle):
    return DeviceKZGSettings(oracle)


@pytest.fixture(scope="module")
def commitments(reference):
    return [je4.blob_to_kzg_commitment(b, reference) for b in BLOBS]


def _blob_cells(oracle, blob):
    """A blob's polynomial (monomial form) and its 128 cells, by the oracle."""
    return od.poly_lagrange_to_monomial(od.bytes_to_blob(blob)), od.compute_cells_and_kzg_proofs(blob, oracle, False)[0]


def _cell_proof(oracle, poly, col):
    """The proof of the cell at `col`: the commitment to the quotient of the
    polynomial by x^64 - h^64, by the native core's MSM."""
    c = od._get_coset_shift_pow_for_cell(col, oracle)
    q = [0] * (len(poly) - 64)
    for k in range(len(q) - 1, -1, -1):  # p = q (x^64 - c) + rest
        q[k] = (poly[k + 64] + (c * q[k + 64] if k + 64 < len(q) else 0)) % R
    return jn.g1_compress_batch([jn.g1_msm(oracle.g1_monomial[: len(q)], q)])[0]


@pytest.fixture(scope="module")
def cells(oracle, commitments):
    """(commitments, cell indices, cells, proofs) of CELLS."""
    out_cells, out_proofs = [], []
    by_blob = {}
    for b, col in CELLS:
        if b not in by_blob:
            by_blob[b] = _blob_cells(oracle, BLOBS[b])
        poly, blob_cells = by_blob[b]
        out_cells.append(blob_cells[col])
        out_proofs.append(_cell_proof(oracle, poly, col))
    return [commitments[b] for b, _ in CELLS], [col for _, col in CELLS], out_cells, out_proofs


@pytest.fixture(scope="module")
def column(oracle, reference):
    """(commitments, cell indices, cells, proofs) of COLUMN in each blob of
    COLUMN_BLOBS."""
    out = [], [], [], []
    for blob in COLUMN_BLOBS:
        poly, blob_cells = _blob_cells(oracle, blob)
        for v, x in zip(out, (je4.blob_to_kzg_commitment(blob, reference), COLUMN, blob_cells[COLUMN], _cell_proof(oracle, poly, COLUMN))):
            v.append(x)
    return out


def _oracle_points(oracle, cb, idx, cl, pr):
    """The four points of the device side, from the oracle with Python ints."""
    unique, cidx = od._deduplicate_with_indices(cb)
    cells_fr = [od.cell_from_bytes(c) for c in cl]
    r = od.compute_verify_cell_kzg_proof_batch_challenge(unique, cidx, idx, cells_fr, pr, oracle)
    rp = od.compute_powers(r, len(idx))
    proofs = jn.g1_decompress_batch(b"".join(pr))
    weights = [0] * len(unique)
    for i, ci in enumerate(cidx):
        weights[ci] = (weights[ci] + rp[i]) % R
    weighted_r = [rp[i] * od._get_coset_shift_pow_for_cell(idx[i], oracle) % R for i in range(len(idx))]
    return r, [
        oracle_msm(proofs, rp),
        oracle_msm(proofs, weighted_r),
        oracle_msm(jn.g1_decompress_batch(b"".join(unique)), weights),
        od.compute_commitment_to_aggregated_interpolation_poly(rp, idx, cells_fr, oracle),
    ]


@pytest.mark.parametrize("which", ["few", "many"])
def test_cell_verify_matches_oracle_and_jax(port, oracle, reference, cells, which, monkeypatch):
    """The verdict equals the JAX package's, and the four points of the
    call's device side equal the oracle's; a changed cell and two swapped
    proofs give False."""
    sel = FEW if which == "few" else range(len(CELLS))
    cb, idx, cl, pr = ([v[i] for i in sel] for v in cells)
    r, want = _oracle_points(oracle, cb, idx, cl, pr)
    unique, cidx = te7._deduplicate_with_indices(cb)
    assert te7._batch_challenge_bytes(unique, cidx, idx, cl, pr) == r
    body, seen = te7._verify_cell_body, []
    monkeypatch.setattr(te7, "_verify_cell_body", lambda *a: seen.append(body(*a)) or seen[-1])
    assert api.verify_cell_kzg_proof_batch(cb, idx, cl, pr, port) is True
    assert tg.affine_to_ints(seen[0]) == want
    assert je7.verify_cell_kzg_proof_batch(cb, idx, cl, pr, reference) is True

    bad = bytearray(cl[1])
    bad[-1] ^= 1  # still canonical
    tampered = cl[:1] + [bytes(bad)] + cl[2:]
    swapped = [pr[1], pr[0]] + pr[2:]
    for args in ((cb, idx, tampered, pr), (cb, idx, cl, swapped)):
        assert api.verify_cell_kzg_proof_batch(*args, port) is False
        assert je7.verify_cell_kzg_proof_batch(*args, reference) is False


@pytest.mark.parametrize("blobs", [1, 6])
def test_one_column_verify_matches_oracle_and_jax(port, oracle, reference, column, blobs, monkeypatch):
    """One column of a block of 1 and of 6 blobs: each of the three
    variable-base MSM rows (the proof lincomb's two, the commitments')
    has fewer than 8 points, and msm.small counts them. The four points
    of the device side equal the oracle's, and the verdict equals the
    JAX package's: True, then False with one proof replaced by another
    blob's at the same column."""
    cb, idx, cl, pr = (v[:blobs] for v in column)
    _, want = _oracle_points(oracle, cb, idx, cl, pr)
    body, seen = te7._verify_cell_body, []
    monkeypatch.setattr(te7, "_verify_cell_body", lambda *a: seen.append(body(*a)) or seen[-1])
    before = tracing.counters().get("msm.small", 0)
    assert api.verify_cell_kzg_proof_batch(cb, idx, cl, pr, port) is True
    assert tracing.counters()["msm.small"] - before == 3
    assert tg.affine_to_ints(seen[0]) == want
    assert je7.verify_cell_kzg_proof_batch(cb, idx, cl, pr, reference) is True
    foreign = pr[:-1] + [column[3][-1]]
    assert api.verify_cell_kzg_proof_batch(cb, idx, cl, foreign, port) is False
    assert je7.verify_cell_kzg_proof_batch(cb, idx, cl, foreign, reference) is False


def test_cell_challenge_matches_jax(cells):
    cb, idx, cl, pr = cells
    unique, cidx = te7._deduplicate_with_indices(cb)
    got = api.compute_verify_cell_kzg_proof_batch_challenge(unique, cidx, idx, cl, pr)
    assert got == je7.compute_verify_cell_kzg_proof_batch_challenge(unique, cidx, idx, cl, pr)
    assert 0 < got < R


def _raises_like_jax(fn_port, fn_jax, match):
    with pytest.raises(ValueError, match=match) as got:
        fn_port()
    with pytest.raises(ValueError) as want:
        fn_jax()
    assert str(got.value) == str(want.value)


def test_cell_verify_errors_match_jax(port, reference, cells):
    cb, idx, cl, pr = ([v[i] for i in FEW] for v in cells)
    non_canonical = cl[0][:32] + R.to_bytes(32, "big") + cl[0][64:]
    cases = [
        ((cb, idx[:2], cl, pr), "Cell count mismatch"),
        ((cb[:2], idx, cl, pr), "Commitment count mismatch"),
        ((cb, idx, cl, pr[:2]), "Proof count mismatch"),
        ((cb, [idx[0], 128, idx[2]], cl, pr), "Invalid cell index"),
        ((cb, idx, cl, [pr[0][:47]] + pr[1:]), "Invalid proof/commitment length"),
        ((cb, idx, [cl[0][:-1]] + cl[1:], pr), "Invalid cell length"),
        ((cb, idx, [non_canonical] + cl[1:], pr), "Invalid cell: scalar not canonical"),
    ]
    for args, match in cases:
        _raises_like_jax(
            lambda: api.verify_cell_kzg_proof_batch(*args, port),
            lambda: je7.verify_cell_kzg_proof_batch(*args, reference),
            match,
        )
    with pytest.raises(ValueError, match="g1: invalid point"):
        api.verify_cell_kzg_proof_batch(cb, idx, cl, [b"\x80" + bytes(47)] + pr[1:], port)
    assert api.verify_cell_kzg_proof_batch([], [], [], [], port) is True
    unique, cidx = te7._deduplicate_with_indices(cb)
    _raises_like_jax(
        lambda: api.compute_verify_cell_kzg_proof_batch_challenge(unique, cidx, idx, [non_canonical] + cl[1:], pr),
        lambda: je7.compute_verify_cell_kzg_proof_batch_challenge(unique, cidx, idx, [non_canonical] + cl[1:], pr),
        "Invalid cell: scalar not canonical",
    )


@pytest.fixture(scope="module")
def blob_proofs(reference, commitments):
    return [je4.compute_blob_kzg_proof(b, c, reference) for b, c in zip(BLOBS, commitments)]


def test_blob_batch_verify_matches_jax(port, reference, commitments, blob_proofs):
    """Four blobs (nine points, the bucket path): True; with one proof
    replaced by another blob's, False; as the JAX package."""
    assert api.verify_blob_kzg_proof_batch(BLOBS, commitments, blob_proofs, port) is True
    bad = [blob_proofs[0], blob_proofs[0]] + blob_proofs[2:]
    assert api.verify_blob_kzg_proof_batch(BLOBS, commitments, bad, port) is False
    assert je4.verify_blob_kzg_proof_batch(BLOBS, commitments, bad, reference) is False
    assert api.verify_blob_kzg_proof_batch([], [], [], port) is True


def test_blob_single_verify_matches_jax(port, reference, commitments, blob_proofs):
    assert api.verify_blob_kzg_proof(BLOBS[1], commitments[1], blob_proofs[1], port) is True
    assert api.verify_blob_kzg_proof(BLOBS[1], commitments[1], blob_proofs[2], port) is False
    assert je4.verify_blob_kzg_proof(BLOBS[1], commitments[1], blob_proofs[2], reference) is False
    z = (123456789).to_bytes(32, "big")
    proof, y = je4.compute_kzg_proof(BLOBS[2], z, reference)
    assert api.verify_kzg_proof(commitments[2], z, y, proof, port) is True
    y_bad = ((int.from_bytes(y, "big") + 1) % R).to_bytes(32, "big")
    assert api.verify_kzg_proof(commitments[2], z, y_bad, proof, port) is False
    assert je4.verify_kzg_proof(commitments[2], z, y_bad, proof, reference) is False


def test_blob_verify_errors_match_jax(port, reference, commitments, blob_proofs, monkeypatch):
    """The same ValueErrors as the JAX package: its batch verify, and its
    composed single-opening path (its fused native check words the same
    errors otherwise)."""
    bad_blob = bytearray(BLOBS[1])
    bad_blob[32 * 5 : 32 * 6] = R.to_bytes(32, "big")
    b2, c2, p2 = BLOBS[:2], commitments[:2], blob_proofs[:2]
    cases = [
        ((b2, c2[:1], p2), "Invalid amount of arguments"),
        ((b2, c2, [p2[0][:47], p2[1]]), "Invalid commitment/proof length"),
        (([b2[0], b2[1][:-1]], c2, p2), "Invalid blob: Invalid byte length"),
        (([b2[0], bytes(bad_blob)], c2, p2), "Invalid blob: scalar is not canonical"),
        ((b2, [c2[0], b"\x80" + bytes(47)], p2), "g1: invalid point at index 1"),
    ]
    for args, match in cases:
        _raises_like_jax(
            lambda: api.verify_blob_kzg_proof_batch(*args, port),
            lambda: je4.verify_blob_kzg_proof_batch(*args, reference),
            match,
        )
    monkeypatch.setattr(jn, "verify_kzg_proof_fused", lambda *a: None)
    z = (5).to_bytes(32, "big")
    for args, match in (
        ((c2[0], z, R.to_bytes(32, "big"), p2[0]), "Invalid scalar: not canonical"),
        ((c2[0], z[:31], z, p2[0]), "Invalid field element length"),
        ((c2[0][:47], z, z, p2[0]), "Invalid commitment/proof length"),
        ((c2[0], z, z, b"\x80" + bytes(47)), "g1: invalid point"),
    ):
        _raises_like_jax(
            lambda: api.verify_kzg_proof(*args, port), lambda: je4.verify_kzg_proof(*args, reference), match
        )


def test_interp_consts_carry_from_jax(port, reference):
    """The JAX package's cell-verify constants, with its monomial table
    built over the 64 points the slice reads (rows depend only on their own
    point), carried by convert.py, equal the port's limb for limb."""
    c = port.monomial64_table.c
    reference.__dict__["monomial_table"] = jm.build_fixed_base_table(
        jg.affine_from_ints(port.setup.g1_monomial[:64]), c=c
    )
    inv_shifts, table_slice = je7._interp_consts(reference)
    shifts, table = convert.interp_consts_from_jax(np.asarray(inv_shifts), tuple(np.asarray(a) for a in table_slice[:3]) + (table_slice[3],))
    assert torch.equal(shifts, port.inv_coset_shift_pows)
    assert table.c == c == 13
    for a, b in zip(table[:3], port.monomial64_table[:3]):
        assert torch.equal(a, b)
