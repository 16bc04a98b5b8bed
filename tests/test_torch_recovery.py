"""kzg_tpu_torch's erasure recovery of EIP-7594 cells on the CPU: at full
protocol width, the recovered cells of one blob for three patterns of
given cells (a random 64, cells 0-63, a random 100) byte-equal to the
blob's cells (the port's compute_cells, which test_torch_eip7594.py holds
equal to the JAX package's cells program) and to the oracle's
recover_cells; the recovered coefficients equal to the blob's monomial
form (the oracle's), top half zero; the public function's cells, and the
coefficients it hands to the FK20 proofs, also with all 128 cells given;
the recovery core limb for limb against the JAX package's _recover_core
on XLA:CPU at a 16-point domain; every ValueError of the public functions
with the JAX package's message. The FK20 proofs of recovered cells take
about 100 s at full width on the CPU, so chip_smoke.py holds them on the
card, byte-equal to the cells call's proofs."""

import jax
import numpy as np
import pytest
import torch

from kzg_tpu import eip7594 as je
from kzg_tpu.oracle import das as odas
from kzg_tpu.oracle.fft import fft_fr
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu_torch import api
from kzg_tpu_torch import bytes as bs
from kzg_tpu_torch import eip7594 as te
from kzg_tpu_torch.constants import R_MOD as R, root_of_unity
from kzg_tpu_torch.ops.field import FR

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

rng = np.random.default_rng(7594)
PATTERNS = {
    "random 64": sorted(rng.choice(128, 64, replace=False).tolist()),
    "cells 0-63": list(range(64)),
    "100 given": sorted(rng.choice(128, 100, replace=False).tolist()),
}


def _blob(seed):
    a = np.random.default_rng(seed).integers(0, 256, (4096, 32), dtype=np.uint8)
    a[:, 0] &= 0x3F  # below r
    return a.tobytes()


BLOB = _blob(31)


@pytest.fixture(scope="module")
def port():
    return api.load_trusted_setup_file(device="cpu")


@pytest.fixture(scope="module")
def cells(port):
    return api.compute_cells(BLOB, port)


@pytest.fixture(scope="module")
def recovered(port, cells):
    """The recovery body on the three patterns as one batch of three:
    canonical cells (16, 3, 8192) in wire order, coefficients (16, 3,
    8192) in Montgomery form."""
    idxs = list(PATTERNS.values())
    limbs = [te._check_recover_inputs(idx, [cells[i] for i in idx]) for idx in idxs]
    return te._recover_body(*te._recover_inputs(idxs, limbs, port.device), port)


def _ints(b: bytes):
    return [int.from_bytes(b[i : i + 32], "big") for i in range(0, len(b), 32)]


@pytest.mark.parametrize("b, pattern", list(enumerate(PATTERNS)))
def test_recovered_cells_equal_the_blobs_cells_and_the_oracle(recovered, cells, b, pattern):
    got = bs.frs_to_bytes(recovered[0][:, b, :].numpy())
    assert got == b"".join(cells)
    idx = PATTERNS[pattern]
    holes = [None] * 8192
    for i in idx:
        holes[64 * i : 64 * (i + 1)] = _ints(cells[i])
    oracle = KZGSettingsOracle(FFTSettingsOracle.new(13), [], [], [])
    assert _ints(got) == odas.recover_cells(holes, set(idx), oracle)


def test_recovered_coefficients_are_the_monomial_form(recovered):
    monomial = odas.poly_lagrange_to_monomial(_ints(BLOB))
    coeffs = recovered[1]
    for b in range(len(PATTERNS)):
        assert FR.decode(coeffs[:, b, :]) == monomial + [0] * 4096


@pytest.mark.parametrize("pattern", ["random 64", "all 128"])
def test_public_recovery_gives_the_cells_and_the_coefficients(port, cells, monkeypatch, pattern):
    """recover_cells_and_kzg_proofs returns the blob's cells, and hands the
    FK20 proofs the blob's monomial coefficients (8192 of them, top half
    zero): the proofs of those are held on the card by chip_smoke.py."""
    seen = []
    monkeypatch.setattr(te, "_proof_bytes", lambda poly_m, s: seen.append(poly_m) or [["proof"] * 128])
    idx = PATTERNS["random 64"] if pattern == "random 64" else list(range(128))
    out_cells, out_proofs = api.recover_cells_and_kzg_proofs(idx, [cells[i] for i in idx], port)
    assert out_cells == cells and out_proofs == ["proof"] * 128
    (poly_m,) = seen
    assert tuple(poly_m.shape) == (16, 1, 8192)
    assert FR.decode(poly_m) == odas.poly_lagrange_to_monomial(_ints(BLOB)) + [0] * 4096


def test_recover_core_matches_the_jax_package():
    """The recovery core at a 16-point domain (a polynomial of degree < 8,
    slots 1, 2, 5, 8, 11, 14 missing and holding garbage), limb for limb
    against one jitted call of the JAX package's _recover_core; the values
    are the polynomial's."""
    n = 16
    g = np.random.default_rng(5)
    coeffs = [int.from_bytes(g.bytes(32), "big") % R for _ in range(n // 2)] + [0] * (n // 2)
    full = fft_fr(coeffs)
    missing = [1, 2, 5, 8, 11, 14]
    values = [int.from_bytes(g.bytes(32), "big") % R if i in missing else v for i, v in enumerate(full)]
    w = root_of_unity(4)
    vanish = odas.compute_vanishing_polynomial_from_roots([pow(w, i, R) for i in missing])
    vanish += [0] * (n - len(vanish))
    k, k_inv = 7, pow(7, R - 2, R)
    args = (
        FR.encode_host(values)[:, None, :],
        np.array([[i in missing for i in range(n)]]),
        FR.encode_host(vanish)[:, None, :],
        FR.encode_host([pow(k, i, R) for i in range(n)]),
        FR.encode_host([pow(k_inv, i, R) for i in range(n)]),
    )
    got = te._recover_core(*(torch.from_numpy(a) for a in args))
    want = jax.jit(je._recover_core)(*(a.astype(np.uint32) if a.dtype == np.int32 else a for a in args))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int32))
    assert FR.decode(got[0]) == full
    assert FR.decode(got[1]) == coeffs


def _error_cases(cells):
    bad_len = list(cells[:64])
    bad_len[5] = bad_len[5][:-1]
    bad_scalar = list(cells[:64])
    bad_scalar[9] = R.to_bytes(32, "big") + bad_scalar[9][32:]
    asc = list(range(64))
    return {
        "length mismatch": (list(range(64)), cells[:63]),
        "more than 128 cells": (list(range(129)), cells + cells[:1]),
        "fewer than 64": (list(range(63)), cells[:63]),
        "index of 128": (asc[:63] + [128], cells[:64]),
        "not ascending": ([1, 0] + asc[2:], cells[:64]),
        "a duplicate": (asc[:32] + [31] + asc[33:], cells[:64]),
        "bad cell length": (asc, bad_len),
        "non-canonical scalar": (asc, bad_scalar),
    }


@pytest.mark.parametrize(
    "case",
    ["length mismatch", "more than 128 cells", "fewer than 64", "index of 128", "not ascending", "a duplicate",
     "bad cell length", "non-canonical scalar"],
)
def test_errors_match_the_jax_package(port, cells, case):
    """The checks raise before any device work, so the JAX package's
    function needs no settings."""
    idx, given = _error_cases(cells)[case]
    with pytest.raises(ValueError) as want:
        je.recover_cells_and_kzg_proofs(idx, given, None)
    with pytest.raises(ValueError) as got:
        api.recover_cells_and_kzg_proofs(idx, given, port)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got_batch:
        api.recover_cells_and_kzg_proofs_batch([idx], [given], port)
    assert str(got_batch.value) == str(want.value)


def test_batch_length_mismatch_matches_the_jax_package(port, cells):
    with pytest.raises(ValueError) as want:
        je.recover_cells_and_kzg_proofs_batch([list(range(64))], [], None)
    with pytest.raises(ValueError) as got:
        api.recover_cells_and_kzg_proofs_batch([list(range(64))], [], port)
    assert str(got.value) == str(want.value) == "Cell indices & cells mismatch"
