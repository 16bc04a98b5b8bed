"""kzg_tpu_torch's EIP-4844 commit and prove at full protocol width on the
CPU: the mainnet setup and 4096-element blobs, byte for byte against the
JAX package's kzg_tpu.eip4844 (its native host path, which needs no XLA
compile) and against known answers from the setup file's own bytes.

The 20 x 4096 fixed-base table comes through the package's disk cache:
this test writes it there, computed point by point with the native core's
scalar multiplication, so that the plain PyTorch path's time here goes to
commit and prove. The package's own table build is held against the JAX
package's in test_torch_msm.py and runs at full width on the card in
chip_smoke.py."""

import os

import numpy as np
import torch
import pytest

from kzg_tpu import eip4844 as je
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu.settings import DeviceKZGSettings
from kzg_tpu_torch import api, native, settings, trusted_setup
from kzg_tpu_torch import eip4844 as te
from kzg_tpu_torch.constants import R_MOD as FR_MOD
from kzg_tpu_torch.ops.field import FP, FR

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SETUP = os.path.join(os.path.dirname(__file__), "trusted_setup.txt")
C, W = 13, 20


def _native_table(points, cache_dir):
    """Write the fixed-base table 2^(13 j) P_i of the points into the
    package's cache format, computed with the native core."""
    rows = []
    for j in range(W):
        if j:
            points = [native.g1_mul(p, 1 << C) if p is not None else None for p in points]
        rows.append(points)
    flat = [p for row in rows for p in row]
    xs = FP.encode_host([0 if p is None else p[0] for p in flat]).reshape(24, W, -1)
    ys = FP.encode_host([0 if p is None else p[1] for p in flat]).reshape(24, W, -1)
    inf = np.array([p is None for p in flat]).reshape(W, -1)
    path = settings.table_cache_path(rows[0], "lagrange_brp", C)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, x=xs, y=ys, inf=inf)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cache = tmp_path_factory.mktemp("kzg_tpu_torch_cache")
    saved = os.environ.get("KZG_TPU_TORCH_CACHE_DIR")
    os.environ["KZG_TPU_TORCH_CACHE_DIR"] = str(cache)
    try:
        s = api.load_trusted_setup_file(SETUP, device="cpu")
        _native_table(s.setup.g1_lagrange_brp, cache)
        assert s.lagrange_table.x.shape == (24, W, 4096)
        yield s
    finally:
        if saved is None:
            os.environ.pop("KZG_TPU_TORCH_CACHE_DIR", None)
        else:
            os.environ["KZG_TPU_TORCH_CACHE_DIR"] = saved


@pytest.fixture(scope="module")
def reference(port):
    """The JAX package's settings over the same decoded points (its own
    file loader decodes the setup in pure Python, which takes minutes)."""
    st = port.setup
    oracle = KZGSettingsOracle(FFTSettingsOracle.new(13), st.g1_monomial, st.g1_lagrange_brp, st.g2_monomial)
    return DeviceKZGSettings(oracle)


def _blob(seed):
    a = np.random.default_rng(seed).integers(0, 256, (4096, 32), dtype=np.uint8)
    a[:, 0] &= 0x3F  # below r
    return a.tobytes()


BLOBS = [_blob(1), _blob(2)]
UNIT_J = 3


def _unit_blob(j):
    a = bytearray(4096 * 32)
    a[32 * j + 31] = 1
    return bytes(a)


@pytest.fixture(scope="module")
def commitments(port):
    """Blob 0 through the single entry point, the rest in one batch with a
    unit blob and the zero blob."""
    single = api.blob_to_kzg_commitment(BLOBS[0], port)
    batch = api.blob_to_kzg_commitment_batch([BLOBS[1], _unit_blob(UNIT_J), bytes(4096 * 32)], port)
    return [single] + batch


def test_commitments_match_jax(commitments, reference):
    assert commitments[:2] == [je.blob_to_kzg_commitment(b, reference) for b in BLOBS]


def test_known_answers(commitments):
    """A blob that is 1 at position j commits to the setup file's Lagrange
    point at index brp(j), byte for byte; the zero blob to infinity."""
    with open(SETUP) as f:
        lagrange_hex = f.read().split()[2 : 2 + 4096]
    brp = trusted_setup.reverse_bit_order(list(range(4096)))
    assert commitments[2] == bytes.fromhex(lagrange_hex[brp[UNIT_J]])
    assert commitments[3] == b"\xc0" + bytes(47)


def test_proofs_match_jax_and_verify(port, commitments, reference):
    single = api.compute_blob_kzg_proof(BLOBS[0], commitments[0], port)
    batch = api.compute_blob_kzg_proof_batch(BLOBS[1:], commitments[1:2], port)
    proofs = [single] + batch
    assert proofs == [je.compute_blob_kzg_proof(b, c, reference) for b, c in zip(BLOBS, commitments)]
    z = te.compute_challenge(BLOBS[0], commitments[0])
    assert z == je.compute_challenge(BLOBS[0], commitments[0])
    _, y_bytes = je.compute_kzg_proof(BLOBS[0], z.to_bytes(32, "big"), reference)
    y = int.from_bytes(y_bytes, "big")
    c_pt, p_pt = native.g1_decompress_batch(commitments[0] + proofs[0])
    assert te._check_proof_single(port, c_pt, p_pt, z, y)
    assert not te._check_proof_single(port, c_pt, p_pt, z, y + 1)


def test_compute_kzg_proof_matches_jax(port, commitments, reference):
    """compute_kzg_proof at a random z and at a root of unity (z in the
    domain: y is the blob's own value there): the proof and y byte for
    byte as the JAX package's, and the opening verifies."""
    in_domain = trusted_setup.brp_roots_of_unity()[5]
    for z in (987654321987654321 % FR_MOD, in_domain):
        z_bytes = z.to_bytes(32, "big")
        got = api.compute_kzg_proof(BLOBS[1], z_bytes, port)
        assert got == je.compute_kzg_proof(BLOBS[1], z_bytes, reference)
        assert api.verify_kzg_proof(commitments[1], z_bytes, got[1], got[0], port)
    assert got[1] == BLOBS[1][32 * 5 : 32 * 6]
    with pytest.raises(ValueError, match="Invalid scalar: not canonical"):
        api.compute_kzg_proof(BLOBS[1], FR_MOD.to_bytes(32, "big"), port)
    with pytest.raises(ValueError, match="Invalid field element length"):
        api.compute_kzg_proof(BLOBS[1], bytes(31), port)


def test_setup_lagrange_order_and_roots(port):
    roots = trusted_setup.brp_roots_of_unity()
    assert FP.n_limbs == 24 and len(roots) == 4096
    assert port.roots_brp_mont.shape == (16, 4096)
    assert FR.decode(port.roots_brp_mont[:, :4]) == roots[:4]
    assert roots[0] == 1 and roots[1] == FR.modulus - 1  # w^0, w^(n/2)


def test_non_canonical_scalar_raises(port, commitments):
    bad = bytearray(BLOBS[0])
    bad[32 * 7 : 32 * 8] = (FR_MOD).to_bytes(32, "big")
    with pytest.raises(ValueError, match="Invalid blob: scalar is not canonical"):
        api.blob_to_kzg_commitment(bytes(bad), port)
    with pytest.raises(ValueError, match="Invalid blob: scalar is not canonical"):
        api.compute_blob_kzg_proof(bytes(bad), commitments[0], port)


def test_wrong_lengths_raise(port, commitments):
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length. Expected 131072 got 131071"):
        api.blob_to_kzg_commitment(BLOBS[0][:-1], port)
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length"):
        api.blob_to_kzg_commitment_batch([BLOBS[0], BLOBS[1] + b"\x00"], port)
    with pytest.raises(ValueError, match="Invalid commitment length"):
        api.compute_blob_kzg_proof(BLOBS[0], commitments[0][:47], port)
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length"):
        api.compute_blob_kzg_proof(BLOBS[0][:-1], commitments[0], port)
    with pytest.raises(ValueError, match="g1: invalid point"):
        api.compute_blob_kzg_proof(BLOBS[0], b"\x80" + bytes(47), port)

