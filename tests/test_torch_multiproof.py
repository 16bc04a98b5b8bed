"""kzg_tpu_torch's multi-point openings on the CPU, on a small setup: the
first 128 monomial G1 points of the repo's mainnet setup and its 65 G2
points, the same points in an oracle KZGSettingsOracle. Proofs byte-equal
to the oracle's compute_proof_multi for n = 4 and 16; verification True
with the coset's values and False with one changed, agreeing with the
oracle's check_proof_multi; each ValueError with the JAX package's
message."""

import random
from types import SimpleNamespace

import pytest
import torch

from kzg_tpu import multiproof as jmp
from kzg_tpu.oracle.fft import fft_fr
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu_torch import api, native
from kzg_tpu_torch.constants import R_MOD as R
from kzg_tpu_torch.settings import TorchKZGSettings
from kzg_tpu_torch.trusted_setup import TrustedSetup

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

N_POINTS = 128


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    full = api.load_trusted_setup_file(device="cpu").setup
    g1m = full.g1_monomial[:N_POINTS]
    port = TorchKZGSettings(TrustedSetup(g1m, [], full.g2_monomial), torch.device("cpu"))
    oracle = KZGSettingsOracle(FFTSettingsOracle.new(7), g1m, [], full.g2_monomial)
    yield port, oracle
    mp.undo()


def _commit(g1m, coeffs):
    acc = None
    for p, c in zip(g1m, coeffs):
        acc = native.g1_add(acc, native.g1_mul(p, c))
    return native.g1_compress_batch([acc])[0]


def _coset_values(coeffs, x, n):
    """p on x <w_n>: the FFT of n of the coefficients scaled by x^i and
    folded mod n."""
    folded = [0] * n
    xs = 1
    for i, c in enumerate(coeffs):
        folded[i % n] = (folded[i % n] + c * xs) % R
        xs = xs * x % R
    return fft_fr(folded)


@pytest.mark.parametrize("n, p_len", [(4, 128), (16, 100)])
def test_proof_multi_matches_the_oracle(setups, n, p_len):
    """p of p_len coefficients: the quotient fills the table (n = 4) or
    leaves its last 28 columns to zero scalars (n = 16)."""
    port, oracle = setups
    rng = random.Random(n)
    coeffs = [rng.randrange(R) for _ in range(p_len)]
    coeffs[:3] = [0, 1, R - 1]
    x = rng.randrange(1, R)
    proof = api.compute_kzg_proof_multi(coeffs, x, n, port)
    assert proof == native.g1_compress_batch([oracle.compute_proof_multi(coeffs, x, n)])[0]

    commitment = _commit(oracle.g1_monomial, coeffs)
    ys = _coset_values(coeffs, x, n)
    bad = list(ys)
    bad[n - 1] = (bad[n - 1] + 1) % R
    c_pt, p_pt = native.g1_decompress_batch(commitment + proof)
    for values, want in ((ys, True), (bad, False)):
        assert api.verify_kzg_proof_multi(commitment, proof, x, values, port) is want
        assert oracle.check_proof_multi(c_pt, p_pt, x, values, n) is want


# stand-ins for the JAX package's settings: its checks read only these
_JAX_SETTINGS = SimpleNamespace(monomial_table=SimpleNamespace(n=N_POINTS), oracle=SimpleNamespace(g2_monomial=[None] * 65))


@pytest.mark.parametrize("case", ["n = 0", "n = 3", "too short", "quotient exceeds setup"])
def test_prove_errors_match_the_jax_package(setups, case):
    coeffs, n = {
        "n = 0": ([1] * 10, 0),
        "n = 3": ([1] * 10, 3),
        "too short": ([1] * 16, 16),
        "quotient exceeds setup": ([1] * (N_POINTS + 5), 4),
    }[case]
    with pytest.raises(ValueError) as want:
        jmp.compute_kzg_proof_multi(coeffs, 5, n, _JAX_SETTINGS)
    with pytest.raises(ValueError) as got:
        api.compute_kzg_proof_multi(coeffs, 5, n, setups[0])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_ys", [0, 6, 128])
def test_verify_errors_match_the_jax_package(setups, n_ys):
    """A count of values that is not a power of two, and one past the G2
    setup points (65: n = 64 is the largest)."""
    point = native.g1_compress_batch([setups[0].setup.g1_monomial[1]])[0]
    with pytest.raises(ValueError) as want:
        jmp.verify_kzg_proof_multi(point, point, 5, [1] * n_ys, _JAX_SETTINGS)
    with pytest.raises(ValueError) as got:
        api.verify_kzg_proof_multi(point, point, 5, [1] * n_ys, setups[0])
    assert str(got.value) == str(want.value)
