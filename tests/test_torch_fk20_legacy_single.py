"""kzg_tpu_torch's FK20SingleSettings on the CPU at n2 = 32, against the
oracle that the JAX package's own test holds kzg_tpu.fk20 to
(tests/test_device_fk20.py: its case and its secret), point for point,
with spot proofs through the oracle's pairing check. The multi path and
the JAX-free comparisons are test_torch_fk20_legacy.py, which makes the
same 32-point setup (max_width 32): G1 points from the native core, the
first 9 G2 points from the oracle."""

import pytest
import torch

from kzg_tpu.oracle.curve import G1, G1_GENERATOR, G2, G2_GENERATOR
from kzg_tpu.oracle.das import reverse_bits_limited
from kzg_tpu.oracle.fk20 import FK20SingleSettingsOracle
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu.oracle import poly as P
from kzg_tpu_torch import fk20, native, settings
from kzg_tpu_torch.constants import G1_GENERATOR_X, G1_GENERATOR_Y, R_MOD as R
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.trusted_setup import TrustedSetup

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SECRET = 1927409816240961209460912649124  # tests/test_device_fk20.py's secret
N_POINTS, SCALE = 32, 5


@pytest.fixture(scope="module")
def settings_pair(tmp_path_factory):
    """(oracle, port) settings over the same 32 points, the port's on the CPU."""
    g1m, sp = [], 1
    for _ in range(N_POINTS):
        g1m.append(native.g1_mul((G1_GENERATOR_X, G1_GENERATOR_Y), sp))
        sp = sp * SECRET % R
    assert g1m[:2] == [G1_GENERATOR, G1.mul_scalar(G1_GENERATOR, SECRET)]
    g2m = [G2.mul_scalar(G2_GENERATOR, pow(SECRET, i, R)) for i in range(2)]
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    yield (KZGSettingsOracle(FFTSettingsOracle.new(SCALE), g1m, [], g2m, cell_size=1),
           settings.TorchKZGSettings(TrustedSetup(g1m, [], g2m), torch.device("cpu"), 1 << SCALE))
    mp.undo()


def test_single_matches_oracle_and_verifies(settings_pair):
    oracle, port = settings_pair
    coeffs = [1, 2, 3, 4, 7, 7, 7, 7, 13, 13, 13, 13, 13, 13, 13, 13]
    fk = fk20.FK20SingleSettings(port, 2 * len(coeffs))
    fk_o = FK20SingleSettingsOracle(oracle, 2 * len(coeffs))
    assert tg.affine_to_ints(fk._cols) == fk_o.x_ext_fft  # one file: toeplitz_part_1 of g1[n - 2 - i]
    got = fk.data_availability(coeffs)
    assert got == fk_o.data_availability(coeffs)
    commitment = oracle.commit_to_poly_monomial(coeffs)
    for i in (0, 13, 31):  # spot proofs (an oracle pairing check is about 0.15 s)
        x = oracle.fft.roots_of_unity[i]
        y = P.poly_eval(coeffs, x)
        assert oracle.check_proof_single(commitment, got[reverse_bits_limited(32, i)], x, y), i
    assert not oracle.check_proof_single(commitment, got[reverse_bits_limited(32, i)], x, y + 1)
