"""kzg_tpu_torch's legacy FK20 settings (FK20MultiSettings,
FK20SingleSettings) on the CPU, against the oracle that the JAX package's
own test holds kzg_tpu.fk20 to (tests/test_device_fk20.py: its cases and
its secret): multi at n = 16 with chunk_len 2, 4 and 8, point for point,
and spot proofs through the oracle's pairing check (the single path at n2
= 32 is test_torch_fk20_legacy_single.py: together they take more than
this file's 30 s on one core). The JAX-free parts of kzg_tpu.fk20 are
compared directly: the striding tables and the argument errors (its
constructors raise before any compile; a jitted call would compile for
minutes on XLA:CPU).

The setup is the 32-point setup of that secret (max_width 32); its G1
points are made with the native core and its first 9 G2 points with the
oracle (what settings_from_secret computes with Python ints, with 65 G2
points and a Lagrange form that FK20 does not read)."""

import inspect

import numpy as np
import pytest
import torch

from kzg_tpu import fk20 as jfk20
from kzg_tpu.oracle.curve import G1, G1_GENERATOR, G2, G2_GENERATOR
from kzg_tpu.oracle.das import reverse_bits_limited
from kzg_tpu.oracle.fft import fft_fr, reverse_bit_order
from kzg_tpu.oracle.fk20 import FK20MultiSettingsOracle
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu.settings import DeviceKZGSettings
from kzg_tpu_torch import api, fk20, native, settings
from kzg_tpu_torch.constants import G1_GENERATOR_X, G1_GENERATOR_Y, R_MOD as R
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.trusted_setup import TrustedSetup

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SECRET = 1927409816240961209460912649124  # tests/test_device_fk20.py's secret
N_POINTS, SCALE = 32, 5


@pytest.fixture(scope="module")
def setup_points():
    g1m, sp = [], 1
    for _ in range(N_POINTS):
        g1m.append(native.g1_mul((G1_GENERATOR_X, G1_GENERATOR_Y), sp))
        sp = sp * SECRET % R
    assert g1m[:2] == [G1_GENERATOR, G1.mul_scalar(G1_GENERATOR, SECRET)]
    g2m = [G2.mul_scalar(G2_GENERATOR, pow(SECRET, i, R)) for i in range(9)]
    return g1m, g2m


@pytest.fixture(scope="module")
def oracle(setup_points):
    g1m, g2m = setup_points
    return KZGSettingsOracle(FFTSettingsOracle.new(SCALE), g1m, [], g2m, cell_size=max(1, N_POINTS // 64))


@pytest.fixture(scope="module")
def port(setup_points, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    g1m, g2m = setup_points
    yield settings.TorchKZGSettings(TrustedSetup(g1m, [], g2m), torch.device("cpu"), 1 << SCALE)
    mp.undo()


@pytest.mark.parametrize("chunk_len", [2, 4, 8])
def test_multi_matches_oracle_and_verifies(port, oracle, chunk_len):
    n = 16
    chunk_count = n // chunk_len
    rng = np.random.default_rng(77 + chunk_len)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    got = fk20.FK20MultiSettings(port, 2 * n, chunk_len).data_availability(coeffs)
    assert got == FK20MultiSettingsOracle(oracle, 2 * n, chunk_len).data_availability(coeffs)
    commitment = oracle.commit_to_poly_monomial(coeffs)
    extended_fft = reverse_bit_order(fft_fr(coeffs + [0] * n))
    domain_stride = oracle.fft.max_width // (2 * n)
    for pos in (1, 2 * chunk_count - 1):  # spot proofs (an oracle pairing check is about 0.15 s)
        x = oracle.fft.roots_of_unity[reverse_bits_limited(2 * chunk_count, pos) * domain_stride]
        ys = reverse_bit_order(extended_fft[chunk_len * pos : chunk_len * (pos + 1)])
        assert oracle.check_proof_multi(commitment, got[pos], x, ys, chunk_len), pos
    ys[1] = (ys[1] + 1) % R
    assert not oracle.check_proof_multi(commitment, got[pos], x, ys, chunk_len)


@pytest.mark.parametrize("n, offset, stride", [(16, 0, 1), (16, 1, 2), (16, 3, 4), (16, 7, 8), (16, 0, 16),
                                               (512, 0, 1), (4096, 5, 16), (4096, 63, 64)])
def test_toeplitz_gather_matches_the_jax_package(n, offset, stride):
    idx, keep = fk20._toeplitz_gather(n, offset, stride)
    jidx, jkeep = jfk20._toeplitz_gather(n, offset, stride)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(keep, jkeep)


@pytest.mark.parametrize("args", [(3,), (1 << 20,), (1,), (0,), (16, 16), (16, 0), (16, 3), (64, 2), (48, 2)],
                         ids=str)
def test_argument_errors_match_the_jax_package(port, oracle, args):
    """Each constructor's ValueError, message for message, in the JAX
    package's order of checks (which raise before any compile)."""
    cls = (fk20.FK20SingleSettings, jfk20.FK20SingleSettings) if len(args) == 1 else (
        fk20.FK20MultiSettings, jfk20.FK20MultiSettings)
    with pytest.raises(ValueError) as mine:
        cls[0](port, *args)
    with pytest.raises(ValueError) as theirs:
        cls[1](DeviceKZGSettings(oracle), *args)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("cls, args", [(fk20.FK20SingleSettings, (4,)), (fk20.FK20MultiSettings, (8, 2))])
def test_polynomial_length_error_matches_the_jax_package(port, cls, args):
    with pytest.raises(ValueError) as e:
        cls(port, *args).data_availability([1, 2, 3])
    assert f'raise ValueError("{e.value}")' in inspect.getsource(jfk20.FK20MultiSettings.data_availability_optimized)


class FourPointCells(settings.TorchKZGSettings):
    cell_size = 4


def test_cell_layout_files_are_the_cells_columns(setup_points, port, tmp_path, monkeypatch):
    """At the cells call's layout (n2 twice the setup's points, chunk_len
    the cell size) the FK20 files are the settings' x_ext_fft_columns
    tensor, and equal the oracle's columns and FK20 files; at another
    chunk_len they are built (and cached) anew."""
    monkeypatch.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path))
    g1m, g2m = setup_points
    s = FourPointCells(TrustedSetup(g1m[:16], [], g2m), torch.device("cpu"), 1 << SCALE)
    o = KZGSettingsOracle(FFTSettingsOracle.new(SCALE), g1m[:16], [], g2m, cell_size=4)
    fk = fk20.FK20MultiSettings(s, 32, 4)
    assert fk._cols is s.x_ext_fft_columns
    got = tg.affine_to_ints(fk._cols)  # [column][offset]
    assert got == [p for col in o.x_ext_fft_columns for p in col]
    files = FK20MultiSettingsOracle(o, 32, 4).x_ext_fft_files  # [offset][column]
    assert got == [files[j][i] for i in range(8) for j in range(4)]
    assert tg.affine_to_ints(s.fk20_columns(32, 4)) == got
    assert tg.affine_to_ints(s.fk20_columns(32, 8)) == tg.affine_to_ints(port.fk20_columns(32, 8))


def test_settings_roots_match_the_oracle(port, oracle):
    assert port.roots_of_unity == oracle.fft.roots_of_unity
    assert port.brp_roots_of_unity == oracle.fft.brp_roots_of_unity
    assert port.reverse_roots_of_unity == oracle.fft.reverse_roots_of_unity


def test_no_card_and_no_device_raises(setup_points, monkeypatch):
    """Without a card, neither the settings nor an FK20 settings object on
    the card comes into being: nothing carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_trusted_setup_file()
    g1m, g2m = setup_points
    on_card = settings.TorchKZGSettings(TrustedSetup(g1m, [], g2m), torch.device("cuda"), 1 << SCALE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fk20.FK20MultiSettings(on_card, 32, 2)
