"""kzg_tpu_torch's FK20 pieces against the oracle at a small setup, on the
CPU: n = 128 monomial points s^i G (the JAX package's FK20 test secret)
with 16 field elements per cell, so 2n / 16 = 16 columns: the FK20 column
points and tables, and the proofs of every cell, equal to
kzg_tpu.oracle.das.compute_fk20_proofs in bit-reversed order. Points are
compared as affine ints, tables limb for limb.

The settings object fixes the cell size at 16 rather than deriving n / 64
= 2 (128 columns, as on the mainnet setup): the half convolution's plain
ladders scale with columns x (columns / 2 + 1), 144 lanes here against
8,320 there, and the mainnet width runs on the card in chip_smoke.py.

The setup's 128 G1 points are made with the native core (what
settings_from_secret computes with Python ints in seconds, with its G2
points and Lagrange form, which FK20 does not read)."""

import numpy as np
import pytest
import torch

from kzg_tpu.oracle.curve import G1, G1_GENERATOR
from kzg_tpu.oracle.das import compute_fk20_proofs
from kzg_tpu.oracle.fft import reverse_bit_order
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu_torch import eip7594 as te
from kzg_tpu_torch import native, settings
from kzg_tpu_torch.constants import G1_GENERATOR_X, G1_GENERATOR_Y, R_MOD as R
from kzg_tpu_torch.ops import field as tf
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.ops.field import FR
from kzg_tpu_torch.trusted_setup import TrustedSetup

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SECRET = 1927409816240961209460912649124  # the JAX package's FK20 test secret
N, CELL = 128, 16
COLUMNS = 2 * N // CELL


class SixteenColumnSettings(settings.TorchKZGSettings):
    cell_size = CELL


@pytest.fixture(scope="module")
def g1_monomial():
    pts, sp = [], 1
    for _ in range(N):
        pts.append(native.g1_mul((G1_GENERATOR_X, G1_GENERATOR_Y), sp))
        sp = sp * SECRET % R
    assert pts[:2] == [G1_GENERATOR, G1.mul_scalar(G1_GENERATOR, SECRET)]
    return pts


@pytest.fixture(scope="module")
def oracle(g1_monomial):
    return KZGSettingsOracle(FFTSettingsOracle.new(8), g1_monomial, [], [], cell_size=CELL)


@pytest.fixture(scope="module")
def port(g1_monomial, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    yield SixteenColumnSettings(TrustedSetup(g1_monomial, [], []), torch.device("cpu"))
    mp.undo()


def test_x_ext_fft_columns_match_oracle(port, oracle):
    assert port.cell_size == CELL
    cols = port.x_ext_fft_columns
    assert cols.x.shape == (24, COLUMNS, CELL)
    want = oracle.x_ext_fft_columns  # [column][offset]
    assert tg.affine_to_ints(cols) == [want[i][j] for i in range(COLUMNS) for j in range(CELL)]


def test_column_tables_are_the_columns_window_multiples(port):
    """c = 8 tables with the columns as batch dims: window j of column i,
    offset k holds 2^(8 j) times that column point."""
    t = port.column_tables
    assert t.c == 8 and t.x.shape == (24, 32, COLUMNS, CELL) and t.inf.shape == (32, COLUMNS, CELL)
    base = tg.affine_to_ints(port.x_ext_fft_columns)
    for j in (1, 31):
        got = tg.affine_to_ints(tg.G1Aff(t.x[:, j], t.y[:, j], t.inf[j]))
        assert got[:6] == [None if p is None else G1.mul_scalar(p, 1 << (8 * j)) for p in base[:6]]


def test_column_tables_reload_from_the_cache(port):
    """A second settings object over the same points reads both files."""
    again = SixteenColumnSettings(port.setup, torch.device("cpu"))
    for a, b in zip(again.column_tables[:3], port.column_tables[:3]):
        assert torch.equal(a, b)
    for a, b in zip(again.x_ext_fft_columns, port.x_ext_fft_columns):
        assert torch.equal(a, b)


def test_fk20_proofs_match_oracle(port, oracle):
    rng = np.random.default_rng(17)
    poly = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)]
    poly[:3] = [0, 1, R - 1]
    poly_m = tf.from_canonical(FR, torch.from_numpy(tf.ints_to_limbs(poly, 16)).reshape(16, 1, N))
    got = tg.xyzz_to_ints(te._fk20_body(poly_m, port.column_tables))
    assert got == reverse_bit_order(compute_fk20_proofs(poly + [0] * N, N, oracle))

