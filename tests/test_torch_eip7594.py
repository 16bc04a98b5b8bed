"""kzg_tpu_torch's EIP-7594 cells at full protocol width on the CPU, byte
for byte against the JAX package's cells program (kzg_tpu.eip7594.
_cells_kernel on XLA:CPU), its errors, and the carry of a JAX FK20 column
table into the port's table layout. The FK20 proofs run at a small setup
in test_torch_fk20.py, and at full width on the card in chip_smoke.py."""

import os

import numpy as np
import pytest
import torch

from kzg_tpu import bytes as jb
from kzg_tpu import eip7594 as je
from kzg_tpu.ops import g1 as jg
from kzg_tpu.ops import msm as jm
from kzg_tpu.oracle.curve import G1, G1_GENERATOR
from kzg_tpu_torch import api, convert
from kzg_tpu_torch import eip7594 as te
from kzg_tpu_torch.constants import R_MOD as R
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.ops import msm as tm

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SETUP = os.path.join(os.path.dirname(__file__), "trusted_setup.txt")


def _blob(seed):
    a = np.random.default_rng(seed).integers(0, 256, (4096, 32), dtype=np.uint8)
    a[:, 0] &= 0x3F  # below r
    return a.tobytes()


BLOBS = [_blob(11), _blob(12)]


@pytest.fixture(scope="module")
def port():
    return api.load_trusted_setup_file(SETUP, device="cpu")


@pytest.fixture(scope="module")
def jax_cells():
    """The JAX package's cells program on both blobs, as wire bytes."""
    words = np.frombuffer(b"".join(BLOBS), dtype=np.uint32).reshape(len(BLOBS), 4096, 8)
    out = np.asarray(je._cells_kernel(words))
    assert out[0, :, 0].all()
    return [jb.frs_to_bytes(out[1:17, b, :]) for b in range(len(BLOBS))]


def test_compute_cells_matches_jax(port, jax_cells):
    cells = api.compute_cells(BLOBS[0], port)
    assert len(cells) == 128 and all(len(c) == 2048 for c in cells)
    assert b"".join(cells) == jax_cells[0]


def test_cells_batch_matches_jax(port, jax_cells):
    cells, proofs = api.compute_cells_and_kzg_proofs_batch(BLOBS, port, with_proofs=False)
    assert proofs == []
    assert [b"".join(c) for c in cells] == jax_cells


def test_cells_of_the_zero_blob_are_zero(port):
    assert api.compute_cells(bytes(131072), port) == [bytes(2048)] * 128


def test_non_canonical_scalar_raises(port):
    bad = bytearray(BLOBS[0])
    bad[32 * 9 : 32 * 10] = R.to_bytes(32, "big")
    with pytest.raises(ValueError, match="Invalid blob: scalar is not canonical"):
        api.compute_cells(bytes(bad), port)
    with pytest.raises(ValueError, match="Invalid blob: scalar is not canonical"):
        api.compute_cells_and_kzg_proofs_batch([BLOBS[1], bytes(bad)], port)


def test_wrong_lengths_raise(port):
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length. Expected 131072 got 131071"):
        api.compute_cells(BLOBS[0][:-1], port)
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length. Expected 131072 got 131073"):
        api.compute_cells_and_kzg_proofs(BLOBS[0] + b"\x00", port)
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length"):
        api.compute_cells_and_kzg_proofs_batch([BLOBS[0], b""], port)


def test_toeplitz_gather_matches_jax():
    for n, cell in ((4096, 64), (128, 2)):
        for got, want in zip(te._toeplitz_gather(n, cell), je._toeplitz_gather(n, cell)):
            np.testing.assert_array_equal(got, want)


def test_column_table_carry_from_jax():
    """A JAX column table (its _column_tables reshape of a flat table to
    (L, w, columns, cell)) carried by convert.table_from_jax equals the
    port's own table built with the columns as batch dims, limb for
    limb."""
    rng = np.random.default_rng(23)
    pts = [G1.mul_scalar(G1_GENERATOR, int(rng.integers(1, 1 << 62))) for _ in range(16)]
    pts[5] = None
    jt = jm.build_fixed_base_table(jg.affine_from_ints(pts), c=8)
    x, y, inf = (np.asarray(a) for a in (jt.x, jt.y, jt.inf))
    carried = convert.table_from_jax(
        x.reshape(x.shape[:2] + (8, 2)), y.reshape(y.shape[:2] + (8, 2)), inf.reshape(inf.shape[:1] + (8, 2)), jt.c
    )
    aff = tg.affine_from_ints(pts, "cpu")
    own = tm.build_fixed_base_table(tg.G1Aff(*(t.reshape(t.shape[:-1] + (8, 2)) for t in aff)), c=8)
    assert carried.x.shape == (24, 32, 8, 2) and carried.c == own.c
    for a, b in zip(carried[:3], own[:3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not match"):
        convert.table_from_jax(x, y, inf.reshape(inf.shape[:1] + (8, 2)), jt.c)
