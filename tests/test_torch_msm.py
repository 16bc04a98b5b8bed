"""kzg_tpu_torch.ops.msm (fixed-base path) against the oracle MSM and the
JAX package's ops/msm.py, on the CPU. Tolerance: exact. Bucket sums in
XYZZ are not unique (they depend on the order of additions), so MSM
results are compared as affine points; limbs are compared where the same
formulas run on the same values (the table, phase 1 of the scan).

The JAX package's whole jnp msm_fixed compiles in about a minute on
XLA:CPU, so it is compared at one configuration (the last test, with the
JAX table carried across by kzg_tpu_torch/convert.py); every configuration
is held against the oracle."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from kzg_tpu.constants import R_MOD as R
from kzg_tpu.ops import g1 as jg
from kzg_tpu.ops import msm as jm
from kzg_tpu.oracle.curve import G1, G1_GENERATOR
from kzg_tpu.oracle.msm import msm as oracle_msm
from kzg_tpu_torch import convert
from kzg_tpu_torch.ops import cuda_msm
from kzg_tpu_torch.ops import field as tf
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.ops import launch
from kzg_tpu_torch.ops import msm as tm

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

N_MAX = 64


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(21)
    pts = [G1.mul_scalar(G1_GENERATOR, int(rng.integers(1, 1 << 62)) * 104729 % R) for _ in range(N_MAX)]
    for i in (3, 17, 40):
        pts[i] = None  # identity rows
    return pts


@pytest.fixture(scope="module")
def tables(points):
    """Port-built tables per window; the first 16 columns are the table of
    the first 16 points (each column depends on its own point only)."""
    aff = tg.affine_from_ints(points, "cpu")
    return {c: tm.build_fixed_base_table(aff, c=c) for c in (8, 9)}


def _cut(table, n):
    return tm.FixedBaseTable(table.x[..., :n], table.y[..., :n], table.inf[..., :n], table.c)


def _scalars(seed, n, nb):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(nb):
        s = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        s[0] = 0
        s[1] = R - 1
        s[2:6] = [0, 1, 2, 0]
        rows.append(s)
    limbs = np.stack([tf.ints_to_limbs(s, 16) for s in rows], axis=1)  # (16, nb, n)
    return rows, limbs


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("c", [8, 9])
@pytest.mark.parametrize("n", [16, 64])
def test_msm_fixed_matches_oracle(points, tables, n, c, nb):
    rows, limbs = _scalars(100 * n + 10 * c + nb, n, nb)
    sc = torch.from_numpy(limbs if nb > 1 else limbs[:, 0])
    got = tg.xyzz_to_ints(tm.msm_fixed(_cut(tables[c], n), sc))
    assert got == [oracle_msm(points[:n], s) for s in rows]



def test_msm_with_table_batch_dims(points, tables):
    """A table with its own batch dims (24, w, 4, 8), c = 8: four point sets
    of 8 (the FK20 column tables' layout), scalars (16, 2, 4, 8). Each
    (batch, set) sum equals the oracle MSM over that set's points and the
    flat path over that set's own table."""
    sets, n = 4, 8
    aff = tg.affine_from_ints(points[: sets * n], "cpu")
    table = tm.build_fixed_base_table(tg.G1Aff(*(t.reshape(t.shape[:-1] + (sets, n)) for t in aff)), c=8)
    assert table.x.shape == (24, 32, sets, n) and table.inf.shape == (32, sets, n)
    rows, limbs = _scalars(77, sets * n, 2)
    sc = torch.from_numpy(limbs.reshape(16, 2, sets, n))
    got = tg.xyzz_to_ints(tm.msm_fixed(table, sc))  # (2, sets) flattened
    for j in range(sets):
        flat = tm.FixedBaseTable(table.x[:, :, j], table.y[:, :, j], table.inf[:, j], table.c)
        per_set = tg.xyzz_to_ints(tm.msm_fixed(flat, sc[:, :, j].contiguous()))
        for b in range(2):
            want = oracle_msm(points[j * n : (j + 1) * n], rows[b][j * n : (j + 1) * n])
            assert got[b * sets + j] == per_set[b] == want
    with pytest.raises(ValueError, match="table's batch dims"):
        tm.msm_fixed(table, sc[:, :, :2].contiguous())

@pytest.mark.parametrize("lanes", [2048, 32768])
def test_chunk_lane_count_does_not_change_the_sum(points, tables, monkeypatch, lanes):
    """The JAX package's 2048 chunk lanes and the count chosen for the card
    give the same MSM (run here through the plain versions)."""
    monkeypatch.setattr(tm, "CPU_CHUNK_LANES", lanes)
    rows, limbs = _scalars(7, N_MAX, 3)
    got = tg.xyzz_to_ints(tm.msm_fixed(tables[8], torch.from_numpy(limbs)))
    assert got == [oracle_msm(points, s) for s in rows]


def test_signed_digits_match_jax():
    rows, limbs = _scalars(9, 8, 1)
    for c in (8, 9, 13):
        got = tm.signed_digits(torch.from_numpy(limbs[:, 0]), c).numpy()
        want = np.asarray(jm.signed_digits(jnp.asarray(limbs[:, 0].astype(np.uint32)), c))
        np.testing.assert_array_equal(got, want.astype(np.int64))
        for i, s in enumerate(rows[0]):
            assert sum(int(got[j, i]) << (c * j) for j in range(got.shape[0])) == s


def test_pack_point_rows_matches_jax(points):
    aff = jg.affine_from_ints(points[:16])
    want, r0 = jm._pack_point_rows(aff.x, aff.y, aff.inf)
    got, r1 = tm._pack_point_rows(*convert_aff(aff))
    assert r0 == r1
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def convert_aff(aff):
    return (
        convert.limbs_from_jax(aff.x),
        convert.limbs_from_jax(aff.y),
        torch.from_numpy(np.array(aff.inf)),
    )


def _phase1_inputs(points, K, m, seed):
    """Packed rows of 16 points (+ their negated copies) and a (K, m) scan
    with runs of equal rows (P == Q), P == -Q, identity rows and segment
    starts."""
    aff = jg.affine_from_ints(points[:16])
    rows_j, r0 = jm._pack_point_rows(aff.x, aff.y, aff.inf)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * r0, (K, m))
    idx[1] = idx[0]
    idx[3] = (idx[2] + r0) % (2 * r0)
    idx[4, ::4] = 3  # an identity row
    first = rng.random((K, m)) < 0.3
    first[1:4] = False
    return np.asarray(rows_j), idx.astype(np.int32), first


def test_phase1_plain_matches_jax_step_loop(points):
    """B1's plain version against a step-by-step JAX madd_unified /
    select_point loop over the same packed rows: the jnp body the Pallas
    kernel is bit-exact with."""
    K, m = 6, 64
    rows_j, idx, first = _phase1_inputs(points, K, m, 31)
    got = cuda_msm.seg_scan_phase1_mem(
        torch.from_numpy(rows_j.view(np.int32).copy()), torch.from_numpy(idx), torch.from_numpy(first)
    )
    g = rows_j[idx]  # (K, m, 25)

    def unpack(w):  # (K, m, 12) packed words -> (24, K, m) limbs
        return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(K, m, 24).transpose(2, 0, 1)

    x, y, inf = unpack(g[..., :12]), unpack(g[..., 12:24]), g[..., 24] != 0

    @jax.jit
    def step(acc, cx, cy, cinf, reset):
        cur = jg.G1Aff(cx, cy, cinf)
        return jg.select_point(reset, jg.from_affine(cur), jg.madd_unified(acc, cur))

    acc = jg.infinity((m,))
    for t in range(K):
        reset = np.logical_or(first[t], t == 0)
        acc = step(acc, jnp.asarray(x[:, t]), jnp.asarray(y[:, t]), jnp.asarray(inf[t]), jnp.asarray(reset))
        for k in range(4):
            np.testing.assert_array_equal(got[k][:, t].numpy().astype(np.int64), np.asarray(acc[k]).astype(np.int64))


def test_phase1_wrapper_checks_its_inputs(points):
    rows_j, idx, first = _phase1_inputs(points, 6, 8, 3)
    rows = torch.from_numpy(rows_j.view(np.int32).copy())
    with pytest.raises(ValueError):
        cuda_msm.seg_scan_phase1_mem(rows, torch.from_numpy(idx).long(), torch.from_numpy(first))
    with pytest.raises(ValueError):
        cuda_msm.seg_scan_phase1_mem(rows, torch.from_numpy(idx), torch.from_numpy(first).int())
    with pytest.raises(ValueError):
        cuda_msm.seg_scan_phase1_mem(rows[:, :24], torch.from_numpy(idx), torch.from_numpy(first))
    with pytest.raises(ValueError):
        cuda_msm.seg_scan_phase1_mem(rows, torch.from_numpy(idx).T, torch.from_numpy(first).T)


@pytest.mark.parametrize("B", [20, 129])
def test_integrate_buckets_matches_oracle(points, B):
    """sum_b b * S_b, through the direct path (B <= 32) and the square
    split, for two rows at once (the second the first reversed)."""
    rows = [(points * 3)[:B], (points * 3)[:B][::-1]]
    buckets = tg.from_affine(tg.affine_from_ints(rows[0] + rows[1], "cpu"))
    buckets = tg.map_coords(lambda c: c.reshape(c.shape[0], 2, B), buckets)  # (24, 2, B)
    got = tg.xyzz_to_ints(tg.map_coords(lambda c: c[..., 0], tm.integrate_buckets(buckets)))
    want = []
    for pts in rows:
        acc = None
        for b, p in enumerate(pts):
            acc = G1.affine_add(acc, G1.mul_scalar(p, b) if p is not None else None)
        want.append(acc)
    assert got == want


def test_integrate_wrapper_checks_its_inputs(points):
    """B9's wrapper takes contiguous (24, rows, B) int32 coordinates, B at
    least 1, and raises on anything else; on the CPU it runs its plain
    version and launches nothing, for no rows too."""
    b = tg.from_affine(tg.affine_from_ints(points[:12], "cpu"))
    b = tg.map_coords(lambda c: c.reshape(c.shape[0], 3, 4).contiguous(), b)
    launch.reset_launches()
    got = cuda_msm.integrate_buckets(b)
    for a, r in zip(got, cuda_msm.integrate_buckets_ref(b)):
        assert torch.equal(a, r[..., 0])
    with pytest.raises(ValueError, match="dtype"):
        cuda_msm.integrate_buckets(tg.map_coords(lambda c: c.long(), b))
    with pytest.raises(ValueError, match="shape"):
        cuda_msm.integrate_buckets(tg.map_coords(lambda c: c.reshape(c.shape[0], 12), b))
    with pytest.raises(ValueError, match="shape"):
        cuda_msm.integrate_buckets(tg.G1XYZZ(b.x, b.y[:, :2].contiguous(), b.zz, b.zzz))
    with pytest.raises(ValueError, match="shape"):
        cuda_msm.integrate_buckets(tg.map_coords(lambda c: c[..., :0].contiguous(), b))
    assert tuple(cuda_msm.integrate_buckets(tg.map_coords(lambda c: c[:, :0].contiguous(), b)).x.shape) == (24, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_msm.integrate_buckets(tg.map_coords(lambda c: c.transpose(1, 2).contiguous().transpose(1, 2), b))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_msm.integrate_buckets(tg.map_coords(lambda c: c.to("meta"), b))
    assert launch.launches()["integrate"] == 0


def test_integrate_plan_covers_every_bucket():
    """B9's grid: a row's units cols in a block (a power of two up to the
    block's 16) times nbk blocks (whole blocks where nbk > 1), J buckets
    each, cover all B buckets; at the main paths' shapes on 132 SMs, one
    block a row where that keeps the chain short, several rows a block
    at the FK20 column MSM's 2304 rows, a row over several blocks at the
    fixed-base MSMs' one to six rows."""
    shapes = [(74, 65), (37, 65), (1, 257), (64, 129), (6, 4097), (2304, 129), (4, 9), (1, 1), (3, 2), (5000, 33)]
    plans = {shape: cuda_msm.integrate_plan(*shape, 132) for shape in shapes}
    for (rows, B), (cols, nbk, J) in plans.items():
        assert cols in (1, 2, 4, 8, 16) and 1 <= nbk <= 16 and (nbk == 1 or cols == 16)
        assert J * cols * nbk >= B > (J - 1) * cols * nbk
    assert plans[(74, 65)] == (16, 1, 5) and plans[(64, 129)] == (16, 1, 9)
    assert plans[(2304, 129)] == (4, 1, 33)
    assert plans[(6, 4097)][1] > 1 and plans[(1, 257)][1] > 1


def test_table_and_msm_match_jax(points, tables):
    """The JAX package's table carried across by convert.py equals the
    port's limb for limb, and both packages' msm_fixed (the JAX one on its
    jnp path) agree on it, with zero scalars and identity rows, for a batch
    of two MSMs."""
    n, c = 16, 8
    jt = jm.build_fixed_base_table(jg.affine_from_ints(points[:n]), c=c)
    table = convert.table_from_jax(np.asarray(jt.x), np.asarray(jt.y), np.asarray(jt.inf), jt.c)
    for a, b in zip(table[:3], _cut(tables[c], n)[:3]):
        assert torch.equal(a, b)
    rows, limbs = _scalars(5, n, 2)
    want = jg.xyzz_to_ints(jm.msm_fixed(jt, jnp.asarray(limbs.astype(np.uint32)), use_pallas=False))
    got = tg.xyzz_to_ints(tm.msm_fixed(table, torch.from_numpy(limbs)))
    assert got == want == [oracle_msm(points[:n], s) for s in rows]
