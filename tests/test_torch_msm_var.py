"""kzg_tpu_torch's variable-base MSM (ops/msm.py msm, msm_core) and the
plain version of kernel B3
(ops/cuda_msm.py horner_windows_ref) on the CPU, against the oracle
(Python ints) and the JAX package. Tolerance: exact. Limbs are compared
where the same formulas run on the same values (the Horner steps); MSM
sums as affine points, since bucket sums in XYZZ depend on the order of
additions."""

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
from kzg_tpu_torch import tracing
from kzg_tpu_torch.ops import cuda_msm
from kzg_tpu_torch.ops import field as tf
from kzg_tpu_torch.ops import g1 as tg
from kzg_tpu_torch.ops import launch
from kzg_tpu_torch.ops import msm as tm

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

N_MAX = 128


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(41)
    pts = [G1.mul_scalar(G1_GENERATOR, int(rng.integers(1, 1 << 62)) * 7919 % R) for _ in range(N_MAX)]
    for i in (2, 30, 99):
        pts[i] = None  # identity rows
    return pts


def _scalars(seed, n, nb, turn=False):
    """nb rows of n scalars with zeros, 1, 2 and r - 1 among random ones;
    with `turn`, row b's edge values turned by b places (so that a row of
    one point meets another edge value than the first row's)."""
    rng = np.random.default_rng(seed)
    edge = (0, R - 1, 1, 2)
    rows = []
    for b in range(nb):
        s = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
        k = b if turn else 0
        for i, v in zip((0, 1, 3, 4), edge[k:] + edge[:k]):
            if i < n:
                s[i] = v
        rows.append(s)
    return rows, np.stack([tf.ints_to_limbs(s, 16) for s in rows], axis=1)  # (16, nb, n)


# ---- B3's plain version --------------------------------------------------


def _windows(points, nb, w, c, edge=True):
    """XYZZ windows (24, nb, w) with projective zz != 1 (doubled affine
    points, from the oracle's point 2P) and, with `edge`, the edge lanes:
    lane 1 all identity but one window; lane 2 with W_{w-2} = 2^c W_{w-1}
    (the doubled accumulator equals the window, P == Q); lane 3 with
    W_{w-2} = -2^c W_{w-1} (P == -Q)."""
    pts = [p for p in points if p is not None][: nb * w]
    base = [[pts[b * w + j] for j in range(w)] for b in range(nb)]
    if edge:
        base[1] = [None] * w
        base[1][w - 3] = pts[0]
        for lane, sign in ((2, 1), (3, -1)):
            q = G1.mul_scalar(base[lane][w - 1], 1 << c)
            base[lane][w - 2] = q if sign > 0 else G1.affine_neg(q)
    # the window holds the point P as dbl(from_affine(P / 2)): halve with 1/2 mod r
    half = pow(2, -1, R)
    halves = [[None if p is None else G1.mul_scalar(p, half) for p in row] for row in base]
    flat = [p for row in halves for p in row]
    aff = tg.affine_from_ints(flat, "cpu")
    win = tg.dbl(tg.from_affine(aff))
    return base, tg.map_coords(lambda t: t.reshape(24, nb, w).contiguous(), win)


def test_horner_plain_matches_jax_step_loop(points):
    """B3's plain version against the JAX package's loop form
    (kzg_tpu/ops/msm.py, the Horner fallback of msm_core), run step by
    step from kzg_tpu.ops.g1.dbl and add_unified_jnp: limb for limb, with
    identity windows, P == Q and P == -Q lanes, c = 2, w = 4."""
    nb, w, c = 4, 4, 2
    _, win = _windows(points, nb, w, c)
    got = cuda_msm.horner_windows(win, c)
    jwin = jg.G1XYZZ(*(jnp.asarray(t.numpy().astype(np.uint32)) for t in win))
    dbl = jax.jit(jg.dbl)
    add = jax.jit(jg.add_unified_jnp)
    acc = jg.G1XYZZ(*(t[..., w - 1] for t in jwin))
    for j in range(w - 2, -1, -1):
        for _ in range(c):
            acc = dbl(acc)
        acc = add(acc, jg.G1XYZZ(*(t[..., j] for t in jwin)))
    for a, b in zip(got, acc):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


def test_horner_plain_matches_oracle_at_the_verify_shape(points):
    """c = 13, w = 20 (the window of a 2048-point MSM), two MSMs: the sum
    sum_j 2^(13 j) W_j with Python ints."""
    nb, w, c = 2, 20, 13
    base, win = _windows(points, nb, w, c, edge=False)
    got = tg.xyzz_to_ints(cuda_msm.horner_windows(win, c))
    want = []
    for row in base:
        acc = None
        for j, p in enumerate(row):
            acc = G1.affine_add(acc, G1.mul_scalar(p, 1 << (c * j)))
        want.append(acc)
    assert got == want


def test_horner_wrapper_checks_its_inputs(points):
    _, win = _windows(points, 4, 3, 2)
    with pytest.raises(ValueError, match="dtype"):
        cuda_msm.horner_windows(tg.map_coords(lambda t: t.long(), win), 2)
    with pytest.raises(ValueError, match="shape"):
        cuda_msm.horner_windows(tg.G1XYZZ(win.x, win.y, win.zz, win.zzz[:, :2].contiguous()), 2)
    with pytest.raises(ValueError, match="shape"):
        cuda_msm.horner_windows(tg.map_coords(lambda t: t[:, 0], win), 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_msm.horner_windows(tg.map_coords(lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), win), 2)
    with pytest.raises(ValueError, match="c >= 1"):
        cuda_msm.horner_windows(win, 0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_msm.horner_windows(tg.map_coords(lambda t: t.to("meta"), win), 2)
    assert launch.launches()["horner"] == 0


# ---- the variable-base MSM -----------------------------------------------


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("n", [8, 33, 128])
def test_msm_matches_oracle(points, n, nb):
    """The bucket path (n >= 8, or any batch), with zero scalars, 1, 2,
    r - 1 and identity points; batch 1 without a batch axis."""
    rows, limbs = _scalars(100 * n + nb, n, nb)
    aff = tg.affine_from_ints(points[:n], "cpu")
    if nb == 1:
        got = tg.xyzz_to_ints(tm.msm(aff, torch.from_numpy(limbs[:, 0])))
    else:
        got = tg.xyzz_to_ints(tm.msm(tg.repeat_batch(aff, nb), torch.from_numpy(limbs)))
    assert got == [oracle_msm(points[:n], s) for s in rows]


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("n", [1, 6, 7])
def test_small_msm_takes_the_bucket_path(points, n, nb, monkeypatch):
    """Below 8 points, with no batch axis (nb = 1) and with one, msm()
    takes the bucket path, no per-lane ladder, and counts one msm.small a
    row; the sums equal the oracle's as affine points, with the edge
    scalars and the identity row among the points (n >= 3)."""
    monkeypatch.setattr(tg, "scalar_mul", None)  # the ladder's step: any call raises
    rows, limbs = _scalars(300 + 10 * n + nb, n, nb, turn=True)
    aff = tg.affine_from_ints(points[:n], "cpu")
    before = tracing.counters().get("msm.small", 0)
    if nb == 1:
        got = tg.xyzz_to_ints(tg.map_coords(lambda t: t[:, None], tm.msm(aff, torch.from_numpy(limbs[:, 0]))))
    else:
        got = tg.xyzz_to_ints(tm.msm(tg.repeat_batch(aff, nb), torch.from_numpy(limbs)))
    assert tracing.counters()["msm.small"] - before == nb
    assert got == [oracle_msm(points[:n], s) for s in rows]


def test_small_batched_msm_takes_the_bucket_path(points):
    """Below 8 points with a batch axis msm() takes the bucket path, as it
    does at every n; the sums equal the oracle's."""
    rows, limbs = _scalars(5, 3, 2)
    got = tg.xyzz_to_ints(tm.msm(tg.repeat_batch(tg.affine_from_ints(points[:3], "cpu"), 2), torch.from_numpy(limbs)))
    assert got == [oracle_msm(points[:3], s) for s in rows]


def test_small_msm_matches_jax_ladder(points):
    """n = 5 with no batch axis, where the JAX package's msm takes its
    jitted per-lane ladder and the port the bucket path: the two sums and
    the oracle's are the same affine point (XYZZ coordinates differ with
    the order of the additions)."""
    n = 5
    rows, limbs = _scalars(7, n, 1)
    sc = limbs[:, 0]
    got = tm.msm(tg.affine_from_ints(points[:n], "cpu"), torch.from_numpy(sc))
    want = jm.msm(jg.affine_from_ints(points[:n]), jnp.asarray(sc.astype(np.uint32)))
    got_aff = tg.xyzz_to_ints(tg.map_coords(lambda t: t[:, None], got))
    assert got_aff == jg.xyzz_to_ints(jg.G1XYZZ(*(t[:, None] for t in want))) == [oracle_msm(points[:n], rows[0])]


def test_msm_pieces_match_jax(points):
    """msm_core's pieces over the batch-2 inputs of a 16-point MSM: the keys
    and rows against the JAX package's own (its signed digits under the key
    formula of kzg_tpu/ops/msm.py msm_core, its packed point rows), and the
    bucket sums of one window against the oracle. (The JAX package's whole
    jnp msm takes about a minute to compile on XLA:CPU; its ladder is held
    against the port's bucket path in test_small_msm_matches_jax_ladder.)"""
    n, nb, c = 16, 2, 6
    _, limbs = _scalars(11, n, nb)
    aff = tg.repeat_batch(tg.affine_from_ints(points[:n], "cpu"), nb)
    rows_packed, lay, n_keys, nb_, w = tm._var_inputs(aff, torch.from_numpy(limbs), c)
    half = 1 << (c - 1)
    digits = np.asarray(jm.signed_digits(jnp.asarray(limbs.astype(np.uint32)), c)).astype(np.int64)
    seg = np.arange(nb)[None, :, None] * w + np.arange(w)[:, None, None]
    keys = (seg * (half + 1) + np.abs(digits)).reshape(-1)
    assert n_keys == nb * w * (half + 1) and nb_ == nb
    np.testing.assert_array_equal(lay.sorted_keys.numpy(), np.sort(keys))
    jaff = jg.affine_from_ints(points[:n])
    jx = jnp.stack([jaff.x, jaff.x], axis=1)
    jy = jnp.stack([jaff.y, jaff.y], axis=1)
    want, r0 = jm._pack_point_rows(jx, jy, jnp.stack([jaff.inf, jaff.inf]))
    np.testing.assert_array_equal(rows_packed.numpy().view(np.uint32), np.asarray(want))
    # the element of sorted rank k reads row src + R0 exactly when its digit is negative
    src = lay.idx.T.reshape(-1)[: keys.size].numpy()
    order = np.argsort(keys, kind="stable")
    sign = (digits.reshape(-1) < 0)[order]
    nat = np.broadcast_to(np.arange(nb * n).reshape(1, nb, n), digits.shape).reshape(-1)[order]
    np.testing.assert_array_equal(src, np.where(sign, nat + r0, nat))
    # the bucket sums of window 1 of MSM 0: bucket k sums sign(d_i) P_i over |d_i| == k
    sums = tm._bucket_sums_mem(rows_packed, lay, n_keys)
    j = 1
    got = tg.xyzz_to_ints(tg.map_coords(lambda t: t.reshape(24, nb, w, half + 1)[:, 0, j], sums))
    want = [None] * (half + 1)
    for i in range(n):
        d = int(digits[j, 0, i])
        if points[i] is not None:
            want[abs(d)] = G1.affine_add(want[abs(d)], points[i] if d >= 0 else G1.affine_neg(points[i]))
    assert got == want
