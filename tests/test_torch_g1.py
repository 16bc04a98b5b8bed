"""kzg_tpu_torch.ops.g1 against the JAX package's ops/g1.py (limb for limb:
the same formulas on fully reduced values) and the oracle curve, on the
CPU, with identity operands, P == Q and P == -Q in every batch.
Tolerance: exact."""

import numpy as np
import pytest
import torch

import jax
from kzg_tpu.constants import R_MOD as R
from kzg_tpu.ops import g1 as jg
from kzg_tpu.oracle.curve import G1, G1_GENERATOR
from kzg_tpu_torch.ops import cuda_msm, launch
from kzg_tpu_torch.ops import g1 as tg

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

N = 16


def _points(seed, n=N):
    rng = np.random.default_rng(seed)
    return [G1.mul_scalar(G1_GENERATOR, int(rng.integers(1, 1 << 62)) * 7919 % R) for _ in range(n)]


@pytest.fixture(scope="module")
def pairs():
    """Affine P and Q batches with the edge cases: Q = P, Q = -P, Q = O,
    P = O, P = Q = O."""
    P = _points(11)
    Q = _points(12)
    Q[1] = P[1]
    Q[2] = G1.affine_neg(P[2])
    Q[3] = None
    P[4] = None
    P[5] = Q[5] = None
    return P, Q


def _t(aff_j):
    """A JAX point batch -> the torch one (same limbs)."""
    return type(aff_j)(*(torch.from_numpy(np.asarray(c).astype(np.int32 if c.dtype != bool else bool)) for c in aff_j))


def _same(tp, jp):
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))


def _xyzz_pair(P, Q):
    """XYZZ inputs with non-trivial zz: 2P and 2Q, doubled by JAX."""
    dbl = jax.jit(jg.dbl)
    pj = dbl(jg.from_affine(jg.affine_from_ints(P)))
    qj = dbl(jg.from_affine(jg.affine_from_ints(Q)))
    return pj, qj


def _dbl_affine(P):
    return [G1.affine_add(p, p) for p in P]


def test_affine_encoding_matches_jax(pairs):
    P, _ = pairs
    ta = tg.affine_from_ints(P, "cpu")
    _same(ta, jg.affine_from_ints(P))
    assert tg.affine_to_ints(ta) == P
    _same(tg.from_affine(ta), jg.from_affine(jg.affine_from_ints(P)))


def test_dbl_matches_jax_and_oracle(pairs):
    P, _ = pairs
    pj = jg.from_affine(jg.affine_from_ints(P))
    got = tg.dbl(_t(pj))
    _same(got, jax.jit(jg.dbl)(pj))
    assert tg.xyzz_to_ints(got) == _dbl_affine(P)


def test_add_unified_matches_jax_and_oracle(pairs):
    P, Q = pairs
    pj, qj = _xyzz_pair(P, Q)
    got = tg.add_unified(_t(pj), _t(qj))
    _same(got, jax.jit(jg.add_unified)(pj, qj))
    want = [G1.affine_add(a, b) for a, b in zip(_dbl_affine(P), _dbl_affine(Q))]
    assert tg.xyzz_to_ints(got) == want


def test_add_points_plain_is_add_unified(pairs):
    """B2's plain version, through the wrapper, on CPU tensors."""
    P, Q = pairs
    pj, qj = _xyzz_pair(P, Q)
    tp, tq = _t(pj), _t(qj)
    got = cuda_msm.add_points(tp, tq)
    _same(got, tg.add_unified_plain(tp, tq))
    assert launch.launches()["add_unified"] == 0  # no kernel on the CPU


def test_add_unified_identity_and_doubling_lanes(pairs):
    """P + P through the complete addition equals dbl(P); P + (-P) = O."""
    P, _ = pairs
    pj = jg.from_affine(jg.affine_from_ints(P))
    tp = _t(pj)
    assert tg.xyzz_to_ints(tg.add_unified(tp, tp)) == _dbl_affine(P)
    assert tg.xyzz_to_ints(tg.add_unified(tp, tg.neg(tp))) == [None] * len(P)


def test_madd_unified_matches_jax_and_oracle(pairs):
    P, Q = pairs
    pj, _ = _xyzz_pair(P, Q)
    qa = jg.affine_from_ints(_dbl_affine(Q))
    # lane 1 of 2P and 2Q is P == Q, lane 2 is P == -Q
    got = tg.madd_unified(_t(pj), _t(qa))
    _same(got, jax.jit(jg.madd_unified)(pj, qa))
    want = [G1.affine_add(a, b) for a, b in zip(_dbl_affine(P), _dbl_affine(Q))]
    assert tg.xyzz_to_ints(got) == want


def test_to_affine_matches_jax(pairs):
    P, Q = pairs
    pj, _ = _xyzz_pair(P, Q)
    got = tg.to_affine(_t(pj))
    _same(got, jax.jit(jg.to_affine)(pj))
    assert tg.affine_to_ints(got) == _dbl_affine(P)


def test_tree_reduce_and_suffix_scan(pairs):
    P, _ = pairs
    tp = tg.from_affine(tg.affine_from_ints(P[:5], "cpu"))
    total = None
    for p in P[:5]:
        total = G1.affine_add(total, p)
    assert tg.xyzz_to_ints(tg.tree_reduce(tp)) == [total]
    suffix = []
    for i in range(5):
        acc = None
        for p in P[i:5]:
            acc = G1.affine_add(acc, p)
        suffix.append(acc)
    assert tg.xyzz_to_ints(tg.suffix_scan_add(tp)) == suffix


def test_select_point_and_infinity():
    inf = tg.infinity((3,), "cpu")
    assert tg.is_inf(inf).tolist() == [True] * 3
    g = tg.from_affine(tg.affine_from_ints([G1_GENERATOR] * 3, "cpu"))
    mixed = tg.select_point(torch.tensor([True, False, True]), g, inf)
    assert tg.xyzz_to_ints(mixed) == [G1_GENERATOR, None, G1_GENERATOR]


def test_product_counts_match_the_kernel_constants(pairs, monkeypatch):
    """The products per operation that ops/cuda_msm.py states (and that
    chip_smoke.py's bounds use) are the ones the plain versions compute:
    madd 17; add 23, of which the doubling fallback's are dbl's 9, so
    P != Q needs 14."""
    P, Q = pairs
    pj, qj = _xyzz_pair(P, Q)
    tp, tq = _t(pj), _t(qj)
    qa = _t(jg.affine_from_ints(_dbl_affine(Q)))
    calls = []
    real = tg._mul_many

    def counting(pairs_):
        calls.append(len(pairs_))
        return real(pairs_)

    monkeypatch.setattr(tg, "_mul_many", counting)
    counts = {}
    for name, fn in (("madd", lambda: tg.madd_unified(tp, qa)), ("add", lambda: tg.add_unified_plain(tp, tq)),
                     ("dbl", lambda: tg.dbl(tp))):
        calls.clear()
        fn()
        counts[name] = sum(calls)
    assert counts == {"madd": cuda_msm.MADD_FMULS, "add": cuda_msm.ADD_FMULS, "dbl": cuda_msm.DBL_FMULS}


def test_addition_without_doubling_needs_its_stated_products(pairs, monkeypatch):
    """Of add_unified_plain's products, those that reach the sum of P != Q
    (no identity operand) number ADD_FMULS_DISTINCT: zeroing any one of them
    changes the sum, zeroing any other (the doubling fallback's) does not."""
    P, Q = pairs
    keep = [i for i in range(N) if P[i] is not None and Q[i] is not None and P[i] != Q[i] and Q[i] != G1.affine_neg(P[i])]
    pj, qj = _xyzz_pair([P[i] for i in keep], [Q[i] for i in keep])
    tp, tq = _t(pj), _t(qj)
    want = tg.add_unified_plain(tp, tq)
    real = tg._mul_many
    seen = []

    def zeroing(target):
        def mul(pairs_):
            out = real(pairs_)
            first = len(seen)
            seen.extend(range(first, first + len(out)))
            return [torch.zeros_like(r) if first + k == target else r for k, r in enumerate(out)]

        return mul

    used = 0
    for target in range(cuda_msm.ADD_FMULS):
        seen.clear()
        monkeypatch.setattr(tg, "_mul_many", zeroing(target))
        got = tg.add_unified_plain(tp, tq)
        used += not all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(seen) == cuda_msm.ADD_FMULS
    assert used == cuda_msm.ADD_FMULS_DISTINCT == cuda_msm.ADD_FMULS - cuda_msm.DBL_FMULS


def test_mixed_addition_without_doubling_needs_its_stated_products(pairs, monkeypatch):
    """Of madd_unified's products, those that reach the sum of P != Q (no
    identity operand, P != -Q) number MADD_FMULS_DISTINCT, B1's bound:
    zeroing any one of them changes the sum, zeroing any other (the
    doubling of the affine operand) does not."""
    P, Q = pairs
    keep = [i for i in range(N) if P[i] is not None and Q[i] is not None and P[i] != Q[i] and Q[i] != G1.affine_neg(P[i])]
    pj, _ = _xyzz_pair([P[i] for i in keep], [Q[i] for i in keep])
    tp = _t(pj)
    qa = _t(jg.affine_from_ints(_dbl_affine([Q[i] for i in keep])))
    want = tg.madd_unified(tp, qa)
    real = tg._mul_many
    seen = []

    def zeroing(target):
        def mul(pairs_):
            out = real(pairs_)
            first = len(seen)
            seen.extend(range(first, first + len(out)))
            return [torch.zeros_like(r) if first + k == target else r for k, r in enumerate(out)]

        return mul

    used = 0
    for target in range(cuda_msm.MADD_FMULS):
        seen.clear()
        monkeypatch.setattr(tg, "_mul_many", zeroing(target))
        got = tg.madd_unified(tp, qa)
        used += not all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(seen) == cuda_msm.MADD_FMULS
    assert used == cuda_msm.MADD_FMULS_DISTINCT == cuda_msm.MADD_FMULS - cuda_msm.MDBL_FMULS
