"""kzg_tpu_torch.ops.field against the JAX package's ops/field.py and
python ints, on the CPU. Tolerance: exact (integer field arithmetic; the
two packages share the limb layout and the Montgomery radix, so fully
reduced results are equal limb for limb).

Each op runs at three batch widths, so that the Python-integer path of
narrow CPU batches and both carry forms of the tensor code (the lookahead
form for narrow batches, the limb chain for wide ones) are held against
the same references."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kzg_tpu.ops import field as jf
from kzg_tpu_torch.ops import field as tf
from kzg_tpu_torch.ops import launch

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

SPECS = {"Fr": (tf.FR, jf.FR), "Fp": (tf.FP, jf.FP)}
WIDTHS = (8, 64, 600)  # the integer path; below and above the chain threshold


def _ints(rng, m, n):
    """n values in [0, m) with the edge values 0, 1 and m - 1 first."""
    vals = [0, 1, m - 1]
    bits = m.bit_length()
    while len(vals) < n:
        v = int.from_bytes(rng.bytes((bits + 7) // 8), "little") % m
        vals.append(v)
    return vals


def _inputs(name, n, seed):
    spec = SPECS[name][0]
    rng = np.random.default_rng(seed)
    xs = _ints(rng, spec.modulus, n)
    ys = list(reversed(_ints(rng, spec.modulus, n)))
    a = tf.ints_to_limbs(xs, spec.n_limbs)
    b = tf.ints_to_limbs(ys, spec.n_limbs)
    return xs, ys, a, b


def _torch(op, spec, *arrs):
    return op(spec, *(torch.from_numpy(x) for x in arrs)).numpy()


def _jax(op, spec, *arrs):
    return np.asarray(op(spec, *(jnp.asarray(x.astype(np.uint32)) for x in arrs)))


def _same(t, j):
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64))


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", ["Fr", "Fp"])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_op_matches_jax_and_ints(op, name, n):
    spec, jspec = SPECS[name]
    xs, ys, a, b = _inputs(name, n, 1)
    got = _torch(getattr(tf, op), spec, a, b)
    _same(got, _jax(getattr(jf, op), jspec, a, b))
    m = spec.modulus
    rinv = pow(1 << (16 * spec.n_limbs), -1, m)
    want = {
        "add": [(x + y) % m for x, y in zip(xs, ys)],
        "sub": [(x - y) % m for x, y in zip(xs, ys)],
        "mont_mul": [x * y * rinv % m for x, y in zip(xs, ys)],
    }[op]
    assert tf.limbs_to_ints(got) == want


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_neg_and_is_zero(name):
    spec, jspec = SPECS[name]
    xs, _, a, _ = _inputs(name, 64, 2)
    got = _torch(tf.neg, spec, a)
    _same(got, _jax(jf.neg, jspec, a))
    assert tf.limbs_to_ints(got) == [(-x) % spec.modulus for x in xs]
    z = tf.is_zero(spec, torch.from_numpy(a)).numpy()
    assert z.tolist() == [x == 0 for x in xs]


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_canonical_conversions(name):
    """from_canonical takes any value below R (inputs >= m included) and
    reduces fully, as the JAX package does; to_canonical inverts it."""
    spec, jspec = SPECS[name]
    m = spec.modulus
    R = 1 << (16 * spec.n_limbs)
    rng = np.random.default_rng(3)
    big = [m, m + 1, R - 1] + [m + int.from_bytes(rng.bytes(32 if name == "Fr" else 48), "little") % (R - m) for _ in range(13)]
    xs = _ints(rng, m, 16) + big
    a = tf.ints_to_limbs(xs, spec.n_limbs)
    mont = _torch(tf.from_canonical, spec, a)
    _same(mont, _jax(jf.from_canonical, jspec, a))
    assert tf.limbs_to_ints(mont) == [x * R % m for x in xs]
    back = _torch(tf.to_canonical, spec, mont)
    _same(back, _jax(jf.to_canonical, jspec, mont))
    assert tf.limbs_to_ints(back) == [x % m for x in xs]


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_encode_decode_and_consts(name):
    spec, jspec = SPECS[name]
    xs = _ints(np.random.default_rng(4), spec.modulus, 8)
    enc = spec.encode(xs, "cpu")
    assert enc.dtype == torch.int32
    np.testing.assert_array_equal(enc.numpy(), jspec.encode_host(xs).astype(np.int32))
    assert spec.decode(enc) == xs
    np.testing.assert_array_equal(spec.one_mont, jspec.one_mont.astype(np.int32))
    np.testing.assert_array_equal(spec.const(12345), jspec.const(12345).astype(np.int32))


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_mul_many_and_mul_const(name):
    spec, jspec = SPECS[name]
    _, _, a, b = _inputs(name, 64, 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prods = tf.mul_many(spec, [(ta, tb), (tb, tb), (ta, ta)])
    for got, (x, y) in zip(prods, [(a, b), (b, b), (a, a)]):
        _same(got.numpy(), _jax(jf.mont_mul, jspec, x, y))
    c = spec.const(7)
    _same(tf.mul_const(spec, ta, c).numpy(), np.asarray(jf.mul_const(jspec, jnp.asarray(a.astype(np.uint32)), jspec.const(7))))


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_inverse_and_powers(name):
    spec, jspec = SPECS[name]
    xs, _, _, _ = _inputs(name, 16, 6)
    m = spec.modulus
    enc = spec.encode(xs, "cpu")
    inv = tf.inv(spec, enc)
    _same(inv.numpy(), np.asarray(jf.inv(jspec, jnp.asarray(enc.numpy().astype(np.uint32)))))
    assert spec.decode(inv) == [pow(x, m - 2, m) for x in xs]  # 0 -> 0
    assert spec.decode(tf.pow_fixed(spec, enc, 5)) == [pow(x, 5, m) for x in xs]
    assert spec.decode(tf.pow_fixed(spec, enc, 0)) == [1] * len(xs)


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_inv_on_the_cpu_launches_nothing(name):
    """A CPU tensor takes the plain version, pow_fixed: no launch of B7."""
    spec = SPECS[name][0]
    m = spec.modulus
    xs, _, _, _ = _inputs(name, 40, 8)
    launch.reset_launches()
    inv = tf.inv(spec, spec.encode(xs, "cpu").reshape(spec.n_limbs, 5, 8))
    assert launch.launches()["field_inv"] == 0
    assert inv.shape == (spec.n_limbs, 5, 8)
    assert spec.decode(inv) == [pow(x, m - 2, m) for x in xs]  # 0 -> 0


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_inv_exponent_words_join_to_m_minus_2(name):
    spec = SPECS[name][0]
    words = tf.inv_exponent_words(spec)
    assert words.dtype == np.uint32 and words.shape == (spec.n_limbs // 2,)
    assert sum(int(w) << (32 * k) for k, w in enumerate(words)) == spec.modulus - 2


@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_batch_inv_tree_and_sum_tree(name, n):
    """Against python ints (the JAX batch_inv_tree takes far longer to
    compile on XLA:CPU than this file's budget)."""
    spec, _ = SPECS[name]
    m = spec.modulus
    xs = _ints(np.random.default_rng(7 + n), m, max(n, 3))[:n]
    enc = spec.encode(xs, "cpu").reshape(spec.n_limbs, 1, n)
    out, was_zero = tf.batch_inv_tree(spec, enc)
    assert was_zero.reshape(-1).tolist() == [x == 0 for x in xs]
    got = spec.decode(out)
    assert [g for g, x in zip(got, xs) if x] == [pow(x, m - 2, m) for x in xs if x]
    out1, _ = tf.batch_inv_tree(spec, enc, zero_to_one=True)
    assert [g for g, x in zip(spec.decode(out1), xs) if not x] == [1] * xs.count(0)
    assert spec.decode(tf.sum_tree(spec, enc)) == [sum(xs) % m]


def test_select_and_eq():
    a = tf.FP.encode([1, 2, 3], "cpu")
    b = tf.FP.encode([4, 2, 6], "cpu")
    assert tf.eq(tf.FP, a, b).tolist() == [False, True, False]
    mask = torch.tensor([True, False, True])
    assert tf.FP.decode(tf.select(mask, a, b)) == [1, 2, 3]


@pytest.mark.parametrize("name", ["Fr", "Fp"])
def test_narrow_batches_match_the_tensor_code(name, monkeypatch):
    """Up to _INT_MAX_LANES lanes on the CPU, add, sub and mont_mul run on
    Python integers; with that path off, the tensor code (the card's) gives
    the same limbs at the same narrow width, from_canonical's inputs at or
    above m included."""
    spec, _ = SPECS[name]
    m, R = spec.modulus, 1 << (16 * spec.n_limbs)
    _, _, a, b = _inputs(name, 8, 9)
    big = tf.ints_to_limbs([m, R - 1, m + 12345], spec.n_limbs)
    ta, tb, tbig = (torch.from_numpy(x) for x in (a, b, big))
    assert a.shape[1] <= tf._INT_MAX_LANES
    runs = []
    for limit in (tf._INT_MAX_LANES, 0):
        monkeypatch.setattr(tf, "_INT_MAX_LANES", limit)
        runs.append([tf.add(spec, ta, tb), tf.sub(spec, ta, tb), tf.mont_mul(spec, ta, tb),
                     tf.from_canonical(spec, tbig), tf.mont_mul(spec, ta[:, :1], tb)])
    for x, y in zip(*runs):
        assert x.dtype == y.dtype == torch.int32 and torch.equal(x, y)
