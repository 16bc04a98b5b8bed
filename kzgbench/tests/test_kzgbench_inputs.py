"""Each traffic's inputs are fixed by the seed and valid for their call."""

import json
import os
import random

import pytest

from kzgbench import callkind
from kzgbench.blobs import canonical_blobs, rng_for
from kzgbench.reference import kzg as K

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAFFICS = ("cells-produce-block", "blobs-commit-prove", "cells-verify-column", "blobs-verify-block")
SEEDS = (0, 2**31 + 12345, -7)


def kind_of(name):
    with open(os.path.join(ROOT, "kzgbench", "traffic", name + ".json")) as f:
        traffic = json.load(f)
    return callkind.kind(traffic, ROOT)


def test_blobs_canonical_and_seeded():
    a = canonical_blobs(rng_for(2**31 + 1, 1, 0), 2)
    assert a == canonical_blobs(rng_for(2**31 + 1, 1, 0), 2)
    assert a != canonical_blobs(rng_for(2**31 + 2, 1, 0), 2)
    assert all(len(b) == K.BLOB_BYTES for b in a)
    values = [v for b in a for v in K.blob_to_evals(b)]  # raises on a non-canonical element
    assert max(values) > K.R // 2  # uniform below r, not below 2^254


@pytest.mark.parametrize("name", TRAFFICS)
def test_inputs_fixed_by_seed(name):
    seed = SEEDS[1]
    k1, k2, k3 = kind_of(name), kind_of(name), kind_of(name)
    for k, s in ((k1, seed), (k2, seed), (k3, seed + 1)):
        k.setup(s)
    first = [k1.prepare(seed, i) for i in range(3)]
    assert first == [k2.prepare(seed, i) for i in range(3)]
    assert first != [k3.prepare(seed + 1, i) for i in range(3)]
    assert first[0] != first[1]


@pytest.mark.parametrize("name", ("cells-produce-block", "blobs-commit-prove"))
@pytest.mark.parametrize("seed", SEEDS)
def test_producer_inputs_valid(name, seed):
    k = kind_of(name)
    k.setup(seed)
    blobs = k.prepare(seed, 0)
    assert len(blobs) == k.traffic["blobs"]
    for b in blobs:
        K.blob_to_evals(b)


@pytest.mark.parametrize("name", ("cells-verify-column", "blobs-verify-block"))
def test_verify_inputs_valid_and_invalid_as_built(name, setup64):
    seed = SEEDS[1]
    k = kind_of(name)
    k.setup(seed)
    n = k.traffic["prepared_calls"]
    assert len(k.invalid) == round(k.traffic["invalid_share"] * n)
    rng = random.Random(3)
    bad = min(k.invalid)
    good = min(set(range(n)) - k.invalid)
    for i in (good, bad):
        args, expected = k.prepare(seed, i)
        assert expected == (i not in k.invalid)
        assert len(set(args[0])) == k.traffic["blobs"]  # distinct blobs (commitments)
        assert k.verify(setup64, args, rng) == expected
    warm_args, warm_expected = k.prepare(seed, callkind.WARM_BASE)
    assert warm_expected
