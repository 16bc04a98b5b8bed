"""A run's judgement sees each fault the cells can have: the harness runs
as on the card (set-up, window, reference, result line) with the program
replaced by a stand-in made of the reference, a fault planted where its
answers are produced, and `correct` must come out false, and true with no
fault. The cells keep no state between calls and run on one card, so of
the faults a step that returns its state unchanged and an exchange
between chips left out do not apply. The producers run on sparse blobs and
smaller batches here (the stand-in's proofs are quick only on those)."""

import random

import pytest
import standin

from kzgbench import callkind, harness

PRODUCERS = ("cells-produce-block", "blobs-commit-prove")
VERIFIERS = ("cells-verify-column", "blobs-verify-block")


def _run(monkeypatch, setup_full, workload, fault, seed, seconds, **traffic_changes):
    spec = harness.cell_spec(workload)
    traffic = dict(spec[3], **traffic_changes)
    monkeypatch.setattr(harness, "cell_spec", lambda name: spec[:3] + (traffic,))
    monkeypatch.setattr(
        callkind.FreshBlobs, "prepare", lambda self, s, i: standin.sparse_blobs(random.Random(s * 1000 + i), self.traffic["blobs"])
    )
    return harness.run_cell(workload, seed, seconds, False, api=standin.StandIn(setup_full, fault), device="cpu")


@pytest.mark.parametrize("fault", standin.FAULTS)
@pytest.mark.parametrize("workload", PRODUCERS)
def test_producer_faults(monkeypatch, setup_full, workload, fault):
    line = _run(monkeypatch, setup_full, workload, fault, 11, 6.0, blobs=2, prepared_calls=2, warm_calls=0, checked_calls=1)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] == (fault == "none"), line["checks"]
    assert list(line)[-1] == "checks"


def _seed_with_early_bad_half(workload):
    """A seed whose first call is invalid, with the replaced proof in the
    batch's second half, which a verifier of the first half alone accepts."""
    kind = callkind.kind(harness.cell_spec(workload)[3], harness.ROOT)
    for seed in range(1000):
        kind.setup(seed)
        if 0 in kind.invalid and kind.draw(seed, 0)[2][0] >= (kind.traffic["blobs"] + 1) // 2:
            return seed
    raise AssertionError("no such seed below 1000")


@pytest.mark.parametrize("fault", standin.FAULTS)
@pytest.mark.parametrize("workload", VERIFIERS)
def test_verifier_faults(monkeypatch, setup_full, workload, fault):
    seed = _seed_with_early_bad_half(workload)
    line = _run(monkeypatch, setup_full, workload, fault, seed, 2.0, warm_calls=0)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] == (fault == "none"), line["checks"]
