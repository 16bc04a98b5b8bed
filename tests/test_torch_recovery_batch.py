"""kzg_tpu_torch's batched erasure recovery on the CPU, at full protocol
width: recover_cells_and_kzg_proofs_batch makes one recovery body and one
FK20 proof step per chunk of BATCH_CHUNK blobs. One batch of three blobs
(two given the same 64 columns, one given all 128) returns the blobs'
cells, byte-equal to the single calls' and to compute_cells, and hands
the proof step one tensor whose rows are each blob's monomial form; the
call counts one recovery pass and two blobs recovered, and the span
kzg.body.vanish nests in kzg.body.recover. A bad blob in the middle of a
batch raises the JAX package's message for that blob before any device
work. The batched coefficients of two blobs equal the benchmark's plain
reference (kzgbench/reference/recovery.py). The FK20 proof step is
swapped for a recorder (about 100 s at full width on the CPU);
chip_smoke.py holds the proofs on the card."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kzg_tpu import eip7594 as je
from kzg_tpu.oracle import das as odas
from kzg_tpu_torch import api, tracing
from kzg_tpu_torch import eip7594 as te
from kzg_tpu_torch.constants import R_MOD as R
from kzg_tpu_torch.ops import launch
from kzg_tpu_torch.ops.field import FR
from kzgbench.reference import recovery

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

HALF = sorted(np.random.default_rng(14).choice(128, 64, replace=False).tolist())
BATCH = [HALF, HALF, list(range(128))]  # the columns given to each blob of the batch


def _blob(seed):
    a = np.random.default_rng(seed).integers(0, 256, (4096, 32), dtype=np.uint8)
    a[:, 0] &= 0x3F  # below r
    return a.tobytes()


def _ints(b: bytes):
    return [int.from_bytes(b[i : i + 32], "big") for i in range(0, len(b), 32)]


BLOBS = [_blob(seed) for seed in (41, 42, 43)]


def _recorder(seen):
    """A stand-in for the FK20 proof step: keeps the coefficients it is
    handed and returns a placeholder proof per cell, named by blob."""
    return lambda poly_m, s: seen.append(poly_m) or [[f"proof {len(seen)}.{b}"] * 128 for b in range(poly_m.shape[1])]


@pytest.fixture(scope="module")
def port():
    return api.load_trusted_setup_file(device="cpu")


@pytest.fixture(scope="module")
def cells(port):
    return [api.compute_cells(b, port) for b in BLOBS]


@pytest.fixture(scope="module")
def batch(port, cells):
    """One batch call under a CPU profiler, the proof step recorded: its
    output, the coefficients the proof step saw and the recorded spans."""
    mp = pytest.MonkeyPatch()
    seen = []
    mp.setattr(te, "_proof_bytes", _recorder(seen))
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = api.recover_cells_and_kzg_proofs_batch(BATCH, [[c[i] for i in idx] for c, idx in zip(cells, BATCH)], port)
        return out, seen, tracing.spans()
    finally:
        mp.undo()


def test_batch_cells_equal_the_single_calls_and_compute_cells(batch, port, cells, monkeypatch):
    (out_cells, out_proofs), _, _ = batch
    assert out_cells == cells
    assert out_proofs == [["proof 1.0"] * 128, ["proof 1.1"] * 128, ["proof 1.2"] * 128]
    monkeypatch.setattr(te, "_proof_bytes", _recorder([]))
    for c, idx, want in zip(cells, BATCH, out_cells):
        single, _ = api.recover_cells_and_kzg_proofs(idx, [c[i] for i in idx], port)
        assert single == want


def test_batch_hands_the_proof_step_each_blobs_monomial_form(batch):
    _, seen, _ = batch
    (poly_m,) = seen
    assert poly_m.shape[:2] == (16, 3) and poly_m.shape[2] >= 4096
    for b, blob in enumerate(BLOBS):
        assert FR.decode(poly_m[:, b, :4096]) == odas.poly_lagrange_to_monomial(_ints(blob))


def test_one_recovery_pass_and_the_vanish_span_nests(batch):
    _, _, spans = batch
    (call,) = [s for s in spans if s.name == "kzg.api.recover_cells_and_kzg_proofs_batch"]
    assert call.counts["recover.passes"] == 1 and call.counts["recover.blobs"] == 2
    (rec,) = [i for i, s in enumerate(spans) if s.name == "kzg.body.recover"]
    (vanish,) = [s for s in spans if s.name == "kzg.body.vanish"]
    assert vanish.parent == rec and vanish.call == call.call
    assert spans[rec].start_ns <= vanish.start_ns <= vanish.end_ns <= spans[rec].end_ns


def test_chunks_of_batch_chunk_blobs(port, cells, monkeypatch):
    """Three blobs at two a chunk: two passes, two proof steps, the same
    cells and the proofs in blob order."""
    seen = []
    monkeypatch.setattr(te, "_proof_bytes", _recorder(seen))
    monkeypatch.setattr(te, "BATCH_CHUNK", 2)
    before = tracing.counters()
    out_cells, out_proofs = api.recover_cells_and_kzg_proofs_batch(
        BATCH, [[c[i] for i in idx] for c, idx in zip(cells, BATCH)], port
    )
    after = tracing.counters()
    assert out_cells == cells
    assert out_proofs == [["proof 1.0"] * 128, ["proof 1.1"] * 128, ["proof 2.0"] * 128]
    assert [p.shape[1] for p in seen] == [2, 1]
    assert after["recover.passes"] - before.get("recover.passes", 0) == 2
    assert after["recover.blobs"] - before.get("recover.blobs", 0) == 2


def _bad_blob(cells, case):
    asc = list(range(64))
    if case == "fewer than 64":
        return asc[:63], cells[:63]
    if case == "not ascending":
        return [1, 0] + asc[2:], cells[:64]
    if case == "bad cell length":
        return asc, cells[:5] + [cells[5][:-1]] + cells[6:64]
    bad = R.to_bytes(32, "big") + cells[9][32:]  # non-canonical scalar
    return asc, cells[:9] + [bad] + cells[10:64]


@pytest.mark.parametrize("case", ["fewer than 64", "not ascending", "bad cell length", "non-canonical scalar"])
def test_a_bad_blob_in_the_middle_raises_its_error_before_any_device_work(port, cells, monkeypatch, case):
    """Blob 1 of three is bad: the batch raises the JAX package's message
    for that blob (its checks raise before any device work, so the JAX
    function needs no settings), and no recovery body, proof step or
    kernel runs."""
    ran = []
    monkeypatch.setattr(te, "_recover_body", lambda *a: ran.append("body"))
    monkeypatch.setattr(te, "_proof_bytes", lambda *a: ran.append("proofs"))
    bad_idx, bad_cells = _bad_blob(cells[1], case)
    with pytest.raises(ValueError) as want:
        je.recover_cells_and_kzg_proofs(bad_idx, bad_cells, None)
    launch.reset_launches()
    idxs = [HALF, bad_idx, list(range(128))]
    given = [[cells[0][i] for i in HALF], bad_cells, cells[2]]
    with pytest.raises(ValueError) as got:
        api.recover_cells_and_kzg_proofs_batch(idxs, given, port)
    assert str(got.value) == str(want.value)
    assert ran == [] and not any(launch.launches().values())


def test_batched_coefficients_equal_the_plain_reference(port, cells):
    """The recovery body over two blobs given different columns (a random
    64, cells 64-127): each blob's coefficients are the plain reference's
    recover_polynomialcoeff, and the top half is zero."""
    idxs = [HALF, list(range(64, 128))]
    limbs = [te._check_recover_inputs(idx, [c[i] for i in idx]) for c, idx in zip(cells, idxs)]
    _, coeffs = te._recover_body(*te._recover_inputs(idxs, limbs, port.device), port)
    for b, (c, idx) in enumerate(zip(cells, idxs)):
        want = recovery.recover_polynomialcoeff(idx, [_ints(c[i]) for i in idx])
        assert FR.decode(coeffs[:, b, :]) == want + [0] * 4096
