"""The recovery cell's parts: the plain reference's erasure recovery
(reference/recovery.py) on seeded blobs, the call kind's inputs
(calls/recover_cells_and_kzg_proofs_batch.py) fixed by the seed, and its
judgement, in a whole run of the harness against a stand-in program made
of the reference, with a fault planted: one wrong cell byte or two proofs
swapped must come out not correct, a faithful output correct; and the
readers of glue.recover_ms and glue.recover_passes on made-up spans."""

import json
import os
import random
import subprocess
import sys
import types
from typing import NamedTuple, Optional

import pytest

from kzgbench import byname, callkind, harness
from kzgbench.blobs import canonical_blobs, rng_for
from kzgbench.reference import kzg as K
from kzgbench.reference import pool as ref_pool
from kzgbench.reference import recovery

ROOT = harness.ROOT
WORKLOAD = "cells-recover-half"
FAULTS = ("none", "cell_byte", "proof_swapped")


def kind_of(name=WORKLOAD):
    with open(os.path.join(ROOT, "kzgbench", "traffic", name + ".json")) as f:
        return callkind.kind(json.load(f), ROOT)


@pytest.fixture(scope="module")
def seeded_blob():
    blob = canonical_blobs(rng_for(2**31 + 99, 1, 0), 1)[0]
    coeffs = K.evals_to_coeffs(K.blob_to_evals(blob))
    return coeffs, K.cells_from_coeffs(coeffs)


@pytest.mark.parametrize("given", ["a random 64", "cells 0-63"])
def test_reference_recovers_a_seeded_blob(seeded_blob, given):
    coeffs, cells = seeded_blob
    idx = sorted(random.Random(5).sample(range(K.CELLS), 64)) if given == "a random 64" else list(range(64))
    got = recovery.recover_polynomialcoeff(idx, [cells[k] for k in idx])
    assert got == coeffs
    assert K.cells_from_coeffs(got) == cells


def test_prepare_fixed_by_seed_with_the_same_columns_for_every_blob():
    seed = 2**31 + 12345
    k1, k2, k3 = kind_of(), kind_of(), kind_of()
    for k, s in ((k1, seed), (k2, seed), (k3, seed + 1)):
        k.setup(s)
    first = [k1.prepare(seed, i) for i in range(3)]
    assert first == [k2.prepare(seed, i) for i in range(3)]
    assert first != [k3.prepare(seed + 1, i) for i in range(3)]
    assert first[0][1] != first[1][1]  # the columns are drawn per call
    for picked, indices, given in first:
        assert len(picked) == len(set(picked)) == k1.traffic["blobs"] == 9
        cols = indices[0]
        assert all(idx == cols for idx in indices)
        assert cols == sorted(set(cols)) and len(cols) == k1.traffic["columns_given"] == 64
        for b, cells in zip(picked, given):
            assert cells == [k1.cells[b, c].tobytes() for c in cols]


class StandIn:
    """The program's recovery made of the reference: cells recovered by
    reference/recovery.py, proofs looked up in the pool by the recovered
    cells; `fault` planted in every call's answer."""

    def __init__(self, fault):
        self.fault = fault
        pool = ref_pool.load(os.path.join(ROOT, "kzgbench", "pools", "mainnet-16.json"))
        cells = callkind.pool_cells(ROOT, "mainnet-16", pool)
        self.proofs = {cells[b, 0].tobytes(): [bytes.fromhex(p) for p in e["cell_proofs"]] for b, e in enumerate(pool["entries"])}

    def load_trusted_setup_file(self, path=None, device=None):
        return types.SimpleNamespace(column_tables=None, recovery_shift_pows=None)

    def recover_cells_and_kzg_proofs_batch(self, indices, given, s):
        out_cells, out_proofs = [], []
        for idx, cells in zip(indices, given):
            coeffs = recovery.recover_polynomialcoeff(idx, [K.cell_from_bytes(c) for c in cells])
            row = [K.cell_to_bytes(c) for c in K.cells_from_coeffs(coeffs)]
            out_cells.append(row)
            out_proofs.append(list(self.proofs[row[0]]))
        if self.fault == "cell_byte":
            out_cells[0][5] = out_cells[0][5][:-1] + bytes([out_cells[0][5][-1] ^ 1])
        elif self.fault == "proof_swapped":
            out_proofs[0][0], out_proofs[0][1] = out_proofs[0][1], out_proofs[0][0]
        return out_cells, out_proofs


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    spec = harness.cell_spec(WORKLOAD)
    traffic = dict(spec[3], blobs=2, prepared_calls=2, warm_calls=0, checked_calls=1)
    monkeypatch.setattr(harness, "cell_spec", lambda name: spec[:3] + (traffic,))
    line = harness.run_cell(WORKLOAD, 2**31 + 7, 5.0, False, api=StandIn(fault), device="cpu")
    assert line["attempted"] >= 1 and line["failed"] == 0
    checks = {name: c["value"] for name, c in line["checks"].items()}
    assert checks == {
        "cells_wrong": int(fault == "cell_byte"),
        "proofs_wrong": 2 * (fault == "proof_swapped"),
        "calls_failed": 0,
    }
    assert line["correct"] == (fault == "none")


def test_a_reference_at_odds_with_the_pool_raises():
    """Where the reference's recovered cells differ from the pool's, the
    reference is at fault, not the program: the check raises."""
    k = kind_of()
    k.setup(3)
    inputs = k.prepare(3, 0)
    k.cells = k.cells.copy()
    k.cells[inputs[0][0], 127, 0] ^= 1
    with pytest.raises(RuntimeError):
        k.check(None, inputs, ([], []), random.Random(1))


class Span(NamedTuple):  # the fields of kzg_tpu_torch.tracing.Span
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    counts: Optional[dict]


MS = 1_000_000  # ns


def _made_up(passes: bool):
    """Two API calls of 100 ms: the first makes one recovery pass (its own
    time 32 ms, the vanishing polynomial's 6 ms), the second's recovery
    body (20 ms, no children) moves no counter."""
    rows = [  # (name, start ms, end ms, parent, call, counts)
        ("kzg.api.recover_cells_and_kzg_proofs_batch", 0, 100, -1, 1, {"recover.passes": 1} if passes else {}),
        ("kzg.body.recover", 10, 60, 0, 1, None),
        ("kzg.body.vanish", 12, 20, 1, 1, None),
        ("kzg.ntt", 14, 16, 2, 1, None),
        ("kzg.ntt", 30, 40, 1, 1, None),
        ("kzg.body.fk20", 70, 90, 0, 1, None),
        ("kzg.api.recover_cells_and_kzg_proofs_batch", 200, 300, -1, 2, {}),
        ("kzg.body.recover", 210, 230, 6, 2, None),
        ("kzg.settings.load", 400, 500, -1, 0, None),
    ]
    return [Span(n, a * MS + 1, b * MS + 1, p, c, k) for n, a, b, p, c, k in rows]


def test_the_readers_on_made_up_spans(monkeypatch):
    recover_ms, passes = byname.load("metrics", "glue.recover_ms"), byname.load("metrics", "glue.recover_passes")
    monkeypatch.setitem(sys.modules, "kzg_tpu_torch.tracing", types.SimpleNamespace(spans=lambda: _made_up(True)))
    assert recover_ms.read(None) == pytest.approx((32 + 6 + 20) / 2, rel=1e-9)
    assert passes.read(None) == 0.5
    # a program without the counter (the parent of the batched recovery) gives no pass count
    monkeypatch.setitem(sys.modules, "kzg_tpu_torch.tracing", types.SimpleNamespace(spans=lambda: _made_up(False)))
    assert passes.read(None) is None
    monkeypatch.delitem(sys.modules, "kzg_tpu_torch.tracing")
    assert recover_ms.read(None) is None and passes.read(None) is None


def test_the_reference_imports_neither_package_nor_torch():
    code = (
        "import sys, importlib; importlib.import_module('kzgbench.reference.recovery'); "
        "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    assert not set(out.stdout.strip().split(",")) & {"jax", "kzg_tpu", "kzg_tpu_torch", "torch"}
