"""The readers of the program's own spans (spans.py, metrics/api.*,
glue.*, host_core.*, device.wait_ms): the per-call values of a made-up
list of spans, nothing where the program recorded no API call or has no
tracing module, and nothing in a traced run of the stand-in program."""

import random
import sys
import types
from typing import NamedTuple, Optional

import pytest
import standin

from kzgbench import byname, callkind, harness, spans

MS = 1_000_000  # ns
READERS = {  # metric -> its value a call on the made-up spans below
    "api.self_ms": 50.0,
    "glue.body_ms": 7.0,
    "glue.msm_ms": 14.0,
    "glue.g1fft_ms": 9.0,
    "glue.ntt_ms": 10.0,
    "glue.inv_ms": 3.0,
    "host_core.ms": 5.0,
    "device.wait_ms": 2.0,
    "glue.inversions": 1.5,
}


class Span(NamedTuple):  # the fields of kzg_tpu_torch.tracing.Span
    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int
    counts: Optional[dict]


def _made_up():
    """Two API calls of 100 ms, and a settings span outside any call."""
    rows = [  # (name, start ms, end ms, parent, call, counts)
        ("kzg.api.blob_to_kzg_commitment_batch", 0, 100, -1, 1, {"field.inversions": 2, "launch.horner": 1}),
        ("kzg.body.commit", 10, 60, 0, 1, None),
        ("kzg.msm.fixed", 20, 50, 1, 1, None),
        ("kzg.msm.scan", 25, 35, 2, 1, None),
        ("kzg.wait", 40, 42, 2, 1, None),
        ("kzg.inv", 52, 58, 1, 1, None),
        ("kzg.native.g1_compress_batch", 70, 80, 0, 1, None),
        ("kzg.api.compute_cells_and_kzg_proofs_batch", 200, 300, -1, 2, {"field.inversions": 1}),
        ("kzg.ntt", 210, 230, 7, 2, None),
        ("kzg.g1fft", 240, 260, 7, 2, None),
        ("kzg.wait", 245, 247, 9, 2, None),
        ("kzg.settings.load", 400, 500, -1, 0, None),
    ]
    return [Span(n, a * MS + 1, b * MS + 1, p, c, k) for n, a, b, p, c, k in rows]


def _program(monkeypatch, recorded):
    monkeypatch.setitem(sys.modules, "kzg_tpu_torch.tracing", types.SimpleNamespace(spans=lambda: list(recorded)))


def test_per_call_values_of_made_up_spans(monkeypatch):
    _program(monkeypatch, _made_up())
    for name, want in READERS.items():
        assert byname.load("metrics", name).read(None) == pytest.approx(want, rel=1e-9), name
    times = {k: v for k, v in READERS.items() if k != "glue.inversions"}
    assert sum(times.values()) == pytest.approx(100.0)  # the families add up to the mean API-call span
    assert spans.per_call_ms("settings") is None  # outside every API call


def test_nothing_without_api_calls_or_without_the_module(monkeypatch):
    _program(monkeypatch, [s for s in _made_up() if s.call == 0])
    assert all(byname.load("metrics", name).read(None) is None for name in READERS)
    monkeypatch.delitem(sys.modules, "kzg_tpu_torch.tracing", raising=False)
    assert all(byname.load("metrics", name).read(None) is None for name in READERS)


def test_a_traced_run_of_the_stand_in_reports_none_of_them(monkeypatch, setup_full):
    """The stand-in calls nothing of the program: its traced run's line
    carries the trace's own metrics and none of the spans' readers."""
    mod = sys.modules.get("kzg_tpu_torch.tracing")
    if mod is not None:
        mod.reset()
    workload = "blobs-verify-block"
    spec = harness.cell_spec(workload)
    traffic = dict(spec[3], warm_calls=0, trace_calls=1, checked_calls=2)
    monkeypatch.setattr(harness, "cell_spec", lambda name: spec[:3] + (traffic,))
    monkeypatch.setattr(
        callkind.FreshBlobs, "prepare", lambda self, s, i: standin.sparse_blobs(random.Random(s * 1000 + i), self.traffic["blobs"])
    )
    line = harness.run_cell(workload, 7, 1.0, True, api=standin.StandIn(setup_full, "none"), device="cpu")
    assert line["correct"] and "device.idle_pct" in line["metrics"]
    assert not set(READERS) & set(line["metrics"])
