"""kzg_tpu_torch's tracing registry (tracing.py) on the CPU, through the
cheapest API calls that reach its span families: multi-point openings on
the first 16 monomial points of the mainnet setup (MSM, NTT, inversion,
bodies, waits, host core) and one single opening (host core alone); the
G1 FFT, which only the FK20 calls reach, by one small fft_g1 inside a
span of its own. Without a profiler nothing is recorded and no profiler
range is entered; under one, the spans nest, share their call's id,
partition the call's time by family, and are the profiler's own host
events on its clock. The launch registry reads as it did."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kzg_tpu_torch import api, tracing
from kzg_tpu_torch.ops import cuda_fft, cuda_gather, cuda_msm, g1, g1fft, launch  # noqa: F401  (registers every wrapper)
from kzg_tpu_torch.settings import TorchKZGSettings
from kzg_tpu_torch.trusted_setup import TrustedSetup

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

N_POINTS, N = 16, 4
FAMILIES = ("kzg.api.", "kzg.body.", "kzg.msm.", "kzg.g1fft", "kzg.ntt", "kzg.inv", "kzg.native.", "kzg.wait")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    full = api.load_trusted_setup_file(device="cpu").setup
    s = TorchKZGSettings(TrustedSetup(full.g1_monomial[:N_POINTS], [], full.g2_monomial), torch.device("cpu"))
    s.monomial_table  # built outside the traced calls
    yield s
    mp.undo()


def _calls(s):
    """Openings of a 16-coefficient polynomial on a coset of 4, checked
    (against values that are not its own: the check still runs whole), and
    one single opening; then a G1 FFT of 4 points in a span of its own."""
    coeffs = list(range(3, 3 + N_POINTS))
    proof = api.compute_kzg_proof_multi(coeffs, 5, N, s)
    api.verify_kzg_proof_multi(proof, proof, 5, [1, 2, 3, 4], s)
    z = (7).to_bytes(32, "big")
    api.verify_kzg_proof(proof, z, z, proof, s)
    pts = g1.from_affine(g1.affine_from_ints(s.setup.g1_monomial[:N], "cpu"))
    with tracing.span("kzg.api.fft_g1"):
        g1fft.fft_g1(pts)


def _family(name):
    return next((f for f in FAMILIES if name.startswith(f)), "other")


def test_nothing_recorded_without_a_profiler(small, monkeypatch):
    entered = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast", lambda name: entered.append(name))
    tracing.reset()
    _calls(small)
    assert tracing.spans() == [] and entered == []
    assert tracing.counters()["field.inversions"] == 3  # counters are always on


@pytest.fixture(scope="module")
def traced(small):
    """The calls once under a CPU profiler: (spans, the kzg.* events)."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _calls(small)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("kzg.")]
    return tracing.spans(), events


def test_spans_nest_share_their_call_and_partition_it(traced):
    spans = traced[0]
    roots = [s for s in spans if s.counts is not None]
    assert [s.name for s in roots] == [
        "kzg.api.compute_kzg_proof_multi", "kzg.api.verify_kzg_proof_multi", "kzg.api.verify_kzg_proof", "kzg.api.fft_g1"
    ]
    assert len({s.call for s in roots}) == 4 and all(s.parent == -1 and s.call for s in roots)
    assert [s.counts.get("field.inversions", 0) for s in roots] == [2, 1, 0, 0]
    children = [0] * len(spans)
    for s in spans:
        assert s.name.startswith("kzg.") and s.end_ns >= s.start_ns > 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.call == s.call and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            children[s.parent] += s.end_ns - s.start_ns
    by_family = {}
    for i, s in enumerate(spans):
        by_family[_family(s.name)] = by_family.get(_family(s.name), 0) + s.end_ns - s.start_ns - children[i]
    assert set(by_family) == set(FAMILIES)
    total = sum(s.end_ns - s.start_ns for s in roots)
    assert abs(sum(by_family.values()) - total) <= 0.01 * total


def test_spans_are_profiler_host_events_on_its_clock(traced):
    events, spans = {}, {}
    for e in traced[1]:
        events.setdefault(e.name(), []).append(e)
    for s in traced[0]:
        spans.setdefault(s.name, []).append(s)
    assert set(events) == set(spans)
    for name, recs in spans.items():
        evs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(evs) == len(recs)
        for s, e in zip(recs, evs):
            assert not e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU
            assert e.start_ns() <= s.end_ns and s.start_ns <= e.start_ns() + e.duration_ns()
            assert abs(e.start_ns() - s.start_ns) < 1_000_000


def test_launch_registry_reads_as_before():
    assert launch.counted is tracing.counted and launch.launches is tracing.launches
    assert launch.reset_launches is tracing.reset_launches
    tracing.count("field.inversions")
    launch.reset_launches()
    assert launch.launches() == {"seg_scan_phase1": 0, "add_unified": 0, "horner": 0, "integrate": 0, "ntt_tile": 0, "ntt_stage": 0, "gather_rows": 0, "field_inv": 0, "g1_ladder": 0}
    tracing.count("launch.horner", 2)
    assert launch.launches()["horner"] == 2 and tracing.counters()["field.inversions"] >= 1
    launch.reset_launches()
    assert launch.launches()["horner"] == 0 and tracing.counters()["field.inversions"] >= 1
