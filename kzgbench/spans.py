"""The program's own spans and counters (`kzg_tpu_torch/tracing.py`),
reduced per API call, for the readers of the per-layer metrics that time
the program's layers from inside.

The spans are read from the program's tracing module where this process
has loaded it; it records them only under torch.profiler, so in a run
they are the traced calls'. A program without that module, or one that
recorded no API call (the tests' stand-in), gives nothing.

A span's family follows from its name. Its self time is its length less
that of its direct children, so over the spans of an API call the
families' self times add up to the call's own span; a family's value is
its self time over the traced calls, divided by the number of API calls.
"""

import sys
from collections import defaultdict

FAMILIES = (  # (family, span name prefixes)
    ("api", ("kzg.api.",)),
    ("body", ("kzg.body.",)),
    ("msm", ("kzg.msm.",)),
    ("g1fft", ("kzg.g1fft",)),
    ("ntt", ("kzg.ntt",)),
    ("inv", ("kzg.inv",)),
    ("host_core", ("kzg.native.",)),
    ("wait", ("kzg.wait",)),
    ("settings", ("kzg.settings.", "kzg.table.")),
)


def family(name: str) -> str:
    for fam, prefixes in FAMILIES:
        if name.startswith(prefixes):
            return fam
    return "other"


def recorded():
    """The program's spans, or None where its tracing module is not loaded."""
    mod = sys.modules.get("kzg_tpu_torch.tracing")
    return None if mod is None else mod.spans()


def _calls(spans) -> list:
    """The API-call spans: the closed ones that carry counts."""
    return [s for s in spans if s.counts is not None and s.end_ns > 0]


def self_ns(spans) -> dict:
    """Self time (ns) of each family over the spans inside API calls."""
    inside = [(i, s) for i, s in enumerate(spans) if s.call and s.end_ns > 0]
    children = defaultdict(int)
    for _, s in inside:
        if s.parent >= 0:
            children[s.parent] += s.end_ns - s.start_ns
    totals = defaultdict(int)
    for i, s in inside:
        totals[family(s.name)] += s.end_ns - s.start_ns - children[i]
    return dict(totals)


def per_call_ms(fam: str, spans=None):
    """A family's self time a call (ms); None without API calls or where
    no span of the family ran."""
    spans = recorded() if spans is None else spans
    calls = _calls(spans or [])
    totals = self_ns(spans) if calls else {}
    return totals[fam] / len(calls) / 1e6 if fam in totals else None


def per_call_count(counter: str, spans=None):
    """A counter's change a call; None without API calls."""
    spans = recorded() if spans is None else spans
    calls = _calls(spans or [])
    return sum(s.counts.get(counter, 0) for s in calls) / len(calls) if calls else None
