"""api.self_ms: the API layer's own time a call (ms), the spans
kzg.api.<function> less their children: argument checks, the Fiat-Shamir
challenges, bytes to limbs and back, deduplication, on the host
(kzgbench/spans.py; host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("api")
