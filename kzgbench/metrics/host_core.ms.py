"""host_core.ms: the host core's time a call (ms), the spans
kzg.native.<function>: point decompression and compression, the pairing
check, G1 operations (kzgbench/spans.py; host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("host_core")
