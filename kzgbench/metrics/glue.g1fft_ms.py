"""glue.g1fft_ms: the G1 FFTs' and FK20 ladders' time a call (ms), the
spans kzg.g1fft less the other families inside them (kzgbench/spans.py;
host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("g1fft")
