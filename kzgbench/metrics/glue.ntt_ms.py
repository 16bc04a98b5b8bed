"""glue.ntt_ms: the Fr NTTs' time a call (ms), the spans kzg.ntt (B4, B5
and their glue) less the other families inside them (kzgbench/spans.py;
host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("ntt")
