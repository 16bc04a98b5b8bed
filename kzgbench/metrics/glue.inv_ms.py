"""glue.inv_ms: the Fermat inversions' time a call (ms), the spans kzg.inv
less the waits inside them (kzgbench/spans.py; host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("inv")
