"""glue.msm_ms: the MSMs' time a call (ms), the spans kzg.msm.* (digits,
sort, the scan with B1, bucket integration, B3) less the other families
inside them (kzgbench/spans.py; host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("msm")
