"""glue.small_msms: variable-base MSM rows of fewer than 8 points a call,
the program's counter msm.small over each API call (kzgbench/spans.py;
traced calls). Nothing where no traced call moved the counter (a program
without it)."""

from kzgbench import spans

COUNTER = "msm.small"


def read(run):
    recorded = spans.recorded() or []
    if not any(s.counts is not None and COUNTER in s.counts for s in recorded):
        return None
    return spans.per_call_count(COUNTER, recorded)
