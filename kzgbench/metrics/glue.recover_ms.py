"""glue.recover_ms: the recovery body's own time a call (ms), the spans
kzg.body.recover and kzg.body.vanish less their direct children (the NTTs,
the inversion and the waits inside them), over the traced calls, divided
by the API calls: the self-time rule of kzgbench/spans.py, for two span
names rather than a family. Nothing where no such span ran."""

from collections import defaultdict

from kzgbench import spans

NAMES = ("kzg.body.recover", "kzg.body.vanish")


def read(run):
    recorded = spans.recorded() or []
    calls = [s for s in recorded if s.counts is not None and s.end_ns > 0]
    inside = [(i, s) for i, s in enumerate(recorded) if s.call and s.end_ns > 0]
    children = defaultdict(int)
    for _, s in inside:
        if s.parent >= 0:
            children[s.parent] += s.end_ns - s.start_ns
    own = [s.end_ns - s.start_ns - children[i] for i, s in inside if s.name in NAMES]
    if not calls or not own:
        return None
    return sum(own) / len(calls) / 1e6
