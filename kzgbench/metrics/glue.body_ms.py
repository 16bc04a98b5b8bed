"""glue.body_ms: the protocol bodies' own time a call (ms), the spans
kzg.body.* less their children: the plain PyTorch field arithmetic of the
bodies (and to_affine's) outside the MSMs, G1 FFTs, NTTs and inversions
(kzgbench/spans.py; host clock, traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("body")
