"""device.wait_ms: how long the host waits for the card a call (ms), the
spans kzg.wait: reads back and copies from host memory, after each of
which PyTorch synchronizes the stream (kzgbench/spans.py; host clock,
traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_ms("wait")
