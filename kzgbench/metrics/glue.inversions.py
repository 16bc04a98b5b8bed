"""glue.inversions: Fermat inversions a call, the program's counter
field.inversions over each API call (kzgbench/spans.py; traced calls)."""

from kzgbench import spans


def read(run):
    return spans.per_call_count("field.inversions")
