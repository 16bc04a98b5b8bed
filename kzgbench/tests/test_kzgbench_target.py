"""The cell cells-verify-column-target: its traffic's inputs, the reader
of glue.small_msms and its work file, held as the other cells' are."""

import sys

import test_kzgbench_inputs as inputs
import test_kzgbench_spans as spans_tests

from kzgbench import byname
from kzgbench import workcount as W

NAME = "cells-verify-column-target"
ROOT = W.os.path.dirname(W.os.path.dirname(W.__file__))


def test_inputs_fixed_by_seed():
    inputs.test_inputs_fixed_by_seed(NAME)


def test_inputs_six_distinct_blobs_valid_and_invalid_as_built(setup64):
    """6 distinct pool blobs a call, and the reference's verdicts follow
    invalid_share."""
    assert inputs.kind_of(NAME).traffic["blobs"] == 6
    inputs.test_verify_inputs_valid_and_invalid_as_built(NAME, setup64)


def test_small_msms_only_where_a_call_moved_the_counter(monkeypatch):
    """glue.small_msms is msm.small a call where the recording has the
    counter, and nothing on a program without it (one that predates the
    counter) or without a tracing module."""
    reader = byname.load("metrics", "glue.small_msms")
    spans_tests._program(monkeypatch, spans_tests._made_up())
    assert reader.read(None) is None
    moved = [
        s._replace(counts={**s.counts, "msm.small": 3}) if s.call == 1 and s.counts is not None else s
        for s in spans_tests._made_up()
    ]
    spans_tests._program(monkeypatch, moved)
    assert reader.read(None) == 1.5
    monkeypatch.delitem(sys.modules, "kzg_tpu_torch.tracing")
    assert reader.read(None) is None


def test_work_file_counted_like_the_others():
    """A column of 6 blobs against one of 9: 3 x 66 fewer Fr products
    (a weight, a cell's 64 products and a shifted weight a blob) and, in
    each of the 3 variable-base MSMs at c = 3 (86 windows), 3 x 86 fewer
    mixed additions; nothing else differs."""
    assert W.load(ROOT, NAME) > 0
    fewer = 3 * 66 * W.FR_PRODUCT_MADDS + 3 * 86 * 3 * W.MADD * W.FP_PRODUCT_MADDS
    assert W.load(ROOT, "cells-verify-column") - W.load(ROOT, NAME) == fewer
