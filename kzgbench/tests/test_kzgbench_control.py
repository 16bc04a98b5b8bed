"""The control on the card: a run of each cell at its own size with the
program's guarantee broken (standin.Control: producers read each blob's
elements in natural rather than bit-reversed order, verifiers accept
without the pairing) must come out not correct, on every seed. It prints
each seed's compared numbers: the upper readings of PERF.md's limits.

    python3 -m pytest -m gpu kzgbench/tests/test_kzgbench_control.py -q -s

KZGBENCH_CONTROL_SEEDS (comma-separated, default three) and
KZGBENCH_CONTROL_SECONDS (the window, default 12) set the runs."""

import json
import os

import pytest
import standin

from kzgbench import harness

CELLS = ("cells-produce-block", "blobs-commit-prove", "cells-verify-column", "blobs-verify-block")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    for var, rel in harness.CACHE_DIRS.items():
        os.environ[var] = os.path.join(harness.ROOT, rel)
    from kzg_tpu_torch import api

    seeds = [int(s) for s in os.environ.get("KZGBENCH_CONTROL_SEEDS", "2147483901,2147483902,2147483903").split(",")]
    seconds = float(os.environ.get("KZGBENCH_CONTROL_SECONDS", "12"))
    for seed in seeds:
        line = harness.run_cell(workload, seed, seconds, False, api=standin.Control(api))
        readings = {k: v["value"] for k, v in line["checks"].items()}
        print(json.dumps({"control": workload, "seed": seed, "attempted": line["attempted"], "checks": readings}))
        assert not line["correct"]
        assert any(v > 0 for k, v in readings.items() if k != "calls_failed")
