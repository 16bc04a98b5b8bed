"""The port's multi-process launcher (kzg_tpu_torch.parallel.dryrun.launch)
with a single rank that fails: the parent must raise RuntimeError with the
rank's traceback, also when that rank is the last one to exit (the
scaling bench's 1-rank run)."""

import multiprocessing

import pytest
import torch

from kzg_tpu_torch.parallel import dryrun

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once; the rank pins its own


def test_a_single_failing_rank_fails_the_launch(tmp_path):
    """This file's one spawn: the rank's program, int("cpu"), raises."""
    with pytest.raises(RuntimeError, match=r"ranks \[0\] failed(.|\n)*invalid literal for int"):
        dryrun.launch(int, 1, "cpu", out_dir=str(tmp_path), timeout=60)
    assert (tmp_path / "rank0.err").exists()
    assert not multiprocessing.active_children()
