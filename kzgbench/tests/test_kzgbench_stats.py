"""The harness's arithmetic on synthetic values: the window mean, the
nearest-rank p90, the union of device intervals, the idle gaps and their
naming by the host op active in each."""

import pytest

from kzgbench import stats
from kzgbench.trace import NO_OP, _name_gaps


def test_window_mean():
    # calls end at 1.0, 2.5 and 4.0 s after a window start at 0.5 s
    assert stats.window_mean_ms(0.5, [1.0, 2.5, 4.0]) == pytest.approx(3.5 / 3 * 1e3)
    with pytest.raises(ValueError):
        stats.window_mean_ms(0.0, [])


@pytest.mark.parametrize(
    "values, expected",
    [
        (list(range(1, 11)), 9),  # ceil(0.9 * 10) = 9th value
        (list(range(1, 12)), 10),  # ceil(9.9) = 10th
        ([5.0], 5.0),
        ([3, 1, 2], 3),  # ceil(2.7) = 3rd
        (list(range(1, 21)), 18),
    ],
)
def test_nearest_rank_p90(values, expected):
    assert stats.nearest_rank(values, 90) == expected


def test_union_and_gaps():
    merged = stats.union([(5, 7), (0, 2), (1, 3), (3, 4), (10, 12)])
    assert merged == [(0, 4), (5, 7), (10, 12)]
    assert stats.gaps(merged, -1, 13) == [(-1, 0), (4, 5), (7, 10), (12, 13)]
    assert stats.gaps(merged, 1, 6) == [(4, 5)]


def test_gap_naming():
    # host: outer [0, 100] holding inner ops [10, 20] and [30, 60]
    host = [("outer", 0, 100), ("aten::mul", 10, 20), ("aten::add", 30, 60)]
    gaps = [(12, 14), (40, 50), (70, 80), (200, 210)]
    named = _name_gaps(gaps, list(host))
    assert named == pytest.approx({"aten::mul": 2e-9, "aten::add": 10e-9, "outer": 10e-9, NO_OP: 10e-9})


def test_idle_share_against_the_unprofiled_calls():
    from kzgbench import byname
    from kzgbench.harness import Run
    from kzgbench.trace import Trace

    idle = byname.load("metrics", "device.idle_pct").read
    # 4 calls in 4 s of window: 1 s a call; 2 traced calls kept the device busy 0.5 s
    run = Run(window_start=10.0, ends=[11.0, 12.0, 13.0, 14.0], walls=[1.0] * 4)
    assert idle(run) is None
    run.trace = Trace(calls=2, wall_s=5.0, kernels=7, kernel_s=0.5, busy_s=0.5)
    assert idle(run) == pytest.approx(75.0)  # not 90%, as over the profiled 5 s
    run.ends = []
    assert idle(run) is None
