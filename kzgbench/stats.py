"""The harness's arithmetic: the window's mean latency, the nearest-rank
percentile, the union of device intervals and the gaps between them."""

import math


def window_mean_ms(window_start: float, ends: list) -> float:
    """The window's length from its start to the end of its last completed
    call, over the number of completed calls (host seconds in, ms out)."""
    if not ends:
        raise ValueError("no call completed inside the window")
    return (max(ends) - window_start) / len(ends) * 1e3


def nearest_rank(values: list, pct: float) -> float:
    """The nearest-rank percentile: the smallest value with at least pct%
    of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(pct / 100 * len(ordered))) - 1]


def union(intervals: list) -> list:
    """Merged (start, end) intervals, sorted, none overlapping or touching."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def gaps(merged: list, start: float, end: float) -> list:
    """The idle gaps of [start, end] outside the merged intervals."""
    out, t = [], start
    for a, b in merged:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]

