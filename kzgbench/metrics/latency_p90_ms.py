"""latency_p90_ms: the nearest-rank 90th percentile of the walls of every
call completed inside the window (host clock, each wall ending in the
call's bytes or boolean on the host)."""

from kzgbench.stats import nearest_rank


def read(run):
    return nearest_rank(run.walls, 90) * 1e3 if run.walls else None
