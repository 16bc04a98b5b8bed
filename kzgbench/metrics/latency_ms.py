"""latency_ms: the window's length from its start to the end of its last
completed call, over the number of completed calls (host clock)."""

from kzgbench.stats import window_mean_ms


def read(run):
    return window_mean_ms(run.window_start, run.ends) if run.ends else None
