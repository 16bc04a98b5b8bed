"""device.idle_pct: 100 x (1 - the union of the device's intervals in the
traced calls over the same number of calls' time unprofiled, the window's
mean latency). The profiler slows the host two- to threefold a launch, so
the traced calls' own wall would count its cost as idle time; the
device's intervals it leaves as they are."""

from kzgbench.stats import window_mean_ms


def read(run):
    t = run.trace
    if t is None or not t.calls or not run.ends:
        return None
    return 100.0 * (1.0 - t.busy_s / (t.calls * window_mean_ms(run.window_start, run.ends) / 1e3))
