"""kernels_roofline: the least time of the traced calls' counted work
(work/<traffic>.json at the card's 32-bit multiply-add rate, peaks.json)
over the summed time of every device kernel in those calls. Nothing where
the traffic has no work file, the card no peak or the trace no kernel."""


def read(run):
    t = run.trace
    if t is None or not run.work_madds or not run.peak_madds_per_s or t.kernel_s <= 0:
        return None
    return 100.0 * run.work_madds * t.calls / run.peak_madds_per_s / t.kernel_s
