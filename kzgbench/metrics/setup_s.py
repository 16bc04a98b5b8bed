"""setup_s: from the process's start to the start of the first timed call,
less the time the benchmark spent making its own inputs (the reference's
pool and cells, the seeded blobs): imports, the CUDA context, the kernels
and the host core (built on the first run in a checkout), the settings and
the cell's tables (from the checkout's cache after the first run) and the
warm calls."""


def read(run):
    return run.setup_s
