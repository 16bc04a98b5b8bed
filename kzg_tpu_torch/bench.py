"""Headline benchmark of the port: the fixed-base MSM over 4096 points (the
MSM inside every blob commitment and proof) on one card. The counterpart
of the JAX package's bench.py.

    python3 -m kzg_tpu_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, the
metric g1_msm_fixed_4096_points_per_sec_per_chip in points/s, and
vs_baseline against blst on one core (g1_lincomb(4096) in 54.6 ms,
BASELINE.md). Diagnostics go to stderr: the card's name and power limit,
the setup and table time, the first call (with the kernel build) on its
own, and ms per batch. Env: BENCH_BATCH (MSMs per call, default 8) and
BENCH_ITERS (calls, default 10). Without a card it exits non-zero.

Every call gets its own seeded canonical scalars (numpy, seed 42), moved
to the card before the timed window. The calls are dispatched back to
back and fenced by one torch.cuda.synchronize(). Before timing, row 0 of
the first call's result is held, in affine, against an independent sum of
n native scalar multiplications and additions; the run fails if they
differ.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from . import native
from .benches import common
from .ops import g1 as dg1
from .ops import msm as dmsm
from .ops.field import limbs_to_ints

BLST_1CORE_PTS_PER_S = 4096 / 54.6e-3  # about 75,018 (BASELINE.md)
METRIC = "g1_msm_fixed_4096_points_per_sec_per_chip"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def make_inputs(n: int, batch: int, iters: int, device, seed: int = 42) -> list:
    """`iters` distinct scalar sets, each (16, batch, n) canonical Fr limbs
    on `device` ((16, n) when batch is 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(iters):
        sc = common.random_scalars(rng, batch * n).reshape(16, batch, n)
        out.append(torch.from_numpy(sc if batch > 1 else sc[:, 0]).to(device))
    return out


def native_msm(points, scalars) -> tuple:
    """sum_i scalars[i] * points[i] through the native core, one scalar
    multiplication and one addition per point."""
    acc = None
    for p, k in zip(points, scalars):
        acc = native.g1_add(acc, native.g1_mul(p, k))
    return acc


def check_row0(out: dg1.G1XYZZ, points, scalars: torch.Tensor) -> None:
    """Row 0 of an msm_fixed result, in affine, against native_msm; raises
    on a difference."""
    row0 = dg1.map_coords(lambda c: c.reshape(c.shape[0], -1)[:, :1], out)
    got = dg1.xyzz_to_ints(row0)[0]
    sc = scalars.reshape(16, -1, scalars.shape[-1])[:, 0].cpu().numpy()
    want = native_msm(points, limbs_to_ints(sc))
    if got != want:
        raise RuntimeError(f"msm_fixed row 0 differs from the native sum: {got} != {want}")


def measure(table: dmsm.FixedBaseTable, points, batch: int, iters: int, seed: int = 42) -> dict:
    """The headline run on `table` (over the affine `points`): the first
    call and its native check, then `iters` calls dispatched back to back
    and one synchronize. Returns the points/s and the times."""
    n = table.n
    dev = table.x.device
    inputs = make_inputs(n, batch, iters, dev, seed)
    first_out, first_s = common.wall_s(lambda: dmsm.msm_fixed(table, inputs[0]))
    log(f"first call (with the kernel build): {first_s:.2f} s")
    t0 = time.perf_counter()
    check_row0(first_out, points, inputs[0])
    log(f"native check of row 0 ({n} scalar multiplications): equal ({time.perf_counter() - t0:.1f} s)")
    _, secs = common.wall_s(lambda: [dmsm.msm_fixed(table, x) for x in inputs])
    dt = secs / iters
    pts_per_s = n * batch / dt
    log(f"msm_fixed n={n} batch={batch}: {dt * 1e3:.2f} ms per batch ({pts_per_s / 1e3:.0f}k pts/s)")
    return {"pts_per_s": pts_per_s, "ms_per_batch": dt * 1e3, "first_s": first_s}


def result_line(pts_per_s: float) -> dict:
    return {
        "metric": METRIC,
        "value": round(pts_per_s, 1),
        "unit": "points/s",
        "vs_baseline": round(pts_per_s / BLST_1CORE_PTS_PER_S, 3),
    }


def main() -> int:
    if not common.require_card("bench"):
        return 2
    from . import api

    log(f"card: {common.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    t0 = time.perf_counter()
    s = api.load_trusted_setup_file()
    table, _ = common.wall_s(lambda: s.lagrange_table)
    log(f"setup + table: {time.perf_counter() - t0:.1f} s (c={table.c})")
    r = measure(table, s.setup.g1_lagrange_brp, batch, iters)
    print(json.dumps(result_line(r["pts_per_s"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
