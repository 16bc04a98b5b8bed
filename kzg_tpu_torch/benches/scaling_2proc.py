"""Weak scaling of the sharded fixed-base MSM over processes: the
counterpart of the JAX package's benches/scaling_2proc.py.

    python3 -m kzg_tpu_torch.benches.scaling_2proc

Each rank holds a fixed load, B_LOCAL MSMs of the mainnet setup's 4096
bit-reversed Lagrange points (c = 13, 20 windows), on a (ranks, 1) blobs x
points mesh (parallel/distributed.global_mesh), so perfect weak scaling
keeps the step time of 2 ranks at that of 1: efficiency = t_1 / t_2. A step
is one msm_fixed_sharded call (the MSMs of the rank's blobs and the
all_gather of their results), ended by a synchronize. A run times as many
steps as fill WINDOW_S seconds at the slowest rank's pace of a warm step
(the same count on every rank: each step is a collective); its step time
is the slowest rank's mean. RUNS runs of 1 rank and of 2 alternate, and
the line gives the median of each and every reading.

The ranks run under gloo, on one card (cuda:0) when the machine has one:
they share it, and its host's cores. Ranks on cards of their own (NCCL)
share neither, so the efficiency bounds theirs from below only up to the
spread of the readings. Rank 0 holds the last step's results, in affine
form, against msm_fixed of the whole batch in one process. Prints one JSON
line, with the card's name and power limit. Without a card it exits
non-zero.
"""

import json
import math
import statistics
import sys
import time

import torch
import torch.distributed as dist

B_LOCAL = 8  # MSMs a rank: the headline bench's batch
WINDOW_S = 5.0  # seconds of steps a run times
RUNS = 3  # runs of 1 rank and of 2, alternated
SEED = 42


def _rank(device: str, b_local: int, window_s: float) -> dict:
    from .. import api, bench
    from ..ops import g1, launch, msm
    from ..parallel.distributed import global_mesh
    from ..parallel.sharded_msm import msm_fixed_sharded

    world = dist.get_world_size()
    mesh = global_mesh(world)  # (world, 1): the batch over the ranks, the points whole on each
    s = api.load_trusted_setup_file(device=device)
    table = s.lagrange_table  # read from the cache the parent filled
    scalars = bench.make_inputs(4096, b_local * world, 1, device, seed=SEED)[0]  # (16, B, 4096)
    msm_fixed_sharded(table, scalars, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msm_fixed_sharded(table, scalars, mesh)
    torch.cuda.synchronize()
    warm = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
    dist.all_reduce(warm, op=dist.ReduceOp.MAX)  # the slowest rank's pace sets every rank's count
    steps = max(2, math.ceil(window_s / warm.item()))
    dist.barrier()
    launch.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = msm_fixed_sharded(table, scalars, mesh)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts, peak = launch.launches(), torch.cuda.max_memory_allocated()
    if dist.get_rank() == 0 and g1.xyzz_to_ints(out) != g1.xyzz_to_ints(msm.msm_fixed(table, scalars)):
        raise AssertionError("msm_fixed_sharded differs from msm_fixed")
    return {"step_ms": step_ms, "steps": steps, "launches": {k: v // steps for k, v in counts.items()},
            "peak_bytes": peak}


def main() -> int:
    from .. import api, settings
    from ..parallel.dryrun import launch
    from .common import card_line, require_card

    if not require_card("scaling_2proc"):
        return 2
    card = card_line()
    device = str(settings.resolve_device(None))
    api.load_trusted_setup_file(device=device).lagrange_table  # fills the table cache the ranks read
    readings = {1: [], 2: []}
    for _ in range(RUNS):
        for world in (1, 2):
            t0 = time.perf_counter()
            ranks = launch(_rank, world, device, (B_LOCAL, WINDOW_S), timeout=900)
            readings[world].append(max(r["step_ms"] for r in ranks))
            for r, res in enumerate(ranks):
                print(f"{world} rank(s), rank {r}: step {res['step_ms']:.3f} ms over {res['steps']} steps; launches a "
                      f"step {res['launches']}; peak device memory {res['peak_bytes'] / 2**30:.2f} GiB [{card}]",
                      file=sys.stderr)
            print(f"{world} rank(s): {time.perf_counter() - t0:.1f} s with start-up", file=sys.stderr)
    t1, t2 = statistics.median(readings[1]), statistics.median(readings[2])
    print(json.dumps({
        "msm_fixed_sharded_step_ms_1proc": t1,
        "msm_fixed_sharded_step_ms_2proc": t2,
        "weak_scaling_efficiency": t1 / t2,
        "readings_ms": {"1proc": readings[1], "2proc": readings[2]},
        "window_s": WINDOW_S,
        "msms_per_rank": B_LOCAL,
        "points": 4096,
        "backend": "gloo",
        "device": {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "card": card},
        "note": "the step times are medians of alternating runs; both ranks of a 2-rank run share one card and its "
                "host under gloo, so the efficiency bounds that of ranks on cards of their own from below only up "
                "to the spread of the readings",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
