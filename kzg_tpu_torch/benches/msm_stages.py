"""Stage split of the port's fixed-base MSM over the mainnet Lagrange table
(4096 points, c = 13, 20 windows) on one card. The counterpart of the JAX
package's benches/msm_stages.py.

    python3 -m kzg_tpu_torch.benches.msm_stages [batch ...] [--iters N]

(default: batches 8 and 64, 5 iterations). msm_fixed runs as its pieces,
in its own order, on distinct seeded scalars per iteration:

  keys          digits, sort keys, packed rows, source rows (_fixed_keys)
  sort          the stable sort of the keys and the row index in sorted
                order, alone
  layout        the chunk layout of the sorted run (_chunk_layout)
  gather        beside the MSM, not part of it: kernel B6 on the sorted row
                indices, 25-word rows. B1 gathers its own rows, so this
                says what the gather alone costs at B1's shape
  scan+buckets  _bucket_sums_mem: B1, B2 and the plain glue
  integrate     bucket integration (_fixed_result)

digits+sort is keys + sort + layout, the JAX script's first stage. Each
stage reports its device ms (CUDA events recorded between the pieces in a
pass with no synchronize: eager PyTorch fuses nothing across them, so no
prefix differences are needed), its wall ms (a second pass, with a
synchronize before and after each piece) and the hand-written kernels'
launches. Then one whole msm_fixed call's device time on the same inputs,
beside the sum of the MSM's stages (all but the gather). Medians over the
iterations. Prints the card's name and power limit and one JSON line per
batch. Without a card it exits non-zero.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import cuda_gather, launch
from ..ops import msm as dmsm
from . import common

STAGES = ("keys", "sort", "layout", "gather", "scan+buckets", "integrate")
MSM_STAGES = ("keys", "sort", "layout", "scan+buckets", "integrate")


def run_pieces(table: dmsm.FixedBaseTable, scalars: torch.Tensor, mark, flag=None):
    """One msm_fixed in its pieces, calling mark(stage) after each (and
    mark(None) before the first). Returns (the XYZZ result, the gathered
    rows)."""
    mark(None)
    keys, aug, rows, n_keys, nb, batch = dmsm._fixed_keys(table, scalars)
    mark("keys")
    sorted_keys, order = torch.sort(keys, stable=True)
    src = aug[order]
    mark("sort")
    lay = dmsm._chunk_layout(sorted_keys, src)
    mark("layout")
    gathered = cuda_gather.gather_rows(rows, lay.idx.reshape(-1), flag)
    mark("gather")
    sums = dmsm._bucket_sums_mem(rows, lay, n_keys)
    mark("scan+buckets")
    out = dmsm._fixed_result(sums, nb, batch)
    mark("integrate")
    return out, gathered


class _Marks:
    """Per-stage readings of one pass: launches always; with `sync`, the
    host clock between synchronizes; with `events`, a CUDA event."""

    def __init__(self, sync: bool, events: bool):
        self.sync, self.events = sync, events
        self.points = []  # (stage, host seconds, event, launches)

    def __call__(self, stage):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        ev = None
        if self.events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self.points.append((stage, time.perf_counter(), ev, launch.launches()))

    def per_stage(self) -> dict:
        out = {}
        for (_, t0, e0, l0), (stage, t1, e1, l1) in zip(self.points, self.points[1:]):
            row = {"host_ms": (t1 - t0) * 1e3, "launches": {k: v - l0[k] for k, v in l1.items() if v - l0[k]}}
            if self.events:
                row["device_ms"] = e0.elapsed_time(e1)
            out[stage] = row
        return out


def stage_split(table: dmsm.FixedBaseTable, inputs: list) -> dict:
    """The split over `inputs` (scalar sets on the table's device). On the
    card: device ms (events pass), wall ms (synchronized pass), launches
    and the whole call's device ms, medians over the inputs. On the CPU
    (tests only): the host clock ("host_ms"), which is no device time.
    Also returns the last pass's result and gathered rows."""
    on_card = table.x.device.type == "cuda"
    dev_passes, wall_passes, whole = [], [], []
    for x in inputs:
        flag = cuda_gather.new_flag(table.x.device)
        if on_card:
            m = _Marks(sync=False, events=True)
            run_pieces(table, x, m, flag)
            torch.cuda.synchronize()
            cuda_gather.raise_if_flagged(flag)
            dev_passes.append(m.per_stage())
        m = _Marks(sync=True, events=False)
        result = run_pieces(table, x, m, flag)
        cuda_gather.raise_if_flagged(flag)
        wall_passes.append(m.per_stage())
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dmsm.msm_fixed(table, x)
            end.record()
            torch.cuda.synchronize()
            whole.append(start.elapsed_time(end))
    stages = {}
    for st in STAGES:
        row = {"launches": wall_passes[-1][st]["launches"]}
        if on_card:
            row["device_ms"] = float(np.median([p[st]["device_ms"] for p in dev_passes]))
            row["wall_ms"] = float(np.median([p[st]["host_ms"] for p in wall_passes]))
        else:
            row["host_ms"] = float(np.median([p[st]["host_ms"] for p in wall_passes]))
        stages[st] = row
    key = "device_ms" if on_card else "host_ms"
    digits_sort = sum(stages[st][key] for st in ("keys", "sort", "layout"))
    out = {"stages": stages, "digits+sort_" + key: digits_sort,
           "msm_stages_sum_" + key: sum(stages[st][key] for st in MSM_STAGES)}
    if on_card:
        out["whole_device_ms"] = float(np.median(whole))
        out["sum_over_whole"] = out["msm_stages_sum_device_ms"] / out["whole_device_ms"]
    out["result"], out["gathered"] = result
    return out


def report(batch: int, split: dict, card: str) -> dict:
    """Print the split as a table; return its JSON form (without tensors)."""
    key = "device_ms" if "whole_device_ms" in split else "host_ms"
    print(f"msm_fixed stage split, batch {batch} [{card}]")
    for st, row in split["stages"].items():
        wall = f"  wall {row['wall_ms']:9.3f} ms" if "wall_ms" in row else ""
        print(f"  {st:>13}: {row[key]:9.3f} ms {key[:-3]}{wall}  launches {row['launches']}")
    print(f"  {'digits+sort':>13}: {split['digits+sort_' + key]:9.3f} ms {key[:-3]}")
    if "whole_device_ms" in split:
        print(f"  MSM stages sum {split['msm_stages_sum_device_ms']:.3f} ms device, one whole msm_fixed "
              f"{split['whole_device_ms']:.3f} ms device (ratio {split['sum_over_whole']:.3f})")
    return {"batch": batch, "card": card, **{k: v for k, v in split.items() if k not in ("result", "gathered")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batches", nargs="*", type=int, default=[8, 64])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not common.require_card("msm_stages"):
        return 2
    from .. import api

    card = common.card_line()
    s = api.load_trusted_setup_file(common.SETUP_PATH)
    table, secs = common.wall_s(lambda: s.lagrange_table)
    print(f"card: {card}; table c={table.c} ({secs:.1f} s)")
    rng = np.random.default_rng(42)
    for batch in args.batches:
        n = table.n
        inputs = [torch.from_numpy(common.random_scalars(rng, batch * n).reshape(16, batch, n)).to(table.x.device)
                  for _ in range(args.iters)]
        stage_split(table, inputs[:1])  # warm: kernel build, allocator
        print(json.dumps(report(batch, stage_split(table, inputs), card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
