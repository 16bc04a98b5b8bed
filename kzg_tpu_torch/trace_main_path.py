"""Where the time of the main paths goes, on one card.

    python -m kzg_tpu_torch.trace_main_path [legacy]

Loads the mainnet setup on the card and its tables, runs one warm commit
and prove of 64 seeded random blobs, one warm EIP-7594 cells-and-proofs
call of 16 of them, one warm recovery of the first of them from its even
cells (50%), and one warm verification of each kind (all 2048 cells of the
16 blobs, the 64 blobs; as chip_smoke.py), then traces one more of each,
and a verification of 8 columns of the 16 blobs, with torch.profiler (CPU
and CUDA activities) and prints, per call:
the wall time, the summed time of device kernels and its share of the
wall time (the rest is the device idle), the peak device memory, each
hand-written kernel's time and launches, and the device kernels that take
the most time. Then it runs each verification once more under cProfile
and prints the package's host functions that take the most time. Last,
the legacy FK20 calls of chip_smoke.py (multi at n2 = 8192 with
chunk_len 64 and 16, single at n2 = 1024, over blob 0's monomial
coefficients), their settings built and each run once before it is
traced; with the argument `legacy`, only those. Exits non-zero without a
card.
"""

import os
import sys
import time

import numpy as np
import torch

from . import api
from .ops import launch

_OURS = ("seg_scan_phase1_kernel", "add_unified_kernel", "horner_kernel", "ntt_tile_kernel", "ntt_stage_kernel")
N_BLOBS = 64
N_CELL_BLOBS = 16
N_SAMPLE_COLUMNS = 8  # a sampling node's columns, as chip_smoke.py
SEED = 4844


def _blobs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
        a[:, 0] &= 0x3F  # below r
        out.append(a.tobytes())
    return out


def _trace(label: str, fn) -> None:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    ours = {k: [0, 0.0] for k in _OURS}
    for name, (n, t) in by_name.items():
        for k in _OURS:
            if k in name:
                ours[k][0] += n
                ours[k][1] += t
    ours_us = sum(t for _, t in ours.values())
    print(f"{label}: wall {wall * 1e3:.1f} ms; device kernels {len(events)} launches, "
          f"{busy_us / 1e3:.1f} ms busy ({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall, "
          f"idle {100 - 100 * busy_us / 1e3 / (wall * 1e3):.1f}%); hand-written kernels {ours_us / 1e3:.2f} ms; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k, (n, t) in ours.items():
        if n:
            print(f"  hand-written {k}: {n} launches, {t / 1e3:.3f} ms")
    if not events:
        print(f"{label}: the profiler recorded no device time (not measured)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t / 1e3:9.2f} ms {n:7d} x  {name[:90]}")


def _host_profile(label: str, fn) -> None:
    """Wall time of fn under cProfile, and the package's functions that
    take the most of it (cumulative: a function's time includes its
    callees')."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = [(ct, f"{os.path.basename(f)}:{line} {name}", nc)
            for (f, line, name), (_, nc, _, ct, _) in pstats.Stats(prof).stats.items() if "kzg_tpu_torch" in f]
    print(f"{label} under cProfile: wall {wall * 1e3:.1f} ms; host functions by cumulative time:")
    for ct, where, nc in sorted(rows, reverse=True)[:14]:
        print(f"  {ct * 1e3:9.1f} ms {nc:7d} x  {where}")


def _trace_legacy_fk20(s, blob: bytes) -> None:
    from . import eip7594, fk20
    from .ops.field import FR

    raw = torch.from_numpy(np.frombuffer(blob, np.uint8).reshape(1, 4096, 32).copy()).to(s.device)
    coeffs = FR.decode(eip7594._cells_body(raw)[1][:, 0])
    calls = [(f"legacy FK20 multi n2 = 8192, chunk_len {c}", fk20.FK20MultiSettings(s, 8192, c), coeffs) for c in (64, 16)]
    calls.append(("legacy FK20 single n2 = 1024", fk20.FK20SingleSettings(s, 1024), coeffs[:512]))
    for label, fk, cs in calls:
        fk.data_availability(cs)  # warm
        launch.reset_launches()
        _trace(label, lambda: fk.data_availability(cs))
        print(f"  wrapper launches: {launch.launches()}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["legacy"]):
        print("usage: python -m kzg_tpu_torch.trace_main_path [legacy]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("trace_main_path: no CUDA device", file=sys.stderr)
        return 2
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    s = api.load_trusted_setup_file()
    s.lagrange_table  # built on the card (or read from the disk cache), outside the traced calls
    s.column_tables
    blobs = _blobs(N_BLOBS, SEED)
    if argv == ["legacy"]:
        _trace_legacy_fk20(s, blobs[0])
        return 0
    commits = api.blob_to_kzg_commitment_batch(blobs, s)  # warm
    blob_proofs = api.compute_blob_kzg_proof_batch(blobs, commits, s)
    cells, proofs = api.compute_cells_and_kzg_proofs_batch(blobs[:N_CELL_BLOBS], s)
    cell_args = (
        [commits[b] for b in range(N_CELL_BLOBS) for _ in range(128)],
        [j for _ in range(N_CELL_BLOBS) for j in range(128)],
        [c for row in cells for c in row],
        [p for row in proofs for p in row],
    )
    half = list(range(0, 128, 2))
    half_cells = [cells[0][i] for i in half]
    s.recovery_shift_pows  # built once, outside the traced calls
    if api.recover_cells_and_kzg_proofs(half, half_cells, s) != (cells[0], proofs[0]):
        print("trace_main_path: recovery of valid cells differs from the cells call", file=sys.stderr)
        return 1
    if not (api.verify_cell_kzg_proof_batch(*cell_args, s) and api.verify_blob_kzg_proof_batch(blobs, commits, blob_proofs, s)):
        print("trace_main_path: a verification of valid inputs returned False", file=sys.stderr)
        return 1
    launch.reset_launches()
    _trace(f"commit {N_BLOBS} blobs", lambda: api.blob_to_kzg_commitment_batch(blobs, s))
    _trace(f"prove {N_BLOBS} blobs", lambda: api.compute_blob_kzg_proof_batch(blobs, commits, s))
    _trace(
        f"cells and proofs of {N_CELL_BLOBS} blobs",
        lambda: api.compute_cells_and_kzg_proofs_batch(blobs[:N_CELL_BLOBS], s),
    )
    _trace("recover blob 0 from its even cells (50%)", lambda: api.recover_cells_and_kzg_proofs(half, half_cells, s))
    sampled = [b * 128 + j for b in range(N_CELL_BLOBS) for j in range(0, 128, 128 // N_SAMPLE_COLUMNS)]
    sample_args = tuple([v[i] for i in sampled] for v in cell_args)
    _trace(f"verify {len(cell_args[0])} cells", lambda: api.verify_cell_kzg_proof_batch(*cell_args, s))
    _trace(f"verify {len(sampled)} cells", lambda: api.verify_cell_kzg_proof_batch(*sample_args, s))
    _trace(f"verify {N_BLOBS} blobs", lambda: api.verify_blob_kzg_proof_batch(blobs, commits, blob_proofs, s))
    print(f"wrapper launches in the traced calls: {launch.launches()}")
    _host_profile(f"verify {len(cell_args[0])} cells", lambda: api.verify_cell_kzg_proof_batch(*cell_args, s))
    _host_profile(f"verify {N_BLOBS} blobs", lambda: api.verify_blob_kzg_proof_batch(blobs, commits, blob_proofs, s))
    _trace_legacy_fk20(s, blobs[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
