"""Per-op table of the port on one card, in the shape of the reference's
headline table (BASELINE.md): medians with p10 and p90, blobs/s, JSON. The
counterpart of the JAX package's benches/run_benches.py, with its row names
and keys.

    python3 -m kzg_tpu_torch.benches.run_benches [--iters N] [--ops op1,op2] [--json PATH]

Env: BENCH_G1FFT_POWS (default 12,14), BENCH_SWEEP_POWS (default
12,14,16,18,20). The fixed-base MSM row runs on the Lagrange table's 4096
points (the JAX script's BENCH_NPOW has no other size to take here).

Rows: g1_lincomb_4096 and fft_fr_scale15 (also pipelined: `iters` calls
dispatched back to back, one synchronize); the five singles; the three
64-blob rows; compute_cells_and_kzg_proofs;
recover_cells_and_kzg_proofs_50pct (from the even cells, as the JAX
script); verify_cell_kzg_proof_batch_128; fft_g1 at each BENCH_G1FFT_POWS
size, after a check that ifft(fft(P)) == P at the first; the variable-base MSM
at each BENCH_SWEEP_POWS size, with its peak device memory. Synthetic
points for those two are the mainnet setup's G1 points, tiled (the
arithmetic costs the same as a real setup of that size). Every time is a
wall time on the host clock around a call that ends on the host or in a
synchronize; the first call of a row (kernel build, one-time tables) is
timed on its own. A row or size that fails is written with its error, and
the script exits non-zero at its end. Rows stream out to --json as they
are produced. Prints the card's name and power limit first. Without a card
it exits non-zero.
"""

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..ops import field as fl
from ..ops import fft as dfft
from ..ops import g1 as dg1
from ..ops import g1fft
from ..ops import msm as dmsm
from ..ops.field import FR
from . import common

BASELINES_MS = {
    # blst sequential 1-core / parallel 16-core (BASELINE.md)
    "blob_to_kzg_commitment": (52.39, 8.98),
    "compute_kzg_proof": (55.34, 10.26),
    "compute_blob_kzg_proof": (56.41, 11.29),
    "verify_kzg_proof": (1.24, 1.23),
    "verify_blob_kzg_proof": (2.82, 2.83),
    "verify_blob_kzg_proof_batch_64": (114.2, 16.17),
    "fft_fr_scale15": (9.69, 2.37),
    "g1_lincomb_4096": (54.6, 9.02),
}
BLST_FFT_G1_2_15_MS = 18.8e3  # blst fft_g1 at 2^15, one core (BASELINE.md)


def timeit_stats(fn, iters):
    """(median, p10, p90, n) seconds of fn on the host clock."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    a = np.asarray(ts)
    return float(np.median(a)), float(np.percentile(a, 10)), float(np.percentile(a, 90)), len(a)


def fence(_=None) -> None:
    torch.cuda.synchronize()


def random_blob(rng) -> bytes:
    """A blob of 4096 canonical field elements, big-endian."""
    limbs = common.random_scalars(rng, 4096).astype(np.uint16)  # (16, 4096), limb 0 lowest
    return limbs.T[:, ::-1].astype(">u2").tobytes()


def tiled_points(s, m: int, device) -> dg1.G1Aff:
    """m affine points: the setup's 4096 monomial G1 points, tiled."""
    base = dg1.affine_from_ints(s.setup.g1_monomial, device)
    k = -(-m // base.x.shape[-1])
    return dg1.G1Aff(base.x.repeat(1, k)[:, :m].contiguous(), base.y.repeat(1, k)[:, :m].contiguous(),
                     base.inf.repeat(k)[:m].contiguous())


class Table:
    """The rows, the failures, and the streaming of partial JSON."""

    def __init__(self, args, t_start):
        self.args, self.t_start = args, t_start
        self.want = [o for o in args.ops.split(",") if o] or None
        self.results, self.failed = {}, []

    def wanted(self, name) -> bool:
        return not self.want or name in self.want

    def log(self, msg) -> None:
        print(f"[{time.time() - self.t_start:7.1f}s] {msg}", file=sys.stderr, flush=True)

    def flush(self) -> None:
        if self.args.json:
            with open(self.args.json, "w") as f:
                json.dump(self.results, f, indent=2)

    def fail(self, name, err, into=None, key=None) -> None:
        """Write the row `name` (or `key` of the dict `into`) as failed."""
        traceback.print_exc()
        (into if into is not None else self.results)[key or name] = {"error": f"{type(err).__name__}: {err}"}
        self.failed.append(name)
        self.log(f"{name:36s} FAILED: {type(err).__name__}: {err}")
        self.flush()

    def run(self, name, op) -> None:
        """One warm call, then `iters` timed calls."""
        if not self.wanted(name):
            return
        try:
            t0 = time.perf_counter()
            op()  # first call: kernel build, one-time tables
            t_first = time.perf_counter() - t0
            dt, p10, p90, n_samp = timeit_stats(op, self.args.iters)
        except Exception as e:
            return self.fail(name, e)
        base1, base16 = BASELINES_MS.get(name, (None, None))
        self.results[name] = {
            "ms": dt * 1e3,
            "ms_p10": p10 * 1e3,
            "ms_p90": p90 * 1e3,
            "samples": n_samp,
            "vs_blst_1core": (base1 / (dt * 1e3)) if base1 else None,
            "vs_blst_16core": (base16 / (dt * 1e3)) if base16 else None,
            "first_s": t_first,
        }
        extra = f"  ({base1 / (dt * 1e3):.2f}x blst-1c, {base16 / (dt * 1e3):.2f}x blst-16c)" if base1 else ""
        self.log(f"{name:36s} {dt * 1e3:10.3f} ms{extra}  [first call {t_first:.1f}s]")
        self.flush()

    def run_pipelined(self, name, op) -> None:
        """`iters` (at least 4) calls dispatched back to back, then one
        synchronize: ms per call as <name>.ms_pipelined."""
        if not self.wanted(name) or "error" in self.results.get(name, {}):
            return
        iters = max(4, self.args.iters)
        try:
            op()
            fence()
            t0 = time.perf_counter()
            for _ in range(iters):
                op()
            fence()
            dt = (time.perf_counter() - t0) / iters
        except Exception as e:
            return self.fail(name, e)
        self.results.setdefault(name, {})["ms_pipelined"] = dt * 1e3
        self.log(f"{name:36s} {dt * 1e3:10.3f} ms (pipelined)")
        self.flush()

    def per_blob(self, name, fn, base_name, count) -> None:
        if not self.wanted(name):
            return
        try:
            fn()
            dt = timeit_stats(fn, max(3, self.args.iters // 2))[0]
        except Exception as e:
            return self.fail(name, e)
        base1, base16 = BASELINES_MS.get(base_name, (None, None))
        row = {"ms_per_blob": dt / count * 1e3}
        if base1:
            row["vs_blst_1core"] = base1 / (dt / count * 1e3)
            row["vs_blst_16core"] = base16 / (dt / count * 1e3)
        self.results[name] = row
        self.log(f"{name:36s} {dt / count * 1e3:10.3f} ms/blob")
        self.flush()


def g1fft_rows(tab: Table, s, dev, pows) -> None:
    """fft_g1 at 2^p for each p, after the round-trip check at the first."""
    out = tab.results.setdefault("fft_g1", {})
    for i, p in enumerate(pows):
        m = 1 << p
        try:
            pts = tiled_points(s, m, dev)
            base = dg1.from_affine(pts)
            torch.cuda.reset_peak_memory_stats()
            fwd, t_first = common.wall_s(lambda: g1fft.fft_g1(base))
            if i == 0:
                back = g1fft.fft_g1(fwd, inverse=True)
                if dg1.xyzz_to_ints(back) != dg1.affine_to_ints(pts):
                    raise RuntimeError(f"ifft_g1(fft_g1(P)) != P at 2^{p}")
                tab.log(f"fft_g1 2^{p}: ifft(fft(P)) == P")
            _, dt = common.wall_s(lambda: g1fft.fft_g1(base))
        except Exception as e:
            tab.fail(f"fft_g1 2^{p}", e, into=out, key=f"2^{p}")
            continue
        base1 = BLST_FFT_G1_2_15_MS * (m * p) / ((1 << 15) * 15)  # O(n log n) scaling
        out[f"2^{p}"] = {"ms": dt * 1e3, "vs_blst_1core_scaled": base1 / (dt * 1e3), "first_s": t_first,
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        tab.log(f"fft_g1 2^{p:<2d} {dt * 1e3:10.1f} ms ({base1 / (dt * 1e3):.2f}x blst-1c scaled)")
        tab.flush()


def sweep_rows(tab: Table, s, dev, rng, pows) -> None:
    """The variable-base MSM at 2^p points for each p, with peak memory."""
    out = tab.results.setdefault("msm_sweep_variable_base", {})
    for p in pows:
        m = 1 << p
        base = scs = None  # the last size's inputs go before the next size's
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = tiled_points(s, m, dev)
            scs = torch.from_numpy(common.random_scalars(rng, m)).to(dev)
            _, t_first = common.wall_s(lambda: dmsm.msm(base, scs))
            dt = timeit_stats(lambda: (dmsm.msm(base, scs), fence()), max(2, tab.args.iters // 2))[0]
        except Exception as e:
            tab.fail(f"msm_sweep_variable_base 2^{p}", e, into=out, key=f"2^{p}")
            out[f"2^{p}"]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[f"2^{p}"] = {"ms": dt * 1e3, "pts_per_sec": m / dt, "first_s": t_first, "peak_mem_gib": peak,
                         "c": dmsm.default_window(m, fixed_base=False)}
        tab.log(f"msm_variable 2^{p:<2d} {dt * 1e3:10.2f} ms ({m / dt / 1e3:.0f}k pts/s), peak {peak:.2f} GiB")
        tab.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ops", type=str, default="")
    ap.add_argument("--json", type=str, default="")
    args = ap.parse_args(argv)
    if not common.require_card("run_benches"):
        return 2
    from .. import api as kzg

    tab = Table(args, time.time())
    print(f"card: {common.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    s = kzg.load_trusted_setup_file()
    dev = s.device
    rng = np.random.default_rng(7)
    blob = random_blob(rng)
    table, secs = common.wall_s(lambda: s.lagrange_table)
    tab.log(f"setup + Lagrange table: {secs:.1f} s")

    # micro: the fixed-base MSM at the table's size
    n = table.n
    sc = torch.from_numpy(common.random_scalars(rng, n)).to(dev)
    tab.run(f"g1_lincomb_{n}", lambda: fence(dmsm.msm_fixed(table, sc)))
    tab.run_pipelined(f"g1_lincomb_{n}", lambda: dmsm.msm_fixed(table, sc))

    # micro: fft_fr scale 15 (B4, then four B5 stages)
    vals = fl.from_canonical(FR, torch.from_numpy(common.random_scalars(rng, 1 << 15)).to(dev))
    tab.run("fft_fr_scale15", lambda: fence(dfft.fft(vals)))
    tab.run_pipelined("fft_fr_scale15", lambda: dfft.fft(vals))

    # protocol ops
    z = (2026).to_bytes(32, "big")
    commitment = kzg.blob_to_kzg_commitment(blob, s)
    proof, y = kzg.compute_kzg_proof(blob, z, s)
    blob_proof = kzg.compute_blob_kzg_proof(blob, commitment, s)
    tab.run("blob_to_kzg_commitment", lambda: kzg.blob_to_kzg_commitment(blob, s))
    tab.run("compute_kzg_proof", lambda: kzg.compute_kzg_proof(blob, z, s))
    tab.run("compute_blob_kzg_proof", lambda: kzg.compute_blob_kzg_proof(blob, commitment, s))
    tab.run("verify_kzg_proof", lambda: kzg.verify_kzg_proof(commitment, z, y, proof, s))
    tab.run("verify_blob_kzg_proof", lambda: kzg.verify_blob_kzg_proof(blob, commitment, blob_proof, s))

    # the 64-blob batch (the reference's MAX_COUNT = 64)
    blobs = [random_blob(rng) for _ in range(64)]
    commitments = kzg.blob_to_kzg_commitment_batch(blobs, s)
    proofs = kzg.compute_blob_kzg_proof_batch(blobs, commitments, s)
    tab.per_blob("blob_to_kzg_commitment_batch_64", lambda: kzg.blob_to_kzg_commitment_batch(blobs, s),
                 "blob_to_kzg_commitment", 64)
    tab.per_blob("compute_blob_kzg_proof_batch_64", lambda: kzg.compute_blob_kzg_proof_batch(blobs, commitments, s),
                 "compute_blob_kzg_proof", 64)
    tab.run("verify_blob_kzg_proof_batch_64", lambda: kzg.verify_blob_kzg_proof_batch(blobs, commitments, proofs, s))
    if "ms" in tab.results.get("verify_blob_kzg_proof_batch_64", {}):
        ms = tab.results["verify_blob_kzg_proof_batch_64"]["ms"]
        tab.results["verify_blob_kzg_proof_batch_64"]["blobs_per_sec"] = 64 / (ms / 1e3)

    # EIP-7594 (no published reference numbers; recorded for tracking)
    tab.run("compute_cells_and_kzg_proofs", lambda: kzg.compute_cells_and_kzg_proofs(blob, s))
    if tab.wanted("recover_cells_and_kzg_proofs_50pct") or tab.wanted("verify_cell_kzg_proof_batch_128"):
        cells, cell_proofs = kzg.compute_cells_and_kzg_proofs(blob, s)
        half = list(range(0, 128, 2))
        tab.run("recover_cells_and_kzg_proofs_50pct",
                lambda: kzg.recover_cells_and_kzg_proofs(half, [cells[i] for i in half], s))
        tab.run("verify_cell_kzg_proof_batch_128", lambda: kzg.verify_cell_kzg_proof_batch(
            [commitment] * 128, list(range(128)), cells, cell_proofs, s))

    # the G1 FFT at the reference's bench scales (fft_g1_standalone's rows)
    if tab.wanted("fft_g1"):
        g1fft_rows(tab, s, dev, [int(x) for x in os.environ.get("BENCH_G1FFT_POWS", "12,14").split(",")])

    # the variable-base MSM's size sweep
    if tab.wanted("msm_sweep"):
        sweep_rows(tab, s, dev, rng, [int(x) for x in os.environ.get("BENCH_SWEEP_POWS", "12,14,16,18,20").split(",")])

    print(json.dumps(tab.results, indent=2))
    tab.flush()
    if tab.failed:
        print(f"run_benches: {len(tab.failed)} failed: {tab.failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
