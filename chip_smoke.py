#!/usr/bin/env python3
"""Drive kzg_tpu_torch on one NVIDIA GPU and check it, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed;
each phase's comments in main() say what it checks and why):
  1. card and builds: the card's name, power limit and versions; the CUDA
     kernels (one nvcc a source; B1-B3, B7-B9 must not spill, B7 has
     no stack), the native host core and the C ABI, built together;
  2. the main paths at full protocol width through the public API, with
     the kernels' launch counts read around each call: EIP-4844 commit
     and prove of 64 seeded blobs on the mainnet setup; EIP-7594 cells and
     proofs of 16 blobs, verification of their 2048 cells and of a
     sampling node's 8 columns, blob verification (True; False with a
     cell changed, proofs swapped, another blob's proof; a non-canonical
     blob raises); recovery of single blobs and of a 9-blob batch (equal
     to the cells call's); multiproofs on the monomial table;
     das_extension; the bench path (headline bench, a stage split, the
     gather probe); legacy FK20 (multi and single); the C ABI through
     ctypes and the repository's C test program (native/test_c_abi.c);
  3. checks of the results against independent answers: known answers
     from the setup file's own bytes, the CPU path on a CPU copy of the
     tables, and pairing checks of blob and cell proofs;
  4. the kernel table: one row a kernel, each holding the kernel against
     its plain version (limb for limb) at the timed shape and at the main
     paths' other shapes that no check of a result stands in for, then
     timing both (CUDA events) beside the bound, the least time the card
     could take. Edge cases are the `gpu` tests' job
     (tests/test_torch_package.py, tests/test_torch_g1fft.py);
  5. multi-device in ranks of one gloo process group, every rank on this
     card: 2 ranks run the batch entry points with mesh= (equal to phase
     2's answers; a non-canonical blob raises on both ranks), 4 ranks run
     the sharded MSMs and FFTs, held here against the plain versions on
     the CPU copy.

The last lines are the card line, a JSON line of kernel numbers, and
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

SEED = 4844
N_BLOBS = 64
N_CELL_BLOBS = 16  # one EIP-7594 batch call: more than a block's 9 blobs (EIP-7691)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
IMAD_PER_CLOCK_PER_SM = 64  # 32-bit integer multiply-add, compute capability 9.0
MULADDS_PER_FMUL = 12 * (4 * 12 + 1)  # Fp CIOS: 12 rows of 4 twelve-word chains + m
MULADDS_PER_RMUL = 8 * (4 * 8 + 1)  # Fr CIOS: 8 rows of 4 eight-word chains + m
N_SAMPLE_COLUMNS = 8  # a sampling node's columns (PeerDAS custody of 8 of 128)
BENCH_BATCH, BENCH_ITERS = 8, 3  # the headline bench's batch, cut to 3 iterations
FR_TENSOR_BYTES = 16 * 4  # one Fr value in the (16, ...) int32 limb layout
FR_BYTES = 32  # one Fr value packed: what a 32-bit-limb layout would move
NO_SPILL = ("seg_scan_phase1_kernel", "add_unified_kernel", "horner_kernel", "field_inv_kernel",
            "g1_ladder_kernel", "integrate_kernel")  # B1-B3, B7-B9: ptxas must report no spills
NO_STACK = ("field_inv_kernel",)  # B7: ptxas must report no stack frame


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def build_all():
    """nvcc for the kernels (one process per source), g++ for the native
    core and g++ and gcc for the C ABI (the shim and the C test program),
    started together."""
    from kzg_tpu_torch import c_abi_build, kernels, native

    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:  # reported and re-raised by the caller
            results[name] = (e, time.perf_counter() - t0)

    threads = [
        threading.Thread(target=run, args=("kernels", kernels.build)),
        threading.Thread(target=run, args=("native", native.build)),
        threading.Thread(target=run, args=("C ABI", c_abi_build.build)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, secs) in results.items():
        if isinstance(res, Exception):
            raise SmokeFailure(f"{name} build failed: {res}")
        log(f"build {name}: {secs:.1f} s")
    # the reports of every library, whether built now or by an earlier run
    report = ""
    for src in kernels.SOURCES:
        with open(kernels.library_path(src) + ".ptxas.txt") as f:
            report += f.read()
    entry, spills = None, {}
    for line in report.splitlines():
        if "Compiling entry" in line:
            entry = next((k for k in NO_SPILL if k in line), None)
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
        if entry and "spill" in line:
            spills.setdefault(entry, []).append(line.strip())
    # B1, B2, B3, B7 (each of its instances), B8 and B9 keep every value in
    # registers or shared memory
    for k in NO_SPILL:
        check(k in spills, f"ptxas reported no spill line for {k}")
        for line in spills[k]:
            check(line.endswith(" 0 bytes spill stores, 0 bytes spill loads"), f"ptxas spills in {k}: {line}")
            check(k not in NO_STACK or line.startswith("0 bytes stack frame"), f"ptxas stack frame in {k}: {line}")


# ---- the multi-device phase's ranks ---------------------------------------
# Module-level, so that kzg_tpu_torch.parallel.dryrun.launch can start them
# in processes of their own (spawn); every rank runs on cuda:0 under gloo.

MESH_ROWS = 8  # scalar rows of the 4-rank fixed-base MSM


def mesh_inputs(s, device):
    """The 4-rank run's seeded inputs: MESH_ROWS rows of 4096 scalars
    (16, 8, 4096), the 4096 setup points (the bit-reversed Lagrange ones),
    8192 Fr values (the extended blob's length) in Montgomery form."""
    import numpy as np

    from kzg_tpu_torch import bench
    from kzg_tpu_torch.constants import R_MOD as R
    from kzg_tpu_torch.ops import g1
    from kzg_tpu_torch.ops.field import FR

    rng = np.random.default_rng(SEED + 10)
    return (bench.make_inputs(4096, MESH_ROWS, 1, device, seed=SEED + 9)[0],
            g1.affine_from_ints(s.setup.g1_lagrange_brp, device),
            FR.encode([int.from_bytes(rng.bytes(32), "big") % R for _ in range(8192)], device))


def _rank_run(label, device, body) -> dict:
    """One rank's run of `body(walls)`: the kernels' launch counts zeroed
    just before it and read just after, its peak device memory and walls."""
    import torch
    import torch.distributed as dist

    from kzg_tpu_torch.ops import launch

    walls = {}
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    out = body(walls)
    counts = launch.launches()
    peak = torch.cuda.max_memory_allocated()
    rank = dist.get_rank()
    print(f"{label} rank {rank}: OK; walls {json.dumps({k: round(v, 3) for k, v in walls.items()})} s; launches "
          f"{counts}; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    return {**out, "walls": walls, "launches": counts, "peak_bytes": peak}


def mesh_entry_points(device: str, blobs, commits, proofs) -> dict:
    """A rank of the 2-rank run on blobs_mesh(), at full width: the
    commitments of the blobs equal the single-process ones; verification
    is True, False with two proofs swapped; 63 blobs (padded to 64) give
    the same answers as without the mesh; a non-canonical blob (in rank
    1's half) raises ValueError on every rank, commit and verify."""
    import torch

    from kzg_tpu_torch import api
    from kzg_tpu_torch.constants import R_MOD as R
    from kzg_tpu_torch.parallel.distributed import blobs_mesh

    t0 = time.perf_counter()
    mesh = blobs_mesh()
    s = api.load_trusted_setup_file(device=device)
    check(s.device == torch.device(device), f"settings on {s.device}, not {device}")
    s.lagrange_table  # from the table cache the parent filled
    t_load = time.perf_counter() - t0
    n = len(blobs)
    at = n * 5 // 8  # in rank 1's half: rank 0 learns of it from rank 1
    bad = bytearray(blobs[at])
    bad[32 * 10 : 32 * 11] = R.to_bytes(32, "big")
    bad_blobs = blobs[:at] + [bytes(bad)] + blobs[at + 1 :]

    def body(walls):
        def call(label, fn):
            out, walls[label] = timed(fn)
            return out

        check(call(f"commit {n}", lambda: api.blob_to_kzg_commitment_batch(blobs, s, mesh=mesh)) == commits,
              "the mesh's commitments differ from the single-process ones")
        check(call(f"verify {n}", lambda: api.verify_blob_kzg_proof_batch(blobs, commits, proofs, s, mesh=mesh))
              is True, "mesh verification of valid blobs is not True")
        swapped = [proofs[1], proofs[0]] + proofs[2:]
        check(call(f"verify {n}, two proofs swapped",
                   lambda: api.verify_blob_kzg_proof_batch(blobs, commits, swapped, s, mesh=mesh)) is False,
              "mesh verification passes two swapped proofs")
        k = n - 1
        check(call(f"commit {k}", lambda: api.blob_to_kzg_commitment_batch(blobs[:k], s, mesh=mesh)) == commits[:k],
              f"the mesh's commitments of {k} blobs differ from the single-process ones")
        check(call(f"verify {k}", lambda: api.verify_blob_kzg_proof_batch(blobs[:k], commits[:k], proofs[:k], s,
                                                                           mesh=mesh)) is True,
              f"mesh verification of {k} valid blobs is not True")
        for label, fn in (("commit", lambda: api.blob_to_kzg_commitment_batch(bad_blobs, s, mesh=mesh)),
                          ("verify", lambda: api.verify_blob_kzg_proof_batch(bad_blobs, commits, proofs, s,
                                                                             mesh=mesh))):
            try:
                call(f"{label} with a non-canonical blob", fn)
            except ValueError as e:
                check("not canonical" in str(e), f"{label} of a non-canonical blob raised {e!r}")
            else:
                raise SmokeFailure(f"{label} of a non-canonical blob on the mesh did not raise")
        return {}

    return {**_rank_run("mesh entry points", device, body), "load_s": t_load}


def mesh_programs(device: str) -> dict:
    """A rank of the 4-rank run on global_mesh(2), a 2 x 2 blobs x points
    mesh: the dry run's programs at its small shapes, then at full width
    msm_fixed_sharded on the mainnet Lagrange table (c = 13, 20 windows)
    over MESH_ROWS seeded rows, msm_sharded over the 4096 setup points, and
    fft_sharded and ifft_sharded at n = 8192, which must round-trip.
    Returns the results as Python ints for the parent to hold against the
    single-process functions."""
    import torch

    from kzg_tpu_torch import api
    from kzg_tpu_torch.ops import g1
    from kzg_tpu_torch.ops.field import limbs_to_ints
    from kzg_tpu_torch.parallel import dryrun
    from kzg_tpu_torch.parallel.distributed import blobs_mesh, global_mesh
    from kzg_tpu_torch.parallel.sharded_fft import fft_sharded, ifft_sharded
    from kzg_tpu_torch.parallel.sharded_msm import msm_fixed_sharded, msm_sharded

    t0 = time.perf_counter()
    mesh, bmesh = global_mesh(2), blobs_mesh()
    dryrun.toy_checks(device, mesh, bmesh)  # raises on a difference
    t_toy = time.perf_counter() - t0
    s = api.load_trusted_setup_file(device=device)
    check(s.device == torch.device(device), f"settings on {s.device}, not {device}")
    table = s.lagrange_table  # from the table cache the parent filled
    sc, pts, x = mesh_inputs(s, torch.device(device))
    t_load = time.perf_counter() - t0 - t_toy

    def body(walls):
        def call(label, fn):
            out, walls[label] = timed(fn)
            return out

        fixed = call(f"msm_fixed_sharded {MESH_ROWS} x 4096 (with to_affine)",
                     lambda: g1.xyzz_to_ints(msm_fixed_sharded(table, sc, mesh)))
        var = call("msm_sharded 4096 (with to_affine)", lambda: g1.xyzz_to_ints(msm_sharded(pts, sc[:, 0], mesh)))
        fwd = call("fft_sharded 8192", lambda: (fft_sharded(x, mesh), torch.cuda.synchronize())[0])
        inv = call("ifft_sharded 8192", lambda: (ifft_sharded(x, mesh), torch.cuda.synchronize())[0])
        check(torch.equal(ifft_sharded(fwd, mesh), x), "ifft_sharded(fft_sharded(x)) != x")
        return {"fixed": fixed, "var": var, "fft": limbs_to_ints(fwd), "ifft": limbs_to_ints(inv)}

    return {**_rank_run("mesh programs", device, body), "toy_s": t_toy, "load_s": t_load}


def host_eval(blob: bytes, z: int, roots_brp) -> int:
    """Barycentric evaluation of one blob at z with python ints, an
    independent reference for the pairing check."""
    from kzg_tpu_torch.constants import R_MOD as R

    n = len(roots_brp)
    vals = [int.from_bytes(blob[32 * i : 32 * i + 32], "big") for i in range(n)]
    diffs = [(z - w) % R for w in roots_brp]
    if 0 in diffs:
        return vals[diffs.index(0)]
    prefix = [1] * (n + 1)
    for i, d in enumerate(diffs):
        prefix[i + 1] = prefix[i] * d % R
    inv = pow(prefix[n], R - 2, R)
    total = 0
    for i in range(n - 1, -1, -1):
        inv_i = inv * prefix[i] % R
        inv = inv * diffs[i] % R
        total = (total + vals[i] * roots_brp[i] % R * inv_i) % R
    return total * (pow(z, n, R) - 1) % R * pow(n, R - 2, R) % R


def cell_interpolant(values, h: int):
    """Coefficients of the degree < 64 polynomial through the cell's values.
    Cell point i is h * w64^brp6(i), so I(x) = sum_m a_m x^m with
    a_m = h^-m / 64 * sum_t v[brp6(t)] w64^(-t m)."""
    from kzg_tpu_torch.constants import R_MOD as R, root_of_unity
    from kzg_tpu_torch.trusted_setup import reverse_bit_order

    n = len(values)
    natural = reverse_bit_order(list(values))  # value at h * w^t
    winv = pow(root_of_unity(n.bit_length() - 1), R - 2, R)
    hinv, ninv = pow(h, R - 2, R), pow(n, R - 2, R)
    coeffs, hpow = [], 1
    for m in range(n):
        wm = pow(winv, m, R)
        acc, wp = 0, 1
        for t in range(n):
            acc += natural[t] * wp
            wp = wp * wm % R
        coeffs.append(acc % R * ninv % R * hpow % R)
        hpow = hpow * hinv % R
    return coeffs


def mdbl_steps(rows, idx, first, sums) -> int:
    """Steps of B1's scan that double: the row equals the running sum it
    is added to, neither is the identity, and the step does not restart.
    sums: the scan's output (its step t - 1 is the sum entering step t)."""
    import torch

    from kzg_tpu_torch.ops import cuda_msm, field as fl, g1
    from kzg_tpu_torch.ops.field import FP

    total = 0
    for t in range(1, idx.shape[0]):
        x, y, inf = cuda_msm.unpack_rows(rows[idx[t].long()])
        acc = g1.map_coords(lambda c: c[:, t - 1], sums)
        u2, s2 = fl.mul_many(FP, [(x, acc.zz), (y, acc.zzz)])
        need = (~first[t] & ~inf & ~g1.is_inf(acc) & fl.is_zero(FP, fl.sub(FP, u2, acc.x))
                & fl.is_zero(FP, fl.sub(FP, s2, acc.y)))
        total += int(torch.count_nonzero(need))
    return total


def fft_times_ms(B: int, n: int, products: int, peak_imad: float, value_bytes: int = FR_TENSOR_BYTES) -> tuple:
    """(operations time, bytes time) in ms of a pass over (16, B, n) Fr
    values that does `products` Montgomery products, reads every value once
    and writes it once (`value_bytes` each), and reads the n/2 twiddles once."""
    nbytes = 2 * B * n * value_bytes + 4 * 8 * (n // 2)
    return products * MULADDS_PER_RMUL / peak_imad * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def doubling_lanes(p, q) -> int:
    """Lanes where B2's addition takes its doubling: P == Q, neither the identity."""
    from kzg_tpu_torch.ops import field as fl, g1
    from kzg_tpu_torch.ops.field import FP

    u1, u2, s1, s2 = fl.mul_many(FP, [(p.x, q.zz), (q.x, p.zz), (p.y, q.zzz), (q.y, p.zzz)])
    need = ~g1.is_inf(p) & ~g1.is_inf(q) & fl.is_zero(FP, fl.sub(FP, u2, u1)) & fl.is_zero(FP, fl.sub(FP, s2, s1))
    return int(need.sum())


def roof(ops_ms: float, bytes_ms: float) -> tuple:
    """(bound ms, what bounds it) of a pass that takes ops_ms at the
    operations' rate and bytes_ms at the memory's."""
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def max_abs_err(got, ref) -> int:
    """Largest limb difference between two outputs (a tensor, or tuples
    and lists of them: points, the launches of a row), shapes equal."""
    import torch

    if torch.is_tensor(got):
        check(got.shape == ref.shape, f"shape {tuple(got.shape)} != {tuple(ref.shape)}")
        return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max()) if got.numel() else 0
    check(len(got) == len(ref), f"{len(got)} outputs != {len(ref)}")
    return max(max_abs_err(a, b) for a, b in zip(got, ref))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "kzg_tpu_torch")):
        print("chip_smoke: kzg_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    import numpy as np

    from kzg_tpu_torch import api, bench, c_abi, c_abi_build, eip4844, eip7594, fk20, native, settings, tracing, trusted_setup
    from kzg_tpu_torch.benches import gather_micro, msm_stages
    from kzg_tpu_torch.benches.common import device_ms as cuda_ms
    from kzg_tpu_torch.constants import P_MOD, R_MOD as R
    from kzg_tpu_torch.ops import cuda_fft, cuda_gather, cuda_msm, fft as fft_ops, field as fl, g1, g1fft, launch, msm
    from kzg_tpu_torch.ops.field import FP, FR
    from kzg_tpu_torch.settings import TorchKZGSettings

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    peak_imad = n_sm * IMAD_PER_CLOCK_PER_SM * sm_clock_mhz * 1e6
    log(f"card: {card}; {n_sm} SMs, max SM clock {sm_clock_mhz:.0f} MHz")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 1. builds -------------------------------------------------------
    build_all()
    log(f"B1: {cuda_msm.SCAN_GROUP} warps on 32 chunk lanes; B2 and B3: g = {cuda_msm.GROUP} threads per point")

    # ---- 2. the main paths -----------------------------------------------
    setup_path = settings.trusted_setup_path()
    torch.cuda.reset_peak_memory_stats()
    s, t_setup = timed(lambda: api.load_trusted_setup_file())
    check(s.device.type == "cuda", "settings not on the card")
    log(f"setup file (no path given): {setup_path}")
    log(f"setup decode: {t_setup:.2f} s")

    def synced(fn):
        def run():
            out = fn()
            torch.cuda.synchronize()
            return out

        return run

    table, t_table = timed(synced(lambda: s.lagrange_table))
    check(table.c == 13 and tuple(table.x.shape) == (24, 20, 4096), "unexpected table shape")
    log(f"table build (20 x 4096, on the card): {t_table:.2f} s")

    rng = np.random.default_rng(SEED)

    def random_blob():
        a = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
        a[:, 0] &= 0x3F  # below r
        return a.tobytes()

    blobs = [random_blob() for _ in range(N_BLOBS)]
    main_launches = {}

    def counted_call(label, fn, inverts=False):
        """The call, its wall and its kernel launches; with `inverts`, it
        must have launched B7 once for each inversion it counted."""
        launch.reset_launches()
        inversions = tracing.counters().get("field.inversions", 0)
        out, secs = timed(fn)
        counts = launch.launches()
        inversions = tracing.counters().get("field.inversions", 0) - inversions
        for name, k in counts.items():
            main_launches[name] = main_launches.get(name, 0) + k
        log(f"{label}: {secs:.3f} s; launches {counts}; inversions {inversions}")
        if inverts:
            check(inversions > 0 and counts["field_inv"] == inversions,
                  f"{label}: {counts['field_inv']} launches of field_inv for {inversions} inversions")
        return out, counts, secs

    commits, launches_commit, _ = counted_call(
        f"commit {N_BLOBS} blobs", lambda: api.blob_to_kzg_commitment_batch(blobs, s), inverts=True
    )
    proofs, launches_prove, _ = counted_call(
        f"prove {N_BLOBS} blobs", lambda: api.compute_blob_kzg_proof_batch(blobs, commits, s), inverts=True
    )
    peak_mem = torch.cuda.max_memory_allocated()
    for name in ("seg_scan_phase1", "add_unified"):
        check(launches_commit[name] > 0, f"commit did not launch {name}")
        check(launches_prove[name] > 0, f"prove did not launch {name}")
    check(len(commits) == N_BLOBS and all(len(c) == 48 for c in commits), "bad commitments")
    check(len(proofs) == N_BLOBS and all(len(p) == 48 for p in proofs), "bad proofs")

    # EIP-7594: column tables, then one 16-blob cells-and-proofs call
    columns, t_columns = timed(synced(lambda: s.x_ext_fft_columns))
    check(tuple(columns.x.shape) == (24, 128, 64), "unexpected column shape")
    log(f"FK20 column points (64 G1 FFTs of 128, on the card): {t_columns:.2f} s")
    col_tables, t_col_tables = timed(synced(lambda: s.column_tables))
    check(col_tables.c == 8 and tuple(col_tables.x.shape) == (24, 32, 128, 64), "unexpected column table shape")
    log(f"FK20 column tables (c = 8, 32 x 128 x 64, on the card): {t_col_tables:.2f} s")

    cell_blobs = blobs[:N_CELL_BLOBS]
    torch.cuda.reset_peak_memory_stats()
    (cells, cell_proofs), launches_cells, t_cells = counted_call(
        f"cells and proofs of {N_CELL_BLOBS} blobs",
        lambda: api.compute_cells_and_kzg_proofs_batch(cell_blobs, s),
    )
    peak_mem_cells = torch.cuda.max_memory_allocated()
    for name in ("seg_scan_phase1", "add_unified", "ntt_tile", "ntt_stage"):
        check(launches_cells[name] > 0, f"compute_cells_and_kzg_proofs_batch did not launch {name}")
    n_chunks = -(-N_CELL_BLOBS // eip7594.BATCH_CHUNK)
    check(launches_cells["g1_ladder"] == n_chunks,
          f"compute_cells_and_kzg_proofs_batch launched g1_ladder {launches_cells['g1_ladder']} times for {n_chunks} chunks")
    check(len(cells) == N_CELL_BLOBS and all(len(c) == 128 and all(len(x) == 2048 for x in c) for c in cells), "bad cells")
    check(len(cell_proofs) == N_CELL_BLOBS and all(len(p) == 128 for p in cell_proofs), "bad cell proofs")
    t_compute_cells = 0.0
    for i, blob in enumerate(cell_blobs):
        only, counts, secs = counted_call(f"compute_cells blob {i}", lambda: api.compute_cells(blob, s))
        t_compute_cells += secs
        for name in ("ntt_tile", "ntt_stage"):
            check(counts[name] > 0, f"compute_cells did not launch {name}")
        check(only == cells[i], f"compute_cells differs from the batch call's cells for blob {i}")
    log(f"compute_cells: {N_CELL_BLOBS} calls in {t_compute_cells:.3f} s, cells equal the batch call's")

    # EIP-7594 verification: every cell of the 16 blobs in one call, then a
    # sampling node's 8 columns of each; True, and False with one cell
    # changed and with two proofs swapped. The verifier's constants (the
    # 64-point monomial table, built on the card, and the coset-shift
    # powers) are built first, outside the timed calls, as the tables above.
    _, t_consts = timed(synced(lambda: (s.monomial64_table, s.inv_coset_shift_pows)))
    log(f"cell verifier constants (64-point monomial table c = 13 on the card, coset-shift powers): {t_consts:.2f} s")
    all_cells = (
        [commits[b] for b in range(N_CELL_BLOBS) for _ in range(128)],
        [j for _ in range(N_CELL_BLOBS) for j in range(128)],
        [c for row in cells for c in row],
        [p for row in cell_proofs for p in row],
    )
    columns = list(range(0, 128, 128 // N_SAMPLE_COLUMNS))
    picked = [b * 128 + j for b in range(N_CELL_BLOBS) for j in columns]
    verify_cases = {len(all_cells[0]): all_cells, len(picked): tuple([v[i] for i in picked] for v in all_cells)}
    verify_walls, verify_peaks, verify_launches = {}, {}, {}
    for count, (cb, idx, cl, pr) in verify_cases.items():
        torch.cuda.reset_peak_memory_stats()
        ok, counts, secs = counted_call(f"verify {count} cells", lambda: api.verify_cell_kzg_proof_batch(cb, idx, cl, pr, s),
                                        inverts=True)
        verify_walls[f"cells {count}"], verify_launches[f"cells {count}"] = secs, counts
        verify_peaks[f"cells {count}"] = torch.cuda.max_memory_allocated()
        check(ok is True, f"verify_cell_kzg_proof_batch of {count} valid cells returned {ok}")
        for name in ("seg_scan_phase1", "add_unified", "horner", "ntt_tile"):
            check(counts[name] > 0, f"verify_cell_kzg_proof_batch did not launch {name}")
        bad = bytearray(cl[7])
        bad[-1] ^= 1  # still canonical
        check(api.verify_cell_kzg_proof_batch(cb, idx, cl[:7] + [bytes(bad)] + cl[8:], pr, s) is False,
              f"a changed cell passes verification ({count} cells)")
        check(api.verify_cell_kzg_proof_batch(cb, idx, cl, [pr[1], pr[0]] + pr[2:], s) is False,
              f"two swapped proofs pass verification ({count} cells)")
    log(f"cell verification: {sorted(verify_cases)} cells True; a changed cell and two swapped proofs False")

    # EIP-4844 verification of the 64 blobs; a proof of another blob gives
    # False, a non-canonical blob raises
    torch.cuda.reset_peak_memory_stats()
    ok, counts, secs = counted_call(f"verify {N_BLOBS} blobs", lambda: api.verify_blob_kzg_proof_batch(blobs, commits, proofs, s),
                                    inverts=True)
    verify_walls[f"blobs {N_BLOBS}"], verify_launches[f"blobs {N_BLOBS}"] = secs, counts
    verify_peaks[f"blobs {N_BLOBS}"] = torch.cuda.max_memory_allocated()
    check(ok is True, f"verify_blob_kzg_proof_batch of {N_BLOBS} valid blobs returned {ok}")
    for name in ("seg_scan_phase1", "add_unified", "horner"):
        check(counts[name] > 0, f"verify_blob_kzg_proof_batch did not launch {name}")
    check(api.verify_blob_kzg_proof_batch(blobs, commits, [proofs[1]] + proofs[1:], s) is False,
          "a proof of another blob passes verification")
    bad_blob = bytearray(blobs[3])
    bad_blob[32 * 10 : 32 * 11] = R.to_bytes(32, "big")
    try:
        api.verify_blob_kzg_proof_batch(blobs[:3] + [bytes(bad_blob)] + blobs[4:], commits, proofs, s)
        raise SmokeFailure("a non-canonical blob did not raise")
    except ValueError as e:
        check("not canonical" in str(e), f"a non-canonical blob raised {e!r}")
    log(f"blob verification: {N_BLOBS} blobs True; a proof of another blob False; a non-canonical blob raises")

    # EIP-7594 recovery of three cell blobs, from a seeded random 64 of
    # their 128 cells, from cells 0-63, and from all 128 (the proofs only);
    # then one batch call of two blobs: the cells and proofs must equal
    # the cells call's, whose proofs verify above. The coset powers are
    # built first, outside the timed calls. 63 cells raise before any
    # device work.
    _, t_rec_consts = timed(synced(lambda: s.recovery_shift_pows))
    log(f"recovery constants (coset powers of 7 and 1/7, 2 x 8192): {t_rec_consts:.2f} s")
    rec_rng = np.random.default_rng(SEED + 7)
    rec_cases = [(0, "a random 64", sorted(rec_rng.choice(128, 64, replace=False).tolist())),
                 (1, "cells 0-63", list(range(64))), (2, "all 128", list(range(128)))]
    recover_walls, recover_launches, recover_peaks = {}, {}, {}
    for b, label, idx in rec_cases:
        torch.cuda.reset_peak_memory_stats()
        (rc, rp), counts, secs = counted_call(
            f"recover blob {b} from {label}", lambda: api.recover_cells_and_kzg_proofs(idx, [cells[b][i] for i in idx], s)
        )
        recover_walls[label], recover_launches[label] = secs, counts
        recover_peaks[label] = torch.cuda.max_memory_allocated()
        check(rc == cells[b], f"recovered cells of blob {b} from {label} differ from the cells call's")
        check(rp == cell_proofs[b], f"recovered proofs of blob {b} from {label} differ from the cells call's")
        for name in ("ntt_tile", "ntt_stage", "seg_scan_phase1", "add_unified"):
            check(counts[name] > 0, f"recover_cells_and_kzg_proofs from {label} did not launch {name}")
        check(counts["g1_ladder"] == 1, f"recover_cells_and_kzg_proofs from {label} launched g1_ladder {counts['g1_ladder']} times")
    # a 9-blob block (EIP-7691) in one call: blobs 3-11, each from its own
    # seeded 64 cells, the even cells or the odd ones
    half = list(range(0, 128, 2))
    batch_blobs = list(range(3, 12))
    batch_idx = [sorted(rec_rng.choice(128, 64, replace=False).tolist()) for _ in range(7)] + [half, [i + 1 for i in half]]
    passes = tracing.counters().get("recover.passes", 0)
    (rcs, rps), counts, secs = counted_call(
        "recover_cells_and_kzg_proofs_batch of blobs 3-11 (seeded 64 cells; the even cells; the odd cells)",
        lambda: api.recover_cells_and_kzg_proofs_batch(batch_idx, [[cells[b][i] for i in idx] for b, idx in zip(batch_blobs, batch_idx)], s),
    )
    recover_walls["batch of 9"], recover_launches["batch of 9"] = secs, counts
    check(rcs == [cells[b] for b in batch_blobs] and rps == [cell_proofs[b] for b in batch_blobs],
          "the batch recovery's cells or proofs differ from the cells call's")
    passes = tracing.counters().get("recover.passes", 0) - passes
    check(passes == 1, f"the batch recovery of nine blobs made {passes} recovery passes, not one")
    check(counts["g1_ladder"] == 1, f"the batch recovery of nine blobs launched g1_ladder {counts['g1_ladder']} times, not once")
    launch.reset_launches()
    try:
        api.recover_cells_and_kzg_proofs(list(range(63)), cells[0][:63], s)
        raise SmokeFailure("recovery from 63 cells did not raise")
    except ValueError as e:
        check("not enough cells" in str(e), f"recovery from 63 cells raised {e!r}")
    check(not any(launch.launches().values()), f"recovery from 63 cells launched {launch.launches()}")
    log("recovery: cells and proofs of 3 blobs and a batch of 9 equal the cells call's; 63 cells raise before any launch")

    # the monomial table and multiproofs: the table's commitment to blob
    # 0's monomial coefficients is the blob's commitment; proofs of those
    # 4096 coefficients on cosets of n = 16 and 64 points at a seeded x
    # verify against that commitment, and fail with one value changed.
    # The coset's values come from the port's FFT of n over the
    # coefficients scaled by x^i and folded mod n.
    mono, t_mono = timed(synced(lambda: s.monomial_table))
    check(mono.c == 13 and tuple(mono.x.shape) == (24, 20, 4096), "unexpected monomial table shape")
    log(f"monomial table build (20 x 4096, on the card): {t_mono:.2f} s")
    raw0 = torch.from_numpy(np.frombuffer(cell_blobs[0], np.uint8).reshape(1, 4096, 32).copy()).to(dev)
    poly0 = eip7594._cells_body(raw0)[1][:, 0]  # (16, 4096) Montgomery
    mono_commit = eip4844._affine_to_bytes(g1.to_affine(msm.msm_fixed(mono, fl.to_canonical(FR, poly0))))[0]
    check(mono_commit == commits[0], "the monomial table's commitment differs from blob_to_kzg_commitment")
    coeffs0 = FR.decode(poly0)
    x_mp = int.from_bytes(np.random.default_rng(SEED + 8).bytes(32), "big") % R
    x_pows = torch.from_numpy(FR.encode_host([pow(x_mp, i, R) for i in range(4096)])).to(dev)
    multi_walls, multi_launches = {}, {}
    for n_mp in (16, 64):
        proof_mp, counts, secs = counted_call(
            f"compute_kzg_proof_multi n = {n_mp}", lambda: api.compute_kzg_proof_multi(coeffs0, x_mp, n_mp, s)
        )
        multi_walls[f"prove n = {n_mp}"], multi_launches[f"prove n = {n_mp}"] = secs, counts
        folded = fl.sum_tree(FR, fl.mont_mul(FR, poly0, x_pows).reshape(16, -1, n_mp).transpose(1, 2))  # (16, n, 1)
        ys = FR.decode(fft_ops.fft(folded.reshape(16, 1, n_mp)))
        bad_ys = ys[:3] + [(ys[3] + 1) % R] + ys[4:]
        for label, values, want in (("", ys, True), (" (one value changed)", bad_ys, False)):
            ok, v_counts, v_secs = counted_call(
                f"verify_kzg_proof_multi n = {n_mp}{label}",
                lambda: api.verify_kzg_proof_multi(commits[0], proof_mp, x_mp, values, s),
            )
            check(ok is want, f"verify_kzg_proof_multi n = {n_mp}{label} returned {ok}")
            if want:
                multi_walls[f"verify n = {n_mp}"], multi_launches[f"verify n = {n_mp}"] = v_secs, v_counts
            for name in ("seg_scan_phase1", "add_unified", "ntt_tile"):
                check(v_counts[name] > 0, f"verify_kzg_proof_multi did not launch {name}")
        for name in ("seg_scan_phase1", "add_unified", "ntt_tile"):
            check(counts[name] > 0, f"compute_kzg_proof_multi did not launch {name}")
    log("multiproofs: the monomial table commits as blob_to_kzg_commitment; proofs on cosets of 16 and 64 points "
        "verify, and fail with one value changed")

    # das_extension: the even points of blob 0's extension (natural order)
    # give its odd points
    wire0 = fl.from_canonical(FR, eip7594._cells_to_limbs(cells[0], dev).reshape(16, 1, -1))
    ext0 = cuda_fft.bit_reverse(wire0)
    odd, counts, _ = counted_call("das_extension of blob 0", lambda: fft_ops.das_extension(ext0[..., 0::2]))
    check(torch.equal(odd, ext0[..., 1::2]), "das_extension differs from the extension's odd points")
    for name in ("ntt_tile", "ntt_stage"):
        check(counts[name] > 0, f"das_extension did not launch {name}")
    log("das_extension: the even points of blob 0's extension give its odd points")

    # the bench path: the headline bench with its native check, one batch-8
    # stage split of the fixed-base MSM (B6 gathers its sorted rows), and
    # the gather probe's B6 call
    headline, counts, _ = counted_call(
        f"headline bench (batch {BENCH_BATCH}, {BENCH_ITERS} iterations, native check)",
        lambda: bench.measure(table, s.setup.g1_lagrange_brp, BENCH_BATCH, BENCH_ITERS),
    )
    for name in ("seg_scan_phase1", "add_unified"):
        check(counts[name] > 0, f"the headline bench did not launch {name}")
    log(json.dumps(bench.result_line(headline["pts_per_s"])) + f" [{card}]")
    stage_in = bench.make_inputs(4096, BENCH_BATCH, 1, dev, seed=SEED + 3)
    split, counts, _ = counted_call(f"stage split (batch {BENCH_BATCH})", lambda: msm_stages.stage_split(table, stage_in))
    # one launch each in the timed pass and the synchronized pass, and B1
    # once more in the whole msm_fixed call timed beside them
    check(counts["gather_rows"] == 2 and counts["seg_scan_phase1"] == 3, f"the stage split launched {counts}")
    check(g1.xyzz_to_ints(split["result"]) == g1.xyzz_to_ints(msm.msm_fixed(table, stage_in[0])),
          "the stage split's result differs from msm_fixed's")
    msm_stages.report(BENCH_BATCH, split, card)
    probe = gather_micro.make_probe(dev)
    _, counts, _ = counted_call("gather probe B6 call", lambda: gather_micro.dg(probe))
    check(counts["gather_rows"] == 1, f"the gather probe launched {counts}")

    # legacy FK20 (the chunked-proof API) on the mainnet setup: multi at n2
    # = 8192 over blob 0's 4096 monomial coefficients, at the cells layout
    # (chunk_len 64: its files are the cells call's column tensor, and its
    # proofs are the cells call's proofs of blob 0, in the same order) and
    # at chunk_len 16 (k2 = 512: 16 files of 512, built on the card and
    # cached); single at n2 = 1024 over the first 512 coefficients (k2 =
    # 1024, the widest single whose half convolution, 525,312 lanes, stays
    # within 4x the cells call's 133,120). Proofs are checked through
    # verify_kzg_proof_multi and verify_kzg_proof (True; False with a value
    # changed).
    legacy_walls, legacy_launches = {}, {}
    ext0 = [int.from_bytes(c[32 * i : 32 * i + 32], "big") for c in cells[0] for i in range(64)]  # brp order

    def brp(i, n):
        bits = n.bit_length() - 1
        return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0

    def legacy_call(label, make, coeffs):
        fk, counts, secs = counted_call(f"legacy FK20 {label}: settings", make)
        legacy_walls[f"{label} settings"], legacy_launches[f"{label} settings"] = secs, counts
        out, counts, secs = counted_call(f"legacy FK20 {label}: data_availability", lambda: fk.data_availability(coeffs))
        legacy_walls[label], legacy_launches[label] = secs, counts
        for name in ("add_unified", "ntt_tile"):
            check(counts[name] > 0, f"legacy FK20 {label} did not launch {name}")
        check(counts["g1_ladder"] == 1, f"legacy FK20 {label} launched g1_ladder {counts['g1_ladder']} times, not once")
        return fk, native.g1_compress_batch(out)

    for chunk_len, positions in ((64, (0, 77, 127)), (16, (0, 1, 300, 511))):
        label = f"multi n2 = 8192, chunk_len {chunk_len}"
        fk, proofs_l = legacy_call(label, lambda: fk20.FK20MultiSettings(s, 8192, chunk_len), coeffs0)
        k2 = 8192 // chunk_len
        check(len(proofs_l) == k2, f"legacy FK20 {label} gave {len(proofs_l)} proofs")
        if chunk_len == 64:
            check(fk._cols is s.x_ext_fft_columns, "legacy FK20 at the cells layout built its files again")
            check(proofs_l == cell_proofs[0], "legacy FK20 at the cells layout differs from the cells call's proofs")
        for pos in positions:
            x = s.roots_of_unity[brp(pos, k2)]
            ys = trusted_setup.reverse_bit_order(ext0[chunk_len * pos : chunk_len * (pos + 1)])
            check(api.verify_kzg_proof_multi(commits[0], proofs_l[pos], x, ys, s) is True,
                  f"legacy FK20 {label}: proof {pos} fails verify_kzg_proof_multi")
        ys[3] = (ys[3] + 1) % R
        check(api.verify_kzg_proof_multi(commits[0], proofs_l[pos], x, ys, s) is False,
              f"legacy FK20 {label}: proof {pos} passes with a value changed")
        log(f"legacy FK20 {label}: {k2} proofs; {len(positions)} verify, a changed value fails"
            + ("; the proofs equal the cells call's, in the same order" if chunk_len == 64 else ""))
    coeffs1 = coeffs0[:512]
    c1 = eip4844._affine_to_bytes(g1.to_affine(msm.msm_fixed(
        mono, torch.from_numpy(fl.ints_to_limbs(coeffs1 + [0] * 3584, 16)).to(dev))))[0]
    _, proofs_1 = legacy_call("single n2 = 1024", lambda: fk20.FK20SingleSettings(s, 1024), coeffs1)
    check(len(proofs_1) == 1024, f"legacy FK20 single gave {len(proofs_1)} proofs")
    for i in (0, 1, 500, 1023):
        x = s.roots_of_unity[8 * i]  # the 1024th roots in the 8192 domain
        y = 0
        for a in reversed(coeffs1):
            y = (y * x + a) % R
        args = (x.to_bytes(32, "big"), y.to_bytes(32, "big"), proofs_1[brp(i, 1024)])
        check(api.verify_kzg_proof(c1, *args, s) is True, f"legacy FK20 single: proof {i} fails verify_kzg_proof")
    check(api.verify_kzg_proof(c1, args[0], ((y + 1) % R).to_bytes(32, "big"), args[2], s) is False,
          "legacy FK20 single: a proof passes with its value changed")
    log("legacy FK20 single n2 = 1024: 1024 proofs; 4 verify, a changed value fails")

    # the C ABI through ctypes (one commitment and one cells call, equal to
    # the API's), then the repository's C test program, unmodified, linked
    # against the shim, in a process of its own: its embedded interpreter
    # runs kzg_tpu_torch.c_abi_host on the card, reading the tables cached
    # above
    blob_c = c_abi._fill(c_abi.Blob, cell_blobs[0])
    (ret, com), counts, _ = counted_call("c_abi.blob_to_kzg_commitment", lambda: c_abi.blob_to_kzg_commitment(blob_c, s))
    check(ret == c_abi.CKzgRet.OK and bytes(com.bytes) == commits[0], f"c_abi.blob_to_kzg_commitment: {ret}")
    (ret, cl, pr), counts, _ = counted_call("c_abi.compute_cells_and_kzg_proofs",
                                            lambda: c_abi.compute_cells_and_kzg_proofs(blob_c, s))
    check(ret == c_abi.CKzgRet.OK and [bytes(c.bytes) for c in cl] == cells[0]
          and [bytes(p.bytes) for p in pr] == cell_proofs[0], f"c_abi.compute_cells_and_kzg_proofs: {ret}")
    log("c_abi: a commitment and a cells call through the ctypes structs equal the API's")
    torch.cuda.empty_cache()
    c_prog, t_c_prog = timed(lambda: c_abi_build.run_test_program(setup_path, timeout=900))
    n_ok = c_prog.stdout.count("\nok: ") + c_prog.stdout.startswith("ok: ")
    check(c_prog.returncode == 0 and "ALL C ABI TESTS PASSED" in c_prog.stdout,
          f"test_c_abi exited {c_prog.returncode}:\n{c_prog.stdout[-3000:]}\n{c_prog.stderr[-3000:]}")
    log(f"C ABI: {os.path.relpath(c_abi_build.build_dir(), repo)}/test_c_abi {os.path.relpath(setup_path, repo)}: "
        f"{n_ok} checks ok, ALL C ABI TESTS PASSED; wall {t_c_prog:.1f} s [{card}]")

    # ---- 3. checks of the result -----------------------------------------
    with open(setup_path) as f:
        tokens = f.read().split()
    lagrange_hex = tokens[2 : 2 + 4096]
    monomial_hex = tokens[2 + 4096 + 65 : 2 + 4096 + 65 + 4096]
    brp = trusted_setup.reverse_bit_order(list(range(4096)))
    known_j = [0, 1, 2, 4095]
    ka_blobs = []
    for j in known_j:
        a = bytearray(4096 * 32)
        a[32 * j + 31] = 1
        ka_blobs.append(bytes(a))
    ka_blobs.append(bytes(4096 * 32))
    ka = api.blob_to_kzg_commitment_batch(ka_blobs, s)
    for j, c in zip(known_j, ka):
        check(c == bytes.fromhex(lagrange_hex[brp[j]]), f"known answer j={j} differs")
    check(ka[-1] == b"\xc0" + bytes(47), "zero blob does not commit to infinity")
    log(f"known answers: {len(known_j)} unit blobs and the zero blob match the setup file")

    # cells and proofs of blobs holding x^(64 + k) at the bit-reversed
    # roots: cell value at wire position q is root8192_brp[q]^(64 + k); on
    # cell j's coset x^64 = c_j = root8192_brp[64 j]^64, so the quotient is
    # sum_{m <= k / 64} c_j^m x^(k - 64 m), whose commitment is g1_monomial[k]
    # for k < 64
    roots = trusted_setup.brp_roots_of_unity()
    roots_ext = trusted_setup.brp_roots_of_unity(8192)
    g1m = s.setup.g1_monomial
    known_k = [0, 1, 4031]
    ka7_blobs = [b"".join(pow(w, 64 + k, R).to_bytes(32, "big") for w in roots) for k in known_k]
    ka7_cells, ka7_proofs = api.compute_cells_and_kzg_proofs_batch(ka7_blobs + [bytes(4096 * 32)], s)
    for k, kc, kp in zip(known_k, ka7_cells, ka7_proofs):
        want_cells = b"".join(pow(w, 64 + k, R).to_bytes(32, "big") for w in roots_ext)
        check(b"".join(kc) == want_cells, f"cells of x^(64+{k}) differ from the known answer")
        if k < 64:
            want = [bytes.fromhex(monomial_hex[k])] * 128
        else:
            want_pts = []
            for j in range(128):
                cj = pow(roots_ext[64 * j], 64, R)
                acc = None
                for m in range(k // 64 + 1):
                    acc = native.g1_add(acc, native.g1_mul(g1m[k - 64 * m], pow(cj, m, R)))
                want_pts.append(acc)
            want = native.g1_compress_batch(want_pts)
        check(kp == want, f"proofs of x^(64+{k}) differ from the known answer")
    check(all(c == bytes(2048) for c in ka7_cells[-1]), "the zero blob's cells are not zero")
    check(all(p == b"\xc0" + bytes(47) for p in ka7_proofs[-1]), "the zero blob's proofs are not infinity")
    log(f"known answers: cells and all 128 proofs of x^(64+k), k in {known_k}, and of the zero blob")

    cpu_s = TorchKZGSettings(s.setup, torch.device("cpu"))
    cpu_s.lagrange_table = msm.FixedBaseTable(*(t.cpu() for t in table[:3]), table.c)
    (c_cpu, p_cpu), t_cpu = timed(
        lambda: (
            api.blob_to_kzg_commitment(blobs[0], cpu_s),
            api.compute_blob_kzg_proof(blobs[0], commits[0], cpu_s),
        )
    )
    check(c_cpu == commits[0], "commitment differs from the CPU path")
    check(p_cpu == proofs[0], "proof differs from the CPU path")
    log(f"CPU cross-check of one commitment and one proof: equal ({t_cpu:.1f} s on the host)")

    # the 2048-cell verification's four device points (its two
    # variable-base MSMs, the aggregation, the column iFFTs and the
    # interpolation commitment) and the 64-blob verification's two lincombs
    # (one batch-2 variable-base MSM over 129 points), on the card and
    # through the plain versions on a CPU copy
    cb, idx, cl, pr = verify_cases[N_CELL_BLOBS * 128]
    unique_cb, cidx = eip7594._deduplicate_with_indices(cb)
    r_cells = eip7594._batch_challenge_bytes(unique_cb, cidx, idx, cl, pr)
    cell_inputs = eip7594._verify_cell_inputs(unique_cb, cidx, idx, cl, pr, r_cells, dev)
    cpu_s.monomial64_table = msm.FixedBaseTable(*(t.cpu() for t in s.monomial64_table[:3]), s.monomial64_table.c)

    def to_cpu(x):
        return type(x)(*(t.cpu() for t in x)) if isinstance(x, tuple) else x.cpu()

    on_card = g1.affine_to_ints(eip7594._verify_cell_body(*cell_inputs, s))
    on_cpu, t_cpu = timed(lambda: g1.affine_to_ints(eip7594._verify_cell_body(*map(to_cpu, cell_inputs), cpu_s)))
    check(on_card == on_cpu, "the 2048-cell verification's points differ from the CPU path")
    lin_inputs = eip4844._lincomb_inputs(blobs, commits, proofs, s)
    lin_card = g1.affine_to_ints(eip4844._lincomb_body(*lin_inputs))
    lin_cpu = g1.affine_to_ints(eip4844._lincomb_body(*map(to_cpu, lin_inputs)))
    check(lin_card == lin_cpu, "the 64-blob verification's lincombs differ from the CPU path")
    log(f"CPU cross-check of the 2048-cell verification's four points ({t_cpu:.1f} s on the host) "
        f"and the {N_BLOBS}-blob verification's two lincombs: equal")

    n_pair = 8
    for i in range(n_pair):
        z = eip4844.compute_challenge(blobs[i], commits[i])
        y = host_eval(blobs[i], z, roots)
        c_pt, p_pt = native.g1_decompress_batch(commits[i] + proofs[i])
        check(eip4844._check_proof_single(s, c_pt, p_pt, z, y), f"proof {i} fails the pairing check")
    log(f"pairing: {n_pair} of {N_BLOBS} proofs verify")

    # cell proofs: e(C - [I_j(s)] + c_j pi_j, G2) == e(pi_j, [s^64]_2)
    g2_gen = eip4844.G2_GENERATOR
    pair_cells = [(0, 0), (0, 77), (5, 127), (15, 31)]
    for b, j in pair_cells:
        c_pt = native.g1_decompress_batch(commits[b])[0]
        pi = native.g1_decompress_batch(cell_proofs[b][j])[0]
        vals = [int.from_bytes(cells[b][j][32 * i : 32 * i + 32], "big") for i in range(64)]
        coeffs = cell_interpolant(vals, roots_ext[64 * j])
        i_s = None
        for m, a in enumerate(coeffs):
            i_s = native.g1_add(i_s, native.g1_mul(g1m[m], a))
        neg_i = None if i_s is None else (i_s[0], (P_MOD - i_s[1]) % P_MOD)
        cj = pow(roots_ext[64 * j], 64, R)
        lhs = native.g1_add(native.g1_add(c_pt, neg_i), native.g1_mul(pi, cj))
        check(native.pairings_verify(lhs, g2_gen, pi, s.g2_monomial[64]), f"cell proof ({b}, {j}) fails the pairing check")
        bad = native.g1_add(lhs, g1m[0])
        check(not native.pairings_verify(bad, g2_gen, pi, s.g2_monomial[64]), "a wrong cell passes the pairing check")
    log(f"pairing: {len(pair_cells)} cell proofs verify against their blobs' commitments")

    # ---- 4. the kernel table ------------------------------------------------
    # One row a kernel: its input at the timed shape, the kernel call, the
    # plain call and the bound, and the other shapes the main paths give
    # the kernel where no end-to-end check above stands in for its plain
    # version. kernel_row holds the kernel against the plain version at
    # each before it times either, so that no row times a wrong kernel;
    # edge cases are the `gpu` tests'. A new kernel adds one row here (and
    # one NO_SPILL entry).
    rows_out = []

    def kernel_row(name, source, replaces, launches, bound, checks=(), reps=20, plain_reps=3,
                   queue_ahead=False, plain_queue_ahead=False, library=None, canon=lambda out: out):
        """`launches`: the (kernel, plain) calls the row times, each timed
        alone and the times summed; `checks`: (kernel, plain) calls at more
        shapes, not timed. bound(the first launch's output) -> (bound ms,
        what bounds it, a note for the log). Tolerance: exact, as both
        sides reduce every limb fully, on the outputs as `canon` gives
        them (affine points where the kernel adds in another order). With `queue_ahead`
        (`plain_queue_ahead`) the kernel's (the plain version's) launches
        are queued ahead of the timed window (kernels shorter than their
        wrapper's host overhead)."""
        err = 0
        for k, (kernel, plain) in enumerate((*launches, *checks)):
            got = kernel()
            if k == 0:
                bound_ms, by, note = bound(got)
            e = max_abs_err(canon(got), canon(plain()))
            check(e == 0, f"{name}: kernel and plain version differ at input {k} (max abs limb error {e})")
            err = max(err, e)
            del got
        each = [cuda_ms(kernel, reps, queue_ahead) for kernel, _ in launches]
        ms = sum(each)
        plain_ms = sum(cuda_ms(plain, plain_reps, plain_queue_ahead) for _, plain in launches)
        library_ms = None if library is None else cuda_ms(library, reps, queue_ahead)
        rows_out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": None,  # the main path's and the ranks', filled in below
                         "max_abs_err": err, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                         "bound_ms": round(bound_ms, 4), "bound_by": by,
                         "library_ms": None if library_ms is None else round(library_ms, 4)})
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        split = "" if len(each) == 1 else " (" + " + ".join(f"{t:.4f}" for t in each) + ")"
        log(f"{name}: exact at {len(launches) + len(checks)} inputs; {ms:.4f} ms{split} (plain {plain_ms:.4f} ms{lib}); "
            f"bound {bound_ms:.4f} ms, {by}, {bound_ms / ms:.0%} of it; {note} [{card}]")

    # B1 at the 64-blob scan, and at the FK20 column MSM of the 16 cell
    # blobs (the column tables: each column its own point set); its bound
    # counts the 10 products of a step and the 7 more of a step that
    # doubles (the earlier design's 17 a step beside it)
    raw64 = torch.from_numpy(np.frombuffer(b"".join(blobs), np.uint8).reshape(N_BLOBS, 4096, 32).copy()).to(dev)
    rows64, idx64, first64 = msm.phase1_inputs(table, eip4844._bytes_to_limbs(raw64)[0])
    K64, m64 = idx64.shape
    raw16 = raw64[:N_CELL_BLOBS]
    poly16 = eip7594._cells_body(raw16)[1]
    rows_c, idx_c, first_c = msm.phase1_inputs(col_tables, eip7594.column_scalars(poly16, 64))

    def b1_bound(sums):
        E = N_BLOBS * 20 * 4096  # elements the data needs (the rest is padding)
        n_mdbl = mdbl_steps(rows64, idx64, first64, sums)
        ops = (E * cuda_msm.MADD_FMULS_DISTINCT + n_mdbl * cuda_msm.MDBL_FMULS) * MULADDS_PER_FMUL / peak_imad * 1e3
        nbytes = (rows64.numel() * 4 + idx64.numel() * 4 + first64.numel()
                  + 4 * 24 * 4 * idx64.numel()) / HBM_BYTES_PER_S * 1e3
        ops17 = E * cuda_msm.MADD_FMULS * MULADDS_PER_FMUL / peak_imad * 1e3
        return (*roof(ops, nbytes), f"K={K64} m={m64}, {E} elements, {n_mdbl} steps double, "
                f"{cuda_msm.SCAN_GROUP} warps a block; operations {ops:.4f} ms at {cuda_msm.MADD_FMULS_DISTINCT} "
                f"products a step, bytes {nbytes:.4f} ms; at all {cuda_msm.MADD_FMULS} products a step {ops17:.4f} ms; "
                f"also exact at the column MSM, K={idx_c.shape[0]} m={idx_c.shape[1]}")

    kernel_row("seg_scan_phase1", "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:94",
               [(lambda: cuda_msm.seg_scan_phase1_mem(rows64, idx64, first64),
                 lambda: cuda_msm.seg_scan_phase1_mem_ref(rows64, idx64, first64))], b1_bound,
               checks=[(lambda: cuda_msm.seg_scan_phase1_mem(rows_c, idx_c, first_c),
                        lambda: cuda_msm.seg_scan_phase1_mem_ref(rows_c, idx_c, first_c))], plain_reps=1)
    del rows_c, idx_c, first_c

    # B2 at the 64-blob scan's 32,768 chunk sums, each added to its
    # neighbour's; the bound counts the 14 products of every lane and the 9
    # of the doubling in the lanes that take it (the earlier design's 23 in
    # every lane beside it)
    q2 = g1.map_coords(lambda c: c[:, K64 - 1, :].contiguous(), cuda_msm.seg_scan_phase1_mem(rows64, idx64, first64))
    p2 = g1.map_coords(lambda c: torch.roll(c, 1, dims=-1).contiguous(), q2)
    del raw64, rows64, idx64, first64

    def b2_bound(_):
        M = p2.x.shape[-1]
        n_dbl = doubling_lanes(p2, q2)
        ops = (M * cuda_msm.ADD_FMULS_DISTINCT + n_dbl * cuda_msm.DBL_FMULS) * MULADDS_PER_FMUL / peak_imad * 1e3
        nbytes = 12 * 24 * 4 * M / HBM_BYTES_PER_S * 1e3
        ops23 = M * cuda_msm.ADD_FMULS * MULADDS_PER_FMUL / peak_imad * 1e3
        return (*roof(ops, nbytes), f"{M} lanes, {n_dbl} doubling, g = {cuda_msm.GROUP}; operations {ops:.4f} ms, "
                f"bytes {nbytes:.4f} ms; all 23 products in every lane {ops23:.4f} ms")

    kernel_row("add_unified", "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:209",
               [(lambda: cuda_msm.add_points(p2, q2), lambda: cuda_msm.add_points_ref(p2, q2))], b2_bound,
               reps=50, queue_ahead=True)

    # B3 at the 2048-cell call's proof MSM (2 MSMs, c = 13, 20 windows),
    # and at its commitment MSM (1 MSM, c = 8, 32 windows). Bounds: the
    # card's throughput (operations over every SM's multiply-add rate, or
    # bytes), and in the note the latency of the dependent chain at one
    # multiply-add a clock: (w - 1)(3 c + 4) product rounds deep, and
    # (w - 1)(9 c + 23) products for one thread running them all (the
    # earlier design)
    c3 = msm.default_window(cell_inputs[0].x.shape[-1], fixed_base=False)
    win3 = msm.window_sums(cell_inputs[0], cell_inputs[1], c3)
    check(c3 == 13 and tuple(win3.x.shape) == (24, 2, 20), f"unexpected proof MSM windows c={c3} {tuple(win3.x.shape)}")
    c_c = msm.default_window(cell_inputs[2].x.shape[-1], fixed_base=False)
    win_c = msm.window_sums(cell_inputs[2], cell_inputs[3], c_c)
    check(c_c == 8 and tuple(win_c.x.shape) == (24, 1, 32), f"unexpected commitment MSM windows c={c_c} {tuple(win_c.x.shape)}")

    def b3_bound(_):
        nb, w = win3.x.shape[1:]
        prods = (w - 1) * (cuda_msm.DBL_FMULS * c3 + cuda_msm.ADD_FMULS)
        rounds = (w - 1) * (cuda_msm.DBL_DEPTH * c3 + cuda_msm.ADD_DEPTH)
        ops = nb * (w - 1) * (cuda_msm.DBL_FMULS * c3 + cuda_msm.ADD_FMULS_DISTINCT) * MULADDS_PER_FMUL / peak_imad * 1e3
        nbytes = 4 * 24 * 4 * nb * (w + 1) / HBM_BYTES_PER_S * 1e3  # w windows in, one point out
        t_lat = rounds * MULADDS_PER_FMUL / (sm_clock_mhz * 1e6) * 1e3
        t_one = prods * MULADDS_PER_FMUL / (sm_clock_mhz * 1e6) * 1e3
        return (*roof(ops, nbytes), f"{nb} MSMs, c = {c3}, {w} windows, g = {cuda_msm.GROUP}; operations {ops:.5f} ms, "
                f"bytes {nbytes:.6f} ms; latency bound {t_lat:.4f} ms ({rounds} dependent product rounds); the "
                f"earlier design's latency bound {t_one:.4f} ms ({prods} products on one thread); "
                f"{MULADDS_PER_FMUL} multiply-adds a product at {sm_clock_mhz:.0f} MHz; also exact at the "
                f"commitment MSM, c = {c_c}, {win_c.x.shape[2]} windows")

    kernel_row("horner", "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:307",
               [(lambda: cuda_msm.horner_windows(win3, c3), lambda: cuda_msm.horner_windows_ref(win3, c3))], b3_bound,
               checks=[(lambda: cuda_msm.horner_windows(win_c, c_c), lambda: cuda_msm.horner_windows_ref(win_c, c_c))],
               plain_reps=2)

    # B9 at the commitment MSM of 6 blobs (6 rows of 4097 buckets, c = 13,
    # the Lagrange table) and at the FK20 column MSM of 18 blobs (2304 rows
    # of 129, c = 8, the column tables), each on the bucket sums the MSM
    # gives it, held against the plain version as affine points (its
    # additions run in another order, so its XYZZ coordinates differ); also
    # exact at the 9-blob FK20 column MSM (1152 rows) and at the verify
    # lincomb's 2 x 37 (batch, window) rows of 65. Bound: operations, 2 (B
    # - 1) additions a row at the 14 products of an addition without its
    # doubling, or the least chain of any order of those additions, a
    # suffix scan and a tree sum over the buckets (2 log2 B additions of 4
    # product rounds, each round a product's 588 dependent multiply-adds at
    # the clock); this design's own chain is in the note
    def fixed_buckets(tab, scalars):
        rows_p, lay, n_keys, nb, _ = msm._fixed_inputs(tab, scalars)
        return g1.map_coords(lambda c: c.reshape(24, nb, -1), msm._bucket_sums_mem(rows_p, lay, n_keys))

    raw18 = torch.from_numpy(np.frombuffer(b"".join(blobs[:18]), np.uint8).reshape(18, 4096, 32).copy()).to(dev)
    buckets_commit = fixed_buckets(table, eip4844._bytes_to_limbs(raw18[:6])[0])
    poly18 = eip7594._cells_body(raw18)[1]
    buckets_fk20 = fixed_buckets(col_tables, eip7594.column_scalars(poly18, 64))
    buckets_fk20_9 = fixed_buckets(col_tables, eip7594.column_scalars(poly18[:, :9], 64))
    win_b = msm._var_inputs(cell_inputs[0], cell_inputs[1], 7)
    buckets_var = g1.map_coords(lambda c: c.reshape(24, win_b[3] * win_b[4], -1),
                                msm._bucket_sums_mem(win_b[0], win_b[1], win_b[2]))
    check(tuple(buckets_commit.x.shape) == (24, 6, 4097) and tuple(buckets_fk20.x.shape) == (24, 2304, 129)
          and tuple(buckets_var.x.shape[1:]) == (74, 65),
          f"unexpected bucket shapes {tuple(buckets_commit.x.shape)} {tuple(buckets_fk20.x.shape)} "
          f"{tuple(buckets_var.x.shape)}")
    del raw18, poly18

    def b9_bound(_):
        ops = least = 0.0
        chains = []
        for bk in (buckets_commit, buckets_fk20):
            rows, B = bk.x.shape[1:]
            ops += rows * 2 * (B - 1) * cuda_msm.ADD_FMULS_DISTINCT * MULADDS_PER_FMUL / peak_imad * 1e3
            least += 2 * (B - 1).bit_length() * cuda_msm.ADD_DEPTH * MULADDS_PER_FMUL / (sm_clock_mhz * 1e6) * 1e3
            plan = cuda_msm.integrate_plan(rows, B, n_sm)
            chains.append(f"{rows} x {B}: grid {plan}, {sum(cuda_msm.integrate_rounds(*plan))} rounds")
        return (max(ops, least), "operations" if ops >= least else "latency",
                f"operations {ops:.4f} ms, least chain {least:.4f} ms; this design's chains: " + "; ".join(chains)
                + "; also exact at the 9-blob FK20 column MSM (1152 x 129) and the verify lincomb (74 x 65)")

    integ_canon = lambda p: g1.to_affine(p)
    kernel_row("integrate", "kzg_tpu_torch/csrc/msm_kernels.cu", None,
               [(lambda bk=bk: cuda_msm.integrate_buckets(bk),
                 lambda bk=bk: g1.map_coords(lambda c: c[..., 0], cuda_msm.integrate_buckets_ref(bk)))
                for bk in (buckets_commit, buckets_fk20)], b9_bound,
               checks=[(lambda bk=bk: cuda_msm.integrate_buckets(bk),
                        lambda bk=bk: g1.map_coords(lambda c: c[..., 0], cuda_msm.integrate_buckets_ref(bk)))
                       for bk in (buckets_fk20_9, buckets_var)], plain_reps=1, canon=integ_canon)
    del buckets_commit, buckets_fk20, buckets_fk20_9, buckets_var

    # B4 and B5 at the launches of one 16-blob cells call: the inverse 4096
    # and the forward 8192 of the 16 blobs, the 64 x 128 Toeplitz
    # transforms, each launch timed alone; each bound is the sum of the
    # launches' bounds (64 bytes an Fr value, the wrappers' (16, ...) int32
    # layout; the note gives the bytes at 32, a packed layout)
    gen = np.random.default_rng(SEED + 2)
    toeplitz = [int.from_bytes(gen.bytes(32), "little") % R for _ in range(N_CELL_BLOBS * 64 * 128)]
    ntt_in = [(cuda_fft.bit_reverse(fl.from_canonical(FR, eip4844._bytes_to_limbs(raw16)[0])).contiguous(), True),
              (torch.cat([poly16, torch.zeros_like(poly16)], dim=-1).contiguous(), False),
              (torch.from_numpy(FR.encode_host(toeplitz).reshape(16, N_CELL_BLOBS * 64, 128)).to(dev), False)]
    stage_in = []
    for x, inverse in ntt_in:
        log_n = x.shape[-1].bit_length() - 1
        y = cuda_fft.ntt_tile(x, inverse)
        stage_in += [(y, st, inverse) for st in range(cuda_fft.tile_stages(log_n), log_n)]
    del raw16, poly16

    def ntt_bound(launches):
        """Bound of launches [(B, n, products)], each at its own bound."""
        terms = [(*fft_times_ms(B, n, prods, peak_imad), fft_times_ms(B, n, prods, peak_imad, FR_BYTES)[1])
                 for B, n, prods in launches]
        ops, nbytes, bytes32 = (sum(t[k] for t in terms) for k in range(3))
        bound32 = sum(max(o, b32) for o, _, b32 in terms)
        return (sum(max(o, b) for o, b, _ in terms), "operations" if ops >= nbytes else "bytes",
                f"{len(launches)} launches; operations {ops:.4f} ms, bytes {nbytes:.4f} ms at 64 B/value, "
                f"{bytes32:.4f} ms at 32 B/value; the bound at 32 B/value {bound32:.4f} ms")

    def b4_products(x, inverse):
        B, n = x.shape[1:]
        S = cuda_fft.tile_stages(n.bit_length() - 1)
        return B, n, B * ((n // 2) * (S - 1) + (n if inverse else 0))  # stage 0's twiddle is one

    kernel_row("ntt_tile", "kzg_tpu_torch/csrc/fft_kernels.cu", "kzg_tpu/ops/pallas_fft.py:179",
               [(lambda x=x, inv=inv: cuda_fft.ntt_tile(x, inv), lambda x=x, inv=inv: cuda_fft.ntt_tile_ref(x, inv))
                for x, inv in ntt_in],
               lambda _: ntt_bound([b4_products(x, inverse) for x, inverse in ntt_in]), queue_ahead=True)
    kernel_row("ntt_stage", "kzg_tpu_torch/csrc/fft_kernels.cu", "kzg_tpu/ops/pallas_fft.py:255",
               [(lambda y=y, st=st, inv=inv: cuda_fft.ntt_stage(y, st, inv),
                 lambda y=y, st=st, inv=inv: cuda_fft.ntt_stage_ref(y, st, inv)) for y, st, inv in stage_in],
               lambda _: ntt_bound([(*y.shape[1:], y.shape[1] * y.shape[2] // 2) for y, _, _ in stage_in]),
               queue_ahead=True)
    del ntt_in, stage_in

    # B6 at the gather probe's shape, beside the library call index_select
    # (also its plain version), and at the fixed-base MSM's (batch 8: the
    # 25-word sorted rows B1 reads); launches queued ahead, sharing one
    # out-of-range flag read after the timing
    flag = cuda_gather.new_flag(dev)
    tab6, idx6 = probe["slice"], probe["src_mod"]
    msm_in = gather_micro.msm_probe(table, BENCH_BATCH)
    kernel_row("gather_rows", "kzg_tpu_torch/csrc/gather_kernels.cu", "benches/gather_micro.py:182",
               [(lambda: cuda_gather.gather_rows(tab6, idx6, flag), lambda: cuda_gather.gather_rows_ref(tab6, idx6))],
               lambda _: (gather_micro.bound_ms(tab6.shape[1], idx6), "bytes",
                          f"{idx6.numel()} rows of {tab6.shape[1]} words from {tab6.shape[0]}; also exact at the "
                          f"MSM's {msm_in['idx'].numel()} rows of {msm_in['rows'].shape[1]} words"),
               checks=[(lambda: cuda_gather.gather_rows(msm_in["rows"], msm_in["idx"], flag),
                        lambda: cuda_gather.gather_rows_ref(msm_in["rows"], msm_in["idx"]))],
               plain_reps=20, queue_ahead=True, plain_queue_ahead=True, library=lambda: tab6.index_select(0, idx6))
    cuda_gather.raise_if_flagged(flag)
    del msm_in

    # B7 at one Fp lane (to_affine's root), and at the main paths' other
    # inversions: Fp at 1152 lanes, Fr at 1152 and at the cell verifier's
    # 64 x 1 (the Fr instance is its own compiled body). Bound: latency,
    # the least chain of dependent products for a^(m-2) at one multiply-add
    # a clock: a 4-bit fixed window (4 squarings a window after the first,
    # one multiplication a nonzero window; its table left out), each
    # squaring at a dedicated squaring's multiply-adds. This design's own
    # chain (left to right over the bits: (bits - 1) squarings and (ones -
    # 1) multiplications, each a full product) and the throughput bound are
    # in the note.
    gen = np.random.default_rng(SEED + 13)
    fp_one = FP.encode([int.from_bytes(gen.bytes(48), "big") % P_MOD], dev)
    inv_checks = [(spec, spec.encode([int.from_bytes(gen.bytes(48), "big") % spec.modulus for _ in range(n)],
                                     dev).reshape((spec.n_limbs,) + shape))
                  for spec, n, shape in ((FP, 1152, (1152,)), (FR, 1152, (1152,)), (FR, 64, (64, 1)))]

    def b7_bound(_):
        e, words = P_MOD - 2, FP.n_limbs // 2
        mul = words * (4 * words + 1)
        sqr = words * (3 * words + 2)  # s(s + 1)/2 distinct products, lo and hi, then the reduction's 2 s^2 + s
        windows = [(e >> (4 * k)) & 15 for k in range(-(-e.bit_length() // 4))]
        least = 4 * (len(windows) - 1) * sqr + (sum(1 for w in windows[:-1] if w) * mul)
        prods = e.bit_length() + bin(e).count("1") - 2
        clock = sm_clock_mhz * 1e6
        return (least / clock * 1e3, "latency", f"least chain: {least} dependent multiply-adds, {sqr} a squaring and "
                f"{mul} a product, at {sm_clock_mhz:.0f} MHz; this design's chain {prods * mul / clock * 1e3:.4f} ms "
                f"({prods} products); throughput bound {prods * mul / peak_imad * 1e3:.6f} ms; also exact at "
                + ", ".join(f"{spec.name} {tuple(a.shape)}" for spec, a in inv_checks))

    kernel_row("field_inv", "kzg_tpu_torch/csrc/field_kernels.cu", None,
               [(lambda: fl.inv(FP, fp_one), lambda: fl.pow_fixed(FP, fp_one, P_MOD - 2))], b7_bound,
               checks=[(lambda spec=spec, a=a: fl.inv(spec, a), lambda spec=spec, a=a: fl.pow_fixed(spec, a, spec.modulus - 2))
                       for spec, a in inv_checks], plain_reps=2)
    del inv_checks

    # B8 at the 9-blob half convolution (EIP-7691's block, as the cells and
    # recovery calls run it: 1152 points, 65 taps, two GLV tables, lanes
    # through src; the points are column points, as timing does not depend
    # on them), and without src on one table: at the last stage of the
    # column points' G1 FFT (64 x 128: 4096 lanes, 64 digit columns) and
    # at an inverse's 1/n scale (n = 128; 8192 lanes, one digit column). Bound:
    # operations, w c doublings and w T additions a lane at their products
    # (9 and 14; the doubling fallback and phi's product of x by beta left
    # out, as a stored phi table would avoid it)
    col_pts = g1.from_affine(g1.map_coords(lambda c: c.flatten(-2).contiguous(), s.x_ext_fft_columns))  # (24, 8192)
    pts8 = g1.map_coords(lambda c: c[..., : 9 * 128].contiguous(), col_pts)
    mult8 = g1fft._multiples(pts8, g1fft._TABLE - 1)
    digits8, src8 = g1fft._half_conv_lanes(128, 9, str(dev))
    stage_mult = g1fft._multiples(g1.map_coords(lambda c: c[..., :4096].contiguous(), col_pts), g1fft._TABLE - 1)
    stage_digits = g1fft._stage_digits(7, False, 6, str(dev))
    scale_mult = g1fft._multiples(col_pts, g1fft._TABLE - 1)
    scale_digits = g1fft._scale_digits(128, str(dev))

    def b8_bound(_):
        T, w, _ = digits8.shape
        prods = w * g1fft.TWIDDLE_WINDOW * cuda_msm.DBL_FMULS + w * T * cuda_msm.ADD_FMULS_DISTINCT
        return (src8.numel() * prods * MULADDS_PER_FMUL / peak_imad * 1e3, "operations",
                f"{src8.numel()} lanes, {w} windows, {T} tables, {pts8.x.shape[-1]} points; {prods} products a lane; "
                f"also exact at a G1 FFT stage (digits {tuple(stage_digits.shape)}) and a 1/n scale (digits "
                f"{tuple(scale_digits.shape)})")

    kernel_row("g1_ladder", "kzg_tpu_torch/csrc/g1fft_kernels.cu", None,
               [(lambda: g1fft.ladder(mult8, digits8, src8), lambda: g1fft.ladder_ref(mult8, digits8, src8))], b8_bound,
               checks=[(lambda: g1fft.ladder(stage_mult, stage_digits), lambda: g1fft.ladder_ref(stage_mult, stage_digits)),
                       (lambda: g1fft.ladder(scale_mult, scale_digits), lambda: g1fft.ladder_ref(scale_mult, scale_digits))],
               reps=10, plain_reps=1)
    del mult8, stage_mult, scale_mult

    # ---- 5. multi-device ---------------------------------------------------
    # Ranks of one gloo process group in processes of their own (spawned by
    # kzg_tpu_torch.parallel.dryrun.launch), every rank computing on this
    # card: NCCL refuses two ranks on one card; with a card a rank, the same
    # code runs under NCCL (torchrun). The kernels, the native core and the
    # Lagrange table's cache were built above, so the ranks only load them.
    from kzg_tpu_torch.parallel import dryrun

    torch.cuda.empty_cache()
    log(f"multi-device: backend gloo, every rank on {dev}; the ranks share this card and its host")
    mesh_runs = {}

    def mesh_launch(label, program, n_procs, args):
        ranks, secs = timed(lambda: dryrun.launch(program, n_procs, str(dev), args, timeout=400))
        mesh_runs[label] = (n_procs, secs, ranks)
        log(f"{label}: {n_procs} ranks in {secs:.1f} s with start-up (gloo)")
        for r, res in enumerate(ranks):
            log(f"  rank {r}: " + "; ".join(f"{k} {v:.3f} s" for k, v in res["walls"].items()))
            log(f"  rank {r}: launches {res['launches']}; peak device memory {res['peak_bytes'] / 2**30:.2f} GiB [{card}]")
            for name, k in res["launches"].items():
                main_launches[name] += k
        return ranks

    mesh_launch("mesh entry points (blobs_mesh, 2 ranks)", mesh_entry_points, 2, (blobs, commits, proofs))
    for r, res in enumerate(mesh_runs["mesh entry points (blobs_mesh, 2 ranks)"][2]):
        for name in ("seg_scan_phase1", "add_unified", "horner"):
            check(res["launches"][name] > 0, f"rank {r} of the mesh entry points launched no {name}")
    log(f"mesh entry points: {N_BLOBS} commitments byte-equal to the single-process ones; verification True, "
        f"False with two proofs swapped; {N_BLOBS - 1} blobs padded as without the mesh; a non-canonical blob "
        f"raises ValueError on both ranks")
    # the ranks' results are held against the plain versions on a CPU copy
    sc_m, pts_m, x_m = map(to_cpu, mesh_inputs(s, dev))
    want, t_want = timed(lambda: {
        "fixed": g1.xyzz_to_ints(msm.msm_fixed(cpu_s.lagrange_table, sc_m)),
        "var": g1.xyzz_to_ints(msm.msm(pts_m, sc_m[:, 0])),
        "fft": fl.limbs_to_ints(fft_ops.fft(x_m)), "ifft": fl.limbs_to_ints(fft_ops.ifft(x_m))})
    want = json.loads(json.dumps(want))  # as the ranks' JSON gives them: points as [x, y] lists
    log(f"the mesh programs' single-process results on the CPU copy: {t_want:.1f} s on the host")
    ranks4 = mesh_launch("mesh programs (global_mesh 2 x 2, 4 ranks)", mesh_programs, 4, ())
    for r, res in enumerate(ranks4):
        for key, value in want.items():
            check(res[key] == value, f"rank {r}: the sharded {key} differs from the single-process function")
        for name in ("seg_scan_phase1", "add_unified", "horner", "ntt_tile"):
            check(res["launches"][name] > 0, f"rank {r} of the mesh programs launched no {name}")
    log(f"mesh programs: the dry run's programs at its small shapes; msm_fixed_sharded ({MESH_ROWS} x 4096, c = 13) "
        f"and msm_sharded (4096 setup points) affine-equal to msm_fixed and msm; fft_sharded and ifft_sharded at "
        f"8192 limb-equal to fft and ifft (all four on the CPU copy), and they round-trip")

    for row in rows_out:
        row["launches"] = main_launches[row["name"]]
    for label, secs in verify_walls.items():
        log(f"verify {label}: {secs:.3f} s, peak device memory {verify_peaks[label] / 2**30:.2f} GiB; "
            f"launches {verify_launches[label]} [{card}]")
    for label, secs in recover_walls.items():
        peak = f", peak device memory {recover_peaks[label] / 2**30:.2f} GiB" if label in recover_peaks else ""
        log(f"recover {label}: {secs:.3f} s{peak}; launches {recover_launches[label]} [{card}]")
    for label, secs in multi_walls.items():
        log(f"multiproof {label}: {secs:.3f} s; launches {multi_launches[label]} [{card}]")
    for label, secs in legacy_walls.items():
        log(f"legacy FK20 {label}: {secs:.3f} s; launches {legacy_launches[label]} [{card}]")
    log(f"C ABI test program: {t_c_prog:.1f} s [{card}]")
    for label, (n_procs, secs, ranks) in mesh_runs.items():
        walls = {k: max(res["walls"][k] for res in ranks) for k in ranks[0]["walls"]}
        log(f"{label}: {secs:.1f} s with start-up; slowest rank's walls "
            + "; ".join(f"{k} {v:.3f} s" for k, v in walls.items())
            + f"; peak device memory a rank up to {max(res['peak_bytes'] for res in ranks) / 2**30:.2f} GiB [{card}]")
    log(f"main path launches: {main_launches}")
    log(f"peak device memory: EIP-4844 main path {peak_mem / 2**30:.2f} GiB; "
        f"EIP-7594 {N_CELL_BLOBS}-blob call {peak_mem_cells / 2**30:.2f} GiB")
    log(f"EIP-7594 {N_CELL_BLOBS}-blob call {t_cells:.3f} s ({t_cells / N_CELL_BLOBS * 1e3:.1f} ms/blob); "
        f"total {time.perf_counter() - t_all:.0f} s")

    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
