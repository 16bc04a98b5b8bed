#!/usr/bin/env python3
"""Drive kzg_tpu_torch on one NVIDIA GPU and check it, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. card and builds: the card's name and power limit, torch and CUDA
     versions; build the CUDA kernels (one nvcc per source; registers and
     spills printed; B1, B2, B3, B7 and B8 must not spill, and B7 has no
     stack), the native host
     core and the C ABI (the embedded-interpreter shim and the C test
     program), all at the same time;
  2. the main paths at full protocol width, through the public API, with
     the kernels' launch counts zeroed before each call and read after it:
     EIP-4844: load the mainnet setup on the card, found with no path
     given (builds the 20 x 4096 fixed-base table), commit to 64 seeded
     random blobs and prove them;
     EIP-7594: build the FK20 column points and their c = 8 tables on the
     card, compute the cells and proofs of 16 seeded blobs in one batch
     call (one launch of B8, FK20's ladders, a chunk), then the cells of
     each blob through compute_cells;
     verification: all 2048 cells and proofs of those 16 blobs in one
     verify_cell_kzg_proof_batch call (a supernode's or a builder's check
     of a block), then a sampling node's 8 columns of them (128 cells),
     and verify_blob_kzg_proof_batch on the 64 blobs: True; False with a
     cell changed, two proofs swapped, a proof of another blob; a
     non-canonical blob raises;
     recovery: three of the 16 cell blobs from a seeded random 64 of their
     cells, from cells 0-63 and from all 128 (proofs only), and one
     recover_cells_and_kzg_proofs_batch call of nine more (one recovery
     pass, one launch of B8): cells and proofs byte-equal to the cells
     call's; 63 cells raise before any launch;
     multiproofs: the whole monomial table (c = 13, 20 x 4096, built on
     the card), whose commitment to a blob's monomial coefficients equals
     blob_to_kzg_commitment; proofs of those 4096 coefficients on cosets
     of 16 and 64 points verify, and fail with one value changed;
     das_extension of a blob's extension's even points gives its odd ones;
     the bench path: the headline bench (kzg_tpu_torch.bench) at batch 8
     and 3 iterations with its native check, one batch-8 stage split of
     the fixed-base MSM (kzg_tpu_torch.benches.msm_stages, with kernel
     B6's gather) and the gather probe's B6 call;
     legacy FK20: multi at n2 = 8192 over blob 0's monomial coefficients
     at chunk_len 64 (the cells layout: its files are the cells call's
     column points, its proofs the cells call's) and 16 (k2 = 512), single
     at n2 = 1024 (k2 = 1024): proofs verify through
     verify_kzg_proof_multi and verify_kzg_proof, and fail with a value
     changed;
     the C ABI: a commitment and a cells call through the ctypes structs
     (equal to the API's), then the repository's C test program
     (native/test_c_abi.c, unmodified) linked against the shim, run on the
     mainnet setup in a process of its own: ALL C ABI TESTS PASSED;
  3. each kernel against its plain PyTorch version, limb for limb, at the
     main paths' shapes (kernel on the card, plain version on a CPU copy
     or on the card) and on edge cases (B1, B2, B3: identity operands,
     P == Q, P == -Q; B4, B5: an odd batch, the values 0, 1 and r - 1); B1
     at the 64-blob scan, the FK20 column MSM and the verify paths' two
     variable-base MSMs, at m = 300 and m = 1, K = 1, with one doubling
     lane in a 32-lane block, a block where every lane doubles, identity
     rows and an identity sum at a restart; B4 and B5 at n = 2, 512, 1024,
     2048, 4096 and 8192; B2 also on 133,120 lanes of FK20 column sums
     gathered over the half convolution's taps, at 1, 7, 33, 240, 1000
     and 2048 lanes,
     with one doubling lane in a 32-lane block and a block where every
     lane doubles; B3 at the verify paths' shapes (the proof MSM: 1 and 2 MSMs,
     c = 13, 20 windows; the commitment MSM: c = 8, 32 windows), one
     window, c = 1, and at 1024 lanes; B1, B2, B4 and B5 on the first
     input of each shape that the recovery, multiproof and das_extension
     calls gave them, and B2 and B4 on those of the legacy FK20 calls (the
     chunk files' transforms 64 x 128, 16 x 512 and 1 x 1024 among them),
     recorded while the calls ran;
     B6 word for word at the probe's shape, at the MSM's (batch 8, 25-word
     rows) and on edge cases (first and last rows, repeated indices, a
     ragged count, widths 24 and 25, an unaligned table), and an index out
     of range raises; B7 (the Fermat inversion) against pow_fixed on the
     first input of each field and shape that the main path's calls gave
     it, recorded while they ran, and on 0, 1 and m - 1 among 1152 lanes;
     the commit, prove and verify calls launched B7 once per counted
     inversion; B8 (FK20's and the G1 FFT's fixed-scalar ladders) against
     its plain version on the card on the 9-blob recovery's half
     convolution (74,880 lanes, two GLV tables, lanes through src), on
     every stage of a forward and an inverse G1 FFT of 64 x 128 column
     points (one table; the inverse's 1/n scale, one digit column) and on
     the legacy FK20 calls' half convolutions (8,320, 131,584 and 525,312
     lanes), recorded while the calls ran;
  4. checks of the results: known answers from the setup file's own bytes
     (unit blobs commit to Lagrange points; blobs of x^(64 + k) have known
     cells and known proofs), a commitment and a proof against the CPU path
     on a CPU copy of the table, and pairing checks of blob proofs and of
     cell proofs (the cell's interpolant computed with Python ints); the
     2048-cell verification's four device points and the blob
     verification's two lincombs against the plain versions on a CPU copy;
  5. timings (CUDA events) of each kernel and its plain version, with the
     least time the card could take (and, for B6, the library call
     index_select); kernels shorter than their wrapper's host overhead are
     timed with their launches queued ahead; B1 at the 64-blob scan, with
     its bound at the 10 products a step needs (7 more where a step
     doubles) beside the earlier design's 17; B2 at 32,768, 133,120 and
     256 lanes; B3 at both verify shapes, with its latency bounds (product
     rounds, and one thread's products as in the earlier design); B4 and
     B5 at each launch of one cells call; B7 at each field and shape the
     main path gave it, with its latency bound (the chain of dependent
     products at one multiply-add a clock); B8 at the 9-blob half
     convolution, with its bound (operations) and its plain version's
     time;
  6. multi-device, in ranks of one gloo process group started in processes
     of their own by kzg_tpu_torch.parallel.dryrun.launch, every rank on
     this card (NCCL refuses two ranks on one card): 2 ranks on
     blobs_mesh() run the batch entry points with mesh= at full width
     (the 64 blobs' commitments byte-equal to phase 2's; verification
     True, False with two proofs swapped; 63 blobs as without the mesh; a
     non-canonical blob raises ValueError on both ranks, none hangs); 4
     ranks on a 2 x 2 global_mesh run the dry run's programs at its small
     shapes, then msm_fixed_sharded on the Lagrange table over 8 seeded
     rows, msm_sharded over the 4096 setup points and fft_sharded and
     ifft_sharded at n = 8192, held here against msm_fixed, msm, fft and
     ifft. Each rank zeroes the launch counts before its calls and reads
     them after (they are added to the kernels line's), and holds B1-B5
     against their plain versions on the first input of each shape its
     calls gave them; it prints its walls, launches and peak memory.

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
            "g1_ladder_kernel")  # B1-B3, B7, B8: ptxas must report no spills
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
    # B1, B2, B3, B7 (each of its instances) and B8 keep every value in
    # registers or shared memory
    for k in NO_SPILL:
        check(k in spills, f"ptxas reported no spill line for {k}")
        for line in spills[k]:
            check(line.endswith(" 0 bytes spill stores, 0 bytes spill loads"), f"ptxas spills in {k}: {line}")
            check(k not in NO_STACK or line.startswith("0 bytes stack frame"), f"ptxas stack frame in {k}: {line}")


def shape_key(args):
    import torch

    return tuple(tuple(a.shape) if torch.is_tensor(a) else tuple(a.x.shape) if isinstance(a, tuple) else a
                 for a in args)


class Recording:
    """Stands in its module for a kernel wrapper: keeps the wrapper's
    first input of each shape, then calls it. The wrapper counts its
    launches in the tracing registry by the kernel's name, whatever
    stands in for it."""

    def __init__(self, module, attr, seen):
        self.module, self.attr, self.fn, self.seen = module, attr, getattr(module, attr), seen
        setattr(module, attr, self)

    def __call__(self, *args):
        self.seen.setdefault(shape_key(args), args)
        return self.fn(*args)

    def stop(self):
        setattr(self.module, self.attr, self.fn)


# ---- the multi-device phase's ranks ---------------------------------------
# Module-level, so that kzg_tpu_torch.parallel.dryrun.launch can start them
# in processes of their own (spawn); every rank runs on cuda:0 under gloo.

MESH_KERNELS = ("seg_scan_phase1", "add_unified", "horner", "ntt_tile", "ntt_stage")  # B1-B5
MESH_ROWS = 8  # scalar rows of the 4-rank fixed-base MSM


def start_recordings():
    """Recording stand-ins for B1-B5: (the stand-ins, {kernel: {shape: first input}})."""
    from kzg_tpu_torch.ops import cuda_fft, cuda_msm

    seen = {name: {} for name in MESH_KERNELS}
    recs = [Recording(cuda_msm, "seg_scan_phase1_mem", seen["seg_scan_phase1"]),
            Recording(cuda_msm, "add_points", seen["add_unified"]),
            Recording(cuda_msm, "horner_windows", seen["horner"]),
            Recording(cuda_fft, "ntt_tile", seen["ntt_tile"]),
            Recording(cuda_fft, "ntt_stage", seen["ntt_stage"])]
    return recs, seen


def check_recorded(seen) -> dict:
    """Every recorded input through its kernel and the plain version, both
    on the card, limb for limb (tolerance: exact). Returns {kernel:
    [shapes, max abs limb error]}; raises SmokeFailure on a difference."""
    import torch

    from kzg_tpu_torch.ops import cuda_fft, cuda_msm, launch

    refs = {"seg_scan_phase1": cuda_msm.seg_scan_phase1_mem_ref, "add_unified": cuda_msm.add_points_ref,
            "horner": cuda_msm.horner_windows_ref, "ntt_tile": cuda_fft.ntt_tile_ref,
            "ntt_stage": cuda_fft.ntt_stage_ref}
    out = {}
    for name, inputs in seen.items():
        err = 0
        for args in inputs.values():
            got, ref = launch.WRAPPERS[name](*args), refs[name](*args)
            for a, b in zip(*([x] if torch.is_tensor(x) else x for x in (got, ref))):
                err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
        check(err == 0, f"{name}: kernel and plain version differ on a sharded call's input (max abs limb error {err})")
        out[name] = [len(inputs), err]
    return out


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
    just before it and read just after, its peak device memory and walls,
    and the kernels held against their plain versions on every input shape
    it gave them."""
    import torch
    import torch.distributed as dist

    from kzg_tpu_torch.ops import launch

    recs, seen = start_recordings()
    walls = {}
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    try:
        out = body(walls)
    finally:
        counts = launch.launches()
        for r in recs:
            r.stop()
    peak = torch.cuda.max_memory_allocated()
    recorded = check_recorded(seen)
    rank = dist.get_rank()
    print(f"{label} rank {rank}: OK; walls {json.dumps({k: round(v, 3) for k, v in walls.items()})} s; launches "
          f"{counts}; peak device memory {peak / 2**30:.2f} GiB; kernels exact on the recorded shapes "
          f"{ {k: v[0] for k, v in recorded.items()} }", flush=True)
    return {**out, "walls": walls, "launches": counts, "peak_bytes": peak, "recorded": recorded}


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

    # B7's first input of each field and shape on the main path's calls,
    # held against its plain version in section 3
    inv_inputs = {}
    inv_recording = Recording(fl, "inv", inv_inputs)

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
    inv_recording.stop()

    # The recovery, multiproof and das_extension calls give B1, B2, B4 and
    # B5 shapes that no earlier call gives them: the vanishing
    # polynomial's tree of small NTTs (batch 32 at n = 4 down to batch 1
    # at n = 128), the division's transforms of n = 2 to 8192 at batch 1,
    # the one-blob FK20 column MSM, the MSMs on the monomial table and on
    # its first n columns. While they run, each of those four wrappers
    # keeps its first input of each shape; section 3 holds the kernel
    # against its plain version on every one of them.
    path_inputs = {name: {} for name in ("seg_scan_phase1", "add_unified", "ntt_tile", "ntt_stage")}

    recordings = [Recording(cuda_msm, "seg_scan_phase1_mem", path_inputs["seg_scan_phase1"]),
                  Recording(cuda_msm, "add_points", path_inputs["add_unified"]),
                  Recording(cuda_fft, "ntt_tile", path_inputs["ntt_tile"]),
                  Recording(cuda_fft, "ntt_stage", path_inputs["ntt_stage"])]

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
    # seeded 64 cells, the even cells or the odd ones; B8 keeps its input
    # (the half convolution of 9 blobs) for section 3
    half = list(range(0, 128, 2))
    batch_blobs = list(range(3, 12))
    batch_idx = [sorted(rec_rng.choice(128, 64, replace=False).tolist()) for _ in range(7)] + [half, [i + 1 for i in half]]
    b8_inputs = {}
    b8_recording = Recording(g1fft, "ladder", b8_inputs)
    passes = tracing.counters().get("recover.passes", 0)
    (rcs, rps), counts, secs = counted_call(
        "recover_cells_and_kzg_proofs_batch of blobs 3-11 (seeded 64 cells; the even cells; the odd cells)",
        lambda: api.recover_cells_and_kzg_proofs_batch(batch_idx, [[cells[b][i] for i in idx] for b, idx in zip(batch_blobs, batch_idx)], s),
    )
    b8_recording.stop()
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
    for rec in recordings:
        rec.stop()

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
    probe_out, counts, _ = counted_call("gather probe B6 call", lambda: gather_micro.dg(probe))
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
    # changed). While these calls run, B2, B4 and B8 keep their first input
    # of each shape for section 3.
    legacy_inputs = {"add_unified": {}, "ntt_tile": {}, "g1_ladder": {}}
    recordings = [Recording(cuda_msm, "add_points", legacy_inputs["add_unified"]),
                  Recording(cuda_fft, "ntt_tile", legacy_inputs["ntt_tile"]),
                  Recording(g1fft, "ladder", legacy_inputs["g1_ladder"])]
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
    for rec in recordings:
        rec.stop()

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

    # ---- 3. kernels against their plain versions -------------------------
    max_err = {name: 0 for name in launch.WRAPPERS}

    def compare(name, got, ref):
        """Tolerance: exact. Both sides reduce every limb fully."""
        for a, b in zip(got, ref):
            check(a.shape == b.shape, f"{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            err = int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max())
            max_err[name] = max(max_err[name], err)
        check(max_err[name] == 0, f"{name}: kernel and plain version differ (max abs limb error {max_err[name]})")

    # B7 on the main path's inputs (recorded in section 2) and on 0, 1 and
    # m - 1 among 1152 seeded lanes of each field; plain version (pow_fixed)
    # on the card
    check(inv_inputs, "the main path's calls made no inversion")
    inv_gen = np.random.default_rng(SEED + 13)
    for spec in (FP, FR):
        vals = [int.from_bytes(inv_gen.bytes(48), "big") % spec.modulus for _ in range(1152)]
        vals[:3] = [0, 1, spec.modulus - 1]
        inv_inputs[("edge", spec.name)] = (spec, spec.encode(vals, dev))
    for spec, a in inv_inputs.values():
        compare("field_inv", [fl.inv(spec, a)], [fl.pow_fixed(spec, a, spec.modulus - 2)])
    inv_shapes = sorted((spec.name, tuple(a.shape)) for spec, a in inv_inputs.values())
    log(f"field_inv: exact on the main path's inputs and the edge values at {len(inv_shapes)} shapes: {inv_shapes}")

    # B8 on the 9-blob recovery's half convolution (recorded in section 2:
    # 74,880 lanes, two GLV tables, lanes through src) and on every stage
    # of a forward and an inverse G1 FFT of the 64 x 128 column points
    # (one table, a digit column a twiddle; the inverse's 1/n scale, one
    # digit column), recorded while they run; plain version on the card
    check(len(b8_inputs) == 1, f"the 9-blob recovery gave g1_ladder {len(b8_inputs)} shapes")
    ((b8_key, b8_args),) = b8_inputs.items()
    check(b8_key[1][0] == 2 and b8_key[2] == (9 * 128 * 65,), f"the 9-blob recovery's half convolution: {b8_key}")
    b8_got = g1fft.ladder(*b8_args)
    b8_ref, t_b8_plain = timed(synced(lambda: g1fft.ladder_ref(*b8_args)))
    compare("g1_ladder", b8_got, b8_ref)
    del b8_got, b8_ref
    g1_rows = g1.from_affine(g1.map_coords(lambda c: c.transpose(-1, -2).contiguous(), s.x_ext_fft_columns))  # (24, 64, 128)
    fft_b8 = {}
    fft_recording = Recording(g1fft, "ladder", fft_b8)
    fwd = g1fft.fft_g1(g1_rows)
    back = g1fft.fft_g1(fwd, inverse=True)
    fft_recording.stop()
    check(g1.xyzz_to_ints(back) == g1.xyzz_to_ints(g1_rows), "ifft_g1(fft_g1(P)) != P on the column points")
    check({key[1] for key in fft_b8} >= {(1, 52, 1 << st) for st in range(1, 7)} | {(1, 52, 1)},
          f"the G1 FFTs gave g1_ladder {sorted(fft_b8)}")
    for args in fft_b8.values():
        compare("g1_ladder", g1fft.ladder(*args), g1fft.ladder_ref(*args))
    log(f"g1_ladder: exact on the 9-blob half convolution ({b8_key[2][0]} lanes, plain {t_b8_plain:.2f} s on the card) "
        f"and on the G1 FFTs' {len(fft_b8)} shapes {sorted(fft_b8)}; ifft_g1(fft_g1(P)) == P")
    del g1_rows, fwd, back, fft_b8

    # B1 at the one-blob main-path shape, plain version on a CPU copy
    one_scalars = eip4844._bytes_to_limbs(
        torch.from_numpy(np.frombuffer(blobs[0], np.uint8).reshape(1, 4096, 32).copy()).to(dev)
    )[0]
    rows1, idx1, first1 = msm.phase1_inputs(table, one_scalars)
    got = cuda_msm.seg_scan_phase1_mem(rows1, idx1, first1)
    torch.cuda.synchronize()
    (ref, t_ref1) = timed(lambda: cuda_msm.seg_scan_phase1_mem(rows1.cpu(), idx1.cpu(), first1.cpu()))
    compare("seg_scan_phase1", got, ref)
    log(f"B1 one blob: K={idx1.shape[0]} m={idx1.shape[1]} exact (CPU plain {t_ref1:.1f} s)")

    # B1 at a small K on crafted rows: identity rows, equal keys, P == Q
    # and P == -Q inside a run
    base = table.x[:, 0, :48], table.y[:, 0, :48], table.inf[0, :48].clone()
    base[2][5] = True  # identity rows
    rows_s, R0 = msm._pack_point_rows(*base)
    K_s, m_s = 8, 256
    gen = np.random.default_rng(SEED + 1)
    idx_s = gen.integers(0, 2 * R0, (K_s, m_s))
    idx_s[1] = idx_s[0]  # P == Q
    idx_s[3] = (idx_s[2] + R0) % (2 * R0)  # P == -Q
    idx_s[4, ::3] = 5  # identity
    first_s = gen.random((K_s, m_s)) < 0.3
    first_s[1:4] = False
    idx_s = torch.from_numpy(idx_s.astype(np.int32)).to(dev)
    first_s = torch.from_numpy(first_s).to(dev)
    got = cuda_msm.seg_scan_phase1_mem(rows_s, idx_s, first_s)
    compare("seg_scan_phase1", got, cuda_msm.seg_scan_phase1_mem(rows_s.cpu(), idx_s.cpu(), first_s.cpu()))
    log("B1 crafted K=8 m=256: exact")

    # B1's edge shapes on the same rows: m not a multiple of the block's 32
    # lanes, one lane, one step; one lane alone of its 32-lane block adding
    # its running sum's own point (P == Q), a block where every lane does;
    # identity rows and a restart on the identity (an identity sum)
    def scan_case(K, m, seed, dbl):
        g = np.random.default_rng(seed)
        ix = g.integers(0, 2 * R0, (K, m))
        fs = g.random((K, m)) < 0.25
        if K > 5:
            ix[4, 1::5] = 5  # a restart on the identity row
            fs[4, 1::5] = True
            ix[5, ::3] = 5
        if dbl is not None:
            ix[0, dbl] = np.where(ix[0, dbl] % R0 == 5, 6, ix[0, dbl])  # not the identity row
            ix[1] = (ix[0] + 1) % (2 * R0)
            ix[1, dbl] = ix[0, dbl]  # step 1 adds step 0's row to itself
            fs[0, dbl] = True
            fs[1, dbl] = False
        return torch.from_numpy(ix.astype(np.int32)).to(dev), torch.from_numpy(fs).to(dev)

    for label, K_e, m_e, dbl in (("m = 300", 6, 300, None), ("m = 1", 7, 1, None), ("K = 1", 1, 77, None),
                                 ("one doubling lane of its block", 6, 96, [37]),
                                 ("a block where every lane doubles", 6, 96, list(range(32, 64)))):
        idx_e, first_e = scan_case(K_e, m_e, SEED + 5 + K_e + m_e, dbl)
        got = cuda_msm.seg_scan_phase1_mem(rows_s, idx_e, first_e)
        compare("seg_scan_phase1", got, cuda_msm.seg_scan_phase1_mem(rows_s.cpu(), idx_e.cpu(), first_e.cpu()))
        log(f"B1 {label} (K={K_e} m={m_e}): exact")

    # B1 at the 64-blob main-path shape: kernel against the plain version on the card
    all_scalars = eip4844._bytes_to_limbs(
        torch.from_numpy(np.frombuffer(b"".join(blobs), np.uint8).reshape(N_BLOBS, 4096, 32).copy()).to(dev)
    )[0]
    rows64, idx64, first64 = msm.phase1_inputs(table, all_scalars)
    K64, m64 = idx64.shape
    got64 = cuda_msm.seg_scan_phase1_mem(rows64, idx64, first64)
    ref64, t_plain_b1 = timed(
        lambda: (cuda_msm.seg_scan_phase1_mem_ref(rows64, idx64, first64), torch.cuda.synchronize())[0]
    )
    compare("seg_scan_phase1", got64, ref64)
    del ref64
    log(f"B1 {N_BLOBS} blobs: K={K64} m={m64} exact against the plain version on the card")

    # B1 on the FK20 column MSM of the 16 cell blobs (the table's batch
    # dims: each column its own point set)
    raw16 = torch.from_numpy(np.frombuffer(b"".join(cell_blobs), np.uint8).reshape(N_CELL_BLOBS, 4096, 32).copy())
    _, poly16 = eip7594._cells_body(raw16.to(dev))
    col_scalars = eip7594.column_scalars(poly16, 64)
    rows_c, idx_c, first_c = msm.phase1_inputs(col_tables, col_scalars)
    got_c = cuda_msm.seg_scan_phase1_mem(rows_c, idx_c, first_c)
    compare("seg_scan_phase1", got_c, cuda_msm.seg_scan_phase1_mem_ref(rows_c, idx_c, first_c))
    log(f"B1 column MSM of {N_CELL_BLOBS} blobs: K={idx_c.shape[0]} m={idx_c.shape[1]} exact against the plain version on the card")
    del got_c, rows_c, idx_c, first_c

    def edge_cases(p, q):
        """Copies of p and q with P == Q in lanes 0-49 (every lane of the
        kernels' first 32-lane block) and in lane 205 alone of its block,
        P == -Q in 50-99, the identity on the right in 100-149 and on the
        left in 150-199 (as far as there are lanes)."""
        p = g1.map_coords(lambda c: c.clone(memory_format=torch.contiguous_format), p)
        q = g1.map_coords(lambda c: c.clone(memory_format=torch.contiguous_format), q)
        neg_p = g1.neg(p)
        for k in range(4):
            q[k][:, 0:50] = p[k][:, 0:50]
            q[k][:, 205:206] = p[k][:, 205:206]
            q[k][:, 50:100] = neg_p[k][:, 50:100]
        for pt, lo in ((q, 100), (p, 150)):
            pt.zz[:, lo : lo + 50] = 0
            pt.zzz[:, lo : lo + 50] = 0
        return p, q

    # B2 on the half convolution's lanes: the column sums of the 16 cell
    # blobs gathered over the circulant's 65 taps, as fk20_half_convolution
    # gathers them (16 x 128 x 65 = 133,120 lanes), each added to the lane
    # one tap on; plain version on the card
    h_ext = msm.msm_fixed(col_tables, col_scalars)  # (24, 16, 128)
    n_col = h_ext.x.shape[-1]
    offsets = g1fft._half_conv_taps(n_col)[0]
    src = torch.from_numpy(((np.arange(n_col)[:, None] - offsets[None, :]) % n_col).reshape(-1)).to(dev)
    lanes = g1.map_coords(lambda c: c[..., src].reshape(c.shape[0], -1).contiguous(), h_ext)
    p7, q7 = edge_cases(lanes, g1.map_coords(lambda c: torch.roll(c, 1, dims=-1), lanes))
    ref7 = cuda_msm.add_points_ref(p7, q7)
    compare("add_unified", cuda_msm.add_points(p7, q7), ref7)
    log(f"B2 half-convolution lanes of {N_CELL_BLOBS} blobs ({p7.x.shape[-1]} lanes, with edge cases): "
        f"exact against the plain version on the card")
    del h_ext, lanes, ref7

    # B2: EIP-4844 main-path lane count (chunk aggregates of the 64-blob
    # scan), 2048 and a ragged 1000 with edge cases; plain version on a CPU copy
    agg = g1.map_coords(lambda c: c[:, K64 - 1, :].contiguous(), got64)
    agg_r = g1.map_coords(lambda c: torch.roll(c, 1, dims=-1).contiguous(), agg)
    b2_cases = [("main", agg_r, agg)]
    for M in (2048, 1000):
        b2_cases.append((f"{M}, with edge cases", *edge_cases(g1.map_coords(lambda c: c[:, :M], agg),
                                             g1.map_coords(lambda c: c[:, M : 2 * M], agg))))
    for M in (1, 7, 33, 240):
        b2_cases.append((f"{M}, with edge cases", *edge_cases(g1.map_coords(lambda c: c[:, :M], agg),
                                                              g1.map_coords(lambda c: c[:, M : 2 * M], agg))))
    for label, p, q in b2_cases:
        ref = cuda_msm.add_points(g1.map_coords(lambda c: c.cpu(), p), g1.map_coords(lambda c: c.cpu(), q))
        compare("add_unified", cuda_msm.add_points(p, q), ref)
        log(f"B2 {label} ({p.x.shape[-1]} lanes): exact")

    # B4 and B5 at the EIP-7594 path's shapes: the inverse 4096 and forward
    # 8192 of 16 blobs, the 64 x 128 Toeplitz transforms of 16 blobs; an
    # odd batch; values 0, 1 and r - 1
    blob_m16 = fl.from_canonical(FR, eip4844._bytes_to_limbs(raw16.to(dev))[0])
    gen = np.random.default_rng(SEED + 2)

    def random_fr(B, n):
        vals = [int.from_bytes(gen.bytes(32), "little") % R for _ in range(B * n)]
        vals[:6] = [0, 1, R - 1, 0, 1, R - 1]
        return torch.from_numpy(FR.encode_host(vals).reshape(16, B, n)).to(dev)

    fft_cases = [
        ("ifft 4096 x 16", cuda_fft.bit_reverse(blob_m16).contiguous(), True),
        ("fft 8192 x 16", torch.cat([poly16, torch.zeros_like(poly16)], dim=-1).contiguous(), False),
        ("fft 128 x (16, 64)", random_fr(16 * 64, 128), False),
        ("ifft 8192 x 3 (edge values)", random_fr(3, 8192), True),
        ("ifft 4096 x 3 (edge values)", random_fr(3, 4096), True),
        ("fft 2048 x 5 (edge values)", random_fr(5, 2048), False),
        ("fft 1024 x 3 (edge values)", random_fr(3, 1024), False),
        ("ifft 512 x 5 (edge values)", random_fr(5, 512), True),
        ("fft 2 x 7 (edge values)", random_fr(7, 2), False),
        ("fft 8192 x 1 (edge values)", random_fr(1, 8192), False),
        ("ifft 8192 x 1 (edge values)", random_fr(1, 8192), True),
    ]
    # the vanishing polynomial's tree: batch x n = 32 x 4 ... 1 x 128
    for lv in range(6):
        B, n = 32 >> lv, 4 << lv
        fft_cases += [(f"{'i' * inverse}fft {n} x {B} (edge values)", random_fr(B, n), inverse) for inverse in (False, True)]
    for label, x, inverse in fft_cases:
        n = x.shape[-1]
        log_n = n.bit_length() - 1
        got = cuda_fft.ntt_tile(x, inverse)
        ref = cuda_fft.ntt_tile_ref(x, inverse)
        compare("ntt_tile", [got], [ref])
        for st in range(cuda_fft.tile_stages(log_n), log_n):
            got_s = cuda_fft.ntt_stage(ref, st, inverse)
            ref = cuda_fft.ntt_stage_ref(ref, st, inverse)
            compare("ntt_stage", [got_s], [ref])
        log(f"B4/B5 {label}: exact ({log_n - cuda_fft.tile_stages(log_n)} B5 stages)")

    # B1, B2, B4 and B5 on the inputs that the recovery, multiproof and
    # das_extension calls gave them, one of each shape (recorded in
    # section 2); plain versions on the card. The shapes named in the
    # recording's comment must be among them.
    mono_rows = 2 * mono.x[0].numel()
    want = {"seg_scan_phase1": {2 * col_tables.x[0].numel(), mono_rows, mono_rows * 16 // 4096, mono_rows * 64 // 4096},
            "ntt_tile": {((16, 32 >> lv, 4 << lv), inv) for lv in range(6) for inv in (False, True)}
            | {((16, 1, 8192), inv) for inv in (False, True)}}
    seen = {"seg_scan_phase1": {key[0][0] for key in path_inputs["seg_scan_phase1"]},
            "ntt_tile": set(path_inputs["ntt_tile"])}
    for name, keys in want.items():
        check(keys <= seen[name], f"{name}: the recorded shapes lack {sorted(keys - seen[name])}")
    refs = {"seg_scan_phase1": cuda_msm.seg_scan_phase1_mem_ref, "add_unified": cuda_msm.add_points_ref,
            "ntt_tile": cuda_fft.ntt_tile_ref, "ntt_stage": cuda_fft.ntt_stage_ref}
    for name, ref_fn in refs.items():
        check(path_inputs[name], f"the recovery, multiproof and das_extension calls launched no {name}")
        for args in path_inputs[name].values():
            got, ref = launch.WRAPPERS[name](*args), ref_fn(*args)
            compare(name, [got] if torch.is_tensor(got) else got, [ref] if torch.is_tensor(ref) else ref)
        log(f"{name}: exact on the recovery, multiproof and das_extension calls' inputs at "
            f"{len(path_inputs[name])} shapes: {sorted(path_inputs[name])}")
    del path_inputs

    # B2, B4 and B8 on the legacy FK20 calls' inputs (recorded in section
    # 2), plain versions on the card: the chunk files' transforms and the
    # half convolutions' 8,320, 131,584 and 525,312 lanes among them
    want_lanes = {128 * 65, 512 * 257, 1024 * 513}
    seen_lanes = {key[2][0] for key in legacy_inputs["g1_ladder"] if len(key) == 3 and key[2] is not None}
    check(want_lanes <= seen_lanes, f"g1_ladder: the legacy calls' lanes lack {sorted(want_lanes - seen_lanes)}")
    want_ntt = {((16, 64, 128), False), ((16, 16, 512), False), ((16, 1, 1024), False)}
    check(want_ntt <= set(legacy_inputs["ntt_tile"]), f"ntt_tile: the legacy calls' shapes lack "
          f"{sorted(want_ntt - set(legacy_inputs['ntt_tile']))}")
    refs["g1_ladder"] = g1fft.ladder_ref
    for name in ("add_unified", "ntt_tile", "g1_ladder"):
        for args in legacy_inputs[name].values():
            got, ref = launch.WRAPPERS[name](*args), refs[name](*args)
            compare(name, [got] if torch.is_tensor(got) else got, [ref] if torch.is_tensor(ref) else ref)
        log(f"{name}: exact on the legacy FK20 calls' inputs at {len(legacy_inputs[name])} shapes: "
            f"{sorted(legacy_inputs[name])}")
    del legacy_inputs

    # B3 at the verify paths' shapes: the window sums of the 2048-cell
    # call's proof MSM (2 MSMs of 2048 points, c = 13, 20 windows), and of
    # its first MSM alone; plain version on the card
    cb, idx, cl, pr = verify_cases[N_CELL_BLOBS * 128]
    unique_cb, cidx = eip7594._deduplicate_with_indices(cb)
    r_cells = eip7594._batch_challenge_bytes(unique_cb, cidx, idx, cl, pr)
    cell_inputs = eip7594._verify_cell_inputs(unique_cb, cidx, idx, cl, pr, r_cells, dev)
    c_v = msm.default_window(cell_inputs[0].x.shape[-1], fixed_base=False)
    win2 = msm.window_sums(cell_inputs[0], cell_inputs[1], c_v)
    check(c_v == 13 and tuple(win2.x.shape) == (24, 2, 20), f"unexpected proof MSM windows c={c_v} {tuple(win2.x.shape)}")
    win1 = g1.map_coords(lambda t: t[:, :1].contiguous(), win2)
    # and the commitment MSM (1 MSM of 16 points, c = 8, 32 windows), one
    # window, c = 1
    c_c = msm.default_window(cell_inputs[2].x.shape[-1], fixed_base=False)
    win_c = msm.window_sums(cell_inputs[2], cell_inputs[3], c_c)
    check(c_c == 8 and tuple(win_c.x.shape) == (24, 1, 32), f"unexpected commitment MSM windows c={c_c} {tuple(win_c.x.shape)}")
    # B1 at the verify paths' two variable-base MSMs (the proof MSM and the
    # commitment MSM of the 2048-cell call), plain version on the card
    for label, pts_v, sc_v, c_w in (("proof MSM", cell_inputs[0], cell_inputs[1], c_v),
                                    ("commitment MSM", cell_inputs[2], cell_inputs[3], c_c)):
        rows_v, lay_v = msm._var_inputs(pts_v, sc_v, c_w)[:2]
        got = cuda_msm.seg_scan_phase1_mem(rows_v, lay_v.idx, lay_v.first)
        compare("seg_scan_phase1", got, cuda_msm.seg_scan_phase1_mem_ref(rows_v, lay_v.idx, lay_v.first))
        log(f"B1 the 2048-cell {label}: K={lay_v.K} m={lay_v.m} exact against the plain version on the card")
    for label, win, c_w in (("2 MSMs, the 2048-cell proof MSM", win2, c_v), ("1 MSM of the proof MSM", win1, c_v),
                            ("the 2048-cell commitment MSM", win_c, c_c),
                            ("1 MSM, one window", g1.map_coords(lambda t: t[:, :, :1].contiguous(), win1), c_v),
                            ("2 MSMs at c = 1", win2, 1)):
        ref = cuda_msm.horner_windows_ref(win, c_w)
        compare("horner", cuda_msm.horner_windows(win, c_w), ref)
        log(f"B3 {label} ({win.x.shape[1]} MSMs, c = {c_w}, {win.x.shape[2]} windows): exact")

    # B3 at 1024 lanes of 20 windows (doubled Lagrange table points, so zz
    # is not one) with edge lanes: all windows the identity (lane 0); the
    # identity at the start and in one window (lane 1); W_18 equal to the
    # doubled accumulator 2^13 W_19 (P == Q, lane 2) and its negative
    # (P == -Q, lane 3); plain version on the card
    aff = g1.G1Aff(table.x[..., :1024].transpose(1, 2), table.y[..., :1024].transpose(1, 2), table.inf[:, :1024].T)
    wide = g1.map_coords(lambda t: t.contiguous(), g1.dbl(g1.from_affine(aff)))  # (24, 1024, 20)
    lead = g1.map_coords(lambda t: t[:, 2:4, 19], wide)
    for _ in range(13):
        lead = g1.dbl(lead)
    for k in range(4):
        wide[k][:, 2, 18] = lead[k][:, 0]
        wide[k][:, 3, 18] = g1.neg(lead)[k][:, 1]
    for t in (wide.zz, wide.zzz):
        t[:, 0, :] = 0
        t[:, 1, 19] = 0
        t[:, 1, 7] = 0
    ref = cuda_msm.horner_windows_ref(wide, 13)
    compare("horner", cuda_msm.horner_windows(wide, 13), ref)
    log(f"B3 1024 lanes (c = 13, 20 windows, with identity, P == Q and P == -Q lanes): exact against the plain "
        f"version on the card")

    # B6 word for word against index_select: the probe's shape, the MSM's
    # (batch 8: the sorted rows B1 reads), and edge cases
    def compare_rows(label, table_t, idx_t):
        got = cuda_gather.gather_rows(table_t, idx_t)
        compare("gather_rows", [got], [cuda_gather.gather_rows_ref(table_t, idx_t)])
        log(f"B6 {label} ({idx_t.numel()} rows of {table_t.shape[1]} words): exact")

    compare("gather_rows", [probe_out], [cuda_gather.gather_rows_ref(probe["slice"], probe["src_mod"])])
    log(f"B6 probe shape ({probe['src_mod'].numel()} rows of 24 words from a {gather_micro.N}-row slice): exact")
    msm_in = gather_micro.msm_probe(table, BENCH_BATCH)
    compare_rows(f"MSM shape, batch {BENCH_BATCH}", msm_in["rows"], msm_in["idx"])
    gen = np.random.default_rng(SEED + 4)
    for width in (24, 25):
        tab_e = torch.from_numpy(gen.integers(-2**31, 2**31, (1000, width), dtype=np.int64).astype(np.int32)).to(dev)
        edge = np.concatenate([[0, 999, 999, 0, 5, 5, 5], gen.integers(0, 1000, 993)]).astype(np.int32)
        compare_rows(f"edge rows, width {width}", tab_e, torch.from_numpy(edge).to(dev))
        compare_rows(f"one row, width {width}", tab_e, torch.from_numpy(edge[1:2]).to(dev))
        unaligned = torch.empty(1000 * width + 1, dtype=torch.int32, device=dev)[1:].view(1000, width)
        unaligned.copy_(tab_e)
        compare_rows(f"unaligned table, width {width}", unaligned, torch.from_numpy(edge[:777]).to(dev))
        for bad in (1000, -1):
            try:
                cuda_gather.gather_rows(tab_e, torch.tensor([3, bad, 4], dtype=torch.int32, device=dev))
                raise SmokeFailure(f"B6: index {bad} of a 1000-row table did not raise")
            except IndexError:
                pass
    log("B6: indices 1000 and -1 of a 1000-row table raise IndexError")

    # ---- 4. checks of the result -----------------------------------------
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

    # ---- 5. timings --------------------------------------------------------
    p_main, q_main = agg_r, agg
    t_b1 = cuda_ms(lambda: cuda_msm.seg_scan_phase1_mem(rows64, idx64, first64), 20)
    E64 = N_BLOBS * 20 * 4096  # elements the data needs (the rest is padding)
    n_mdbl = mdbl_steps(rows64, idx64, first64, got64)
    b1_ops = (E64 * cuda_msm.MADD_FMULS_DISTINCT + n_mdbl * cuda_msm.MDBL_FMULS) * MULADDS_PER_FMUL
    b1_ops_all = E64 * cuda_msm.MADD_FMULS * MULADDS_PER_FMUL  # the earlier design's 17 products a step
    b1_bytes = rows64.numel() * 4 + idx64.numel() * 4 + first64.numel() + 4 * 24 * 4 * idx64.numel()
    log(f"seg_scan_phase1 64 blobs (K={K64} m={m64}, {E64} elements, {n_mdbl} steps double): {t_b1:.4f} ms; "
        f"bound {max(b1_ops / peak_imad, b1_bytes / HBM_BYTES_PER_S) * 1e3:.4f} ms (operations "
        f"{b1_ops / peak_imad * 1e3:.4f} at {cuda_msm.MADD_FMULS_DISTINCT} products a step, bytes "
        f"{b1_bytes / HBM_BYTES_PER_S * 1e3:.4f}); at all {cuda_msm.MADD_FMULS} products a step "
        f"{b1_ops_all / peak_imad * 1e3:.4f} ms [{card}]")

    def doubling_lanes(p, q):
        """Lanes where the addition takes its doubling: P == Q, neither the identity."""
        u1, u2, s1, s2 = fl.mul_many(FP, [(p.x, q.zz), (q.x, p.zz), (p.y, q.zzz), (q.y, p.zzz)])
        need = ~g1.is_inf(p) & ~g1.is_inf(q) & fl.is_zero(FP, fl.sub(FP, u2, u1)) & fl.is_zero(FP, fl.sub(FP, s2, s1))
        return int(need.sum())

    # B2 at the main path's 32,768 lanes (the kernels line), the half
    # convolution's 133,120 and a 256-lane tail launch. The
    # operations bound counts the 14 products of every lane and the 9 of
    # the doubling in the lanes that take it; the earlier design ran all 23
    # in every lane, a bound kept beside it.
    b2 = {}
    for label, p, q in (("main", p_main, q_main), ("half convolution", p7, q7),
                        ("tail", *(g1.map_coords(lambda c: c[:, :256].contiguous(), x) for x in (p_main, q_main)))):
        M = p.x.shape[-1]
        n_dbl = doubling_lanes(p, q)
        t_ops = (M * cuda_msm.ADD_FMULS_DISTINCT + n_dbl * cuda_msm.DBL_FMULS) * MULADDS_PER_FMUL / peak_imad * 1e3
        t_ops_all = M * cuda_msm.ADD_FMULS * MULADDS_PER_FMUL / peak_imad * 1e3
        t_bytes = 12 * 24 * 4 * M / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: cuda_msm.add_points(p, q), 50, queue_ahead=True)
        b2[label] = (ms, t_ops, t_bytes)
        log(f"add_unified {label} ({M} lanes, {n_dbl} doubling): {ms:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}; operations {t_ops:.4f}, bytes {t_bytes:.4f}; "
            f"all 23 products in every lane {t_ops_all:.4f}) [{card}]")
    del p7, q7
    t_b2, b2_ops_ms, b2_bytes_ms = b2["main"]
    t_b2_plain = cuda_ms(lambda: cuda_msm.add_points_ref(p_main, q_main), 3)

    # B4: the three launches of one 16-blob call; B5: its three stage
    # launches. Each kernel's bound is the sum of its launches' bounds.
    # The bound counts the 64 bytes per Fr value that the wrappers' (16,
    # ...) int32 layout of 16-bit limbs moves; "bytes32" and "bound32" are
    # the bytes term and the bound at 32 bytes per value, a packed layout.
    fft_rows = {k: {"ms": 0.0, "plain": 0.0, "bound": 0.0, "ops": 0.0, "bytes": 0.0, "bytes32": 0.0, "bound32": 0.0}
                for k in ("ntt_tile", "ntt_stage")}

    def fft_timing(name, label, run, run_plain, products, B, n):
        ms = cuda_ms(run, 20, queue_ahead=True)
        plain = cuda_ms(run_plain, 3)
        t_ops, t_bytes = fft_times_ms(B, n, products, peak_imad)
        t_bytes32 = fft_times_ms(B, n, products, peak_imad, FR_BYTES)[1]
        row = fft_rows[name]
        for key, v in (("ms", ms), ("plain", plain), ("bound", max(t_ops, t_bytes)), ("ops", t_ops),
                       ("bytes", t_bytes), ("bytes32", t_bytes32), ("bound32", max(t_ops, t_bytes32))):
            row[key] += v
        log(f"{name} {label}: {ms:.4f} ms (plain {plain:.2f} ms, bound {max(t_ops, t_bytes):.4f} ms, "
            f"{'operations' if t_ops >= t_bytes else 'bytes'}; operations {t_ops:.4f}, bytes {t_bytes:.4f}, "
            f"bytes at 32 B/value {t_bytes32:.4f} ms) [{card}]")

    for label, x, inverse in fft_cases[:3]:
        B, n = x.shape[1:]
        log_n = n.bit_length() - 1
        S = cuda_fft.tile_stages(log_n)
        prods = B * ((n // 2) * (S - 1) + (n if inverse else 0))  # stage 0's twiddle is one
        fft_timing("ntt_tile", label, lambda: cuda_fft.ntt_tile(x, inverse),
                   lambda: cuda_fft.ntt_tile_ref(x, inverse), prods, B, n)
        y = cuda_fft.ntt_tile(x, inverse)
        for st in range(S, log_n):
            fft_timing("ntt_stage", f"{label} stage {st}", lambda: cuda_fft.ntt_stage(y, st, inverse),
                       lambda: cuda_fft.ntt_stage_ref(y, st, inverse), B * n // 2, B, n)

    # B3 at the 2048-cell call's two launches: the proof MSM (2 MSMs, c =
    # 13, 20 windows) and the commitment MSM (1 MSM of 16 points, c = 8, 32
    # windows). Bounds: the card's throughput (operations over
    # every SM's multiply-add rate, or bytes), and the latency of the
    # dependent chain at one multiply-add per clock: (w - 1)(3 c + 4)
    # product rounds deep, and (w - 1)(9 c + 23) products for one thread
    # running them all (the earlier design).
    b3 = {}
    for label, win, c_w in (("proof MSM", win2, c_v), ("commitment MSM", win_c, c_c)):
        nb_w, w_w = win.x.shape[1:]
        ms = cuda_ms(lambda: cuda_msm.horner_windows(win, c_w), 20)
        plain = cuda_ms(lambda: cuda_msm.horner_windows_ref(win, c_w), 2)
        prods = (w_w - 1) * (cuda_msm.DBL_FMULS * c_w + cuda_msm.ADD_FMULS)
        rounds = (w_w - 1) * (cuda_msm.DBL_DEPTH * c_w + cuda_msm.ADD_DEPTH)
        t_ops = nb_w * (w_w - 1) * (cuda_msm.DBL_FMULS * c_w + cuda_msm.ADD_FMULS_DISTINCT) * MULADDS_PER_FMUL / peak_imad * 1e3
        t_bytes = 4 * 24 * 4 * nb_w * (w_w + 1) / HBM_BYTES_PER_S * 1e3  # w windows in, one point out
        t_lat = rounds * MULADDS_PER_FMUL / (sm_clock_mhz * 1e6) * 1e3
        t_lat_old = prods * MULADDS_PER_FMUL / (sm_clock_mhz * 1e6) * 1e3
        b3[label] = (ms, plain, t_ops, t_bytes, t_lat)
        log(f"horner {label} ({nb_w} MSMs, c = {c_w}, {w_w} windows): {ms:.4f} ms"
            f" (plain on the card {plain:.1f} ms); throughput bound {max(t_ops, t_bytes):.5f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}; operations {t_ops:.5f}, bytes {t_bytes:.6f}); "
            f"latency bound {t_lat:.4f} ms ({rounds} dependent product rounds); the earlier design's latency bound "
            f"{t_lat_old:.4f} ms ({prods} products on one thread); {MULADDS_PER_FMUL} multiply-adds a product at "
            f"{sm_clock_mhz:.0f} MHz [{card}]")
    t_b3, t_b3_plain, b3_ops, b3_bytes, _ = b3["proof MSM"]

    # B7 at each field and shape the main path gave it. Bound: latency, the
    # least chain of dependent products for a^(m-2) at one multiply-add a
    # clock: a 4-bit fixed window (4 squarings a window after the first, one
    # multiplication a nonzero window; its table left out), each squaring
    # at a dedicated squaring's multiply-adds. This design's own chain (left
    # to right over the bits: (bits - 1) squarings and (ones - 1)
    # multiplications, each a full product) is printed beside it, as is the
    # throughput bound (every lane's multiply-adds over every SM).
    # The row of the kernels line: Fp at one lane (to_affine's root).
    b7 = {}
    for key, (spec, a) in inv_inputs.items():
        if key[0] == "edge":
            continue
        e = spec.modulus - 2
        words = spec.n_limbs // 2
        mul = words * (4 * words + 1)
        sqr = words * (3 * words + 2)  # s(s + 1)/2 distinct products, lo and hi, then the reduction's 2 s^2 + s
        windows = [(e >> (4 * k)) & 15 for k in range(-(-e.bit_length() // 4))]
        least = 4 * (len(windows) - 1) * sqr + (sum(1 for w in windows[:-1] if w) * mul)
        prods = e.bit_length() + bin(e).count("1") - 2
        ms = cuda_ms(lambda: fl.inv(spec, a), 20)
        t_lat = least / (sm_clock_mhz * 1e6) * 1e3
        t_design = prods * mul / (sm_clock_mhz * 1e6) * 1e3
        t_ops = a[0].numel() * prods * mul / peak_imad * 1e3
        b7[(spec.name, a[0].numel())] = (ms, t_lat)
        log(f"field_inv {spec.name} at {tuple(a.shape)} ({a[0].numel()} lanes): {ms:.4f} ms; latency bound {t_lat:.4f} ms "
            f"(least chain: {least} dependent multiply-adds, {sqr} a squaring and {mul} a product, at "
            f"{sm_clock_mhz:.0f} MHz); this design's chain {t_design:.4f} ms ({prods} products); throughput bound "
            f"{t_ops:.6f} ms [{card}]")
    check(("Fp", 1) in b7, f"the main path gave field_inv no one-lane Fp input: {sorted(b7)}")
    t_b7, b7_bound = b7[("Fp", 1)]
    fp_one = next(a for spec, a in inv_inputs.values() if spec is FP and a[0].numel() == 1)
    t_b7_plain = cuda_ms(lambda: fl.pow_fixed(FP, fp_one, FP.modulus - 2), 2)
    log(f"field_inv Fp one lane: {t_b7:.4f} ms (plain pow_fixed on the card {t_b7_plain:.1f} ms, latency bound "
        f"{b7_bound:.4f} ms) [{card}]")

    # B8 at the 9-blob half convolution (the row of the kernels line).
    # Bound: operations, w c doublings and w T additions a lane at their
    # products (9 and 14; the doubling fallback and phi's product of x by
    # beta left out, as a stored phi table would avoid it)
    b8_mult, b8_digits, b8_src = b8_args
    T8, w8, _ = b8_digits.shape
    b8_lanes = b8_src.numel()
    b8_prods = w8 * g1fft.TWIDDLE_WINDOW * cuda_msm.DBL_FMULS + w8 * T8 * cuda_msm.ADD_FMULS_DISTINCT
    t_b8 = cuda_ms(lambda: g1fft.ladder(*b8_args), 10)
    b8_bound = b8_lanes * b8_prods * MULADDS_PER_FMUL / peak_imad * 1e3
    log(f"g1_ladder 9-blob half convolution ({b8_lanes} lanes, {w8} windows, {T8} tables, {b8_mult.x.shape[-1]} points): "
        f"{t_b8:.4f} ms; bound {b8_bound:.4f} ms (operations, {b8_prods} products a lane); "
        f"{b8_bound / t_b8:.0%} of the bound; plain version on the card {t_b8_plain * 1e3:.1f} ms [{card}]")
    del b8_args, b8_inputs

    # B6 at the probe's shape (the row of the kernels line) and at the
    # MSM's; the plain version is the library call, index_select, timed
    # twice (as "plain" and as "library"); launches queued ahead, sharing
    # one out-of-range flag read after the timing
    flag = cuda_gather.new_flag(dev)
    b6 = {}
    for label, tab_b, idx_b in (("probe", probe["slice"], probe["src_mod"]), ("MSM", msm_in["rows"], msm_in["idx"])):
        ms = cuda_ms(lambda: cuda_gather.gather_rows(tab_b, idx_b, flag), 20, queue_ahead=True)
        plain = cuda_ms(lambda: cuda_gather.gather_rows_ref(tab_b, idx_b), 20, queue_ahead=True)
        library = cuda_ms(lambda: tab_b.index_select(0, idx_b), 20, queue_ahead=True)
        bound = gather_micro.bound_ms(tab_b.shape[1], idx_b)
        b6[label] = (ms, plain, library, bound)
        log(f"gather_rows {label} shape ({idx_b.numel()} rows of {tab_b.shape[1]} words from {tab_b.shape[0]}): "
            f"{ms:.4f} ms (plain {plain:.4f} ms, index_select {library:.4f} ms, bound {bound:.4f} ms, bytes; "
            f"{bound / ms:.0%} of the bound) [{card}]")
    cuda_gather.raise_if_flagged(flag)
    t_b6, t_b6_plain, t_b6_lib, b6_bound = b6["probe"]

    # ---- 6. multi-device ------------------------------------------------
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
            log(f"  rank {r}: launches {res['launches']}; peak device memory {res['peak_bytes'] / 2**30:.2f} GiB; "
                f"kernels exact on their recorded shapes {res['recorded']} [{card}]")
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
    sc_m, pts_m, x_m = mesh_inputs(s, dev)
    want = {"fixed": g1.xyzz_to_ints(msm.msm_fixed(table, sc_m)), "var": g1.xyzz_to_ints(msm.msm(pts_m, sc_m[:, 0])),
            "fft": fl.limbs_to_ints(fft_ops.fft(x_m)), "ifft": fl.limbs_to_ints(fft_ops.ifft(x_m))}
    want = json.loads(json.dumps(want))  # as the ranks' JSON gives them: points as [x, y] lists
    ranks4 = mesh_launch("mesh programs (global_mesh 2 x 2, 4 ranks)", mesh_programs, 4, ())
    for r, res in enumerate(ranks4):
        for key, value in want.items():
            check(res[key] == value, f"rank {r}: the sharded {key} differs from the single-process function")
        for name in ("seg_scan_phase1", "add_unified", "horner", "ntt_tile"):
            check(res["launches"][name] > 0, f"rank {r} of the mesh programs launched no {name}")
    log(f"mesh programs: the dry run's programs at its small shapes; msm_fixed_sharded ({MESH_ROWS} x 4096, c = 13) "
        f"and msm_sharded (4096 setup points) affine-equal to msm_fixed and msm; fft_sharded and ifft_sharded at "
        f"8192 limb-equal to fft and ifft, and they round-trip")

    rows_out = []
    for name, ms, plain_ms, bound, by, source, replaces in (
        ("seg_scan_phase1", t_b1, t_plain_b1 * 1e3, max(b1_ops / peak_imad, b1_bytes / HBM_BYTES_PER_S) * 1e3,
         "operations" if b1_ops / peak_imad >= b1_bytes / HBM_BYTES_PER_S else "bytes",
         "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:94"),
        ("add_unified", t_b2, t_b2_plain, max(b2_ops_ms, b2_bytes_ms), "operations" if b2_ops_ms >= b2_bytes_ms else "bytes",
         "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:209"),
        ("horner", t_b3, t_b3_plain, max(b3_ops, b3_bytes), "operations" if b3_ops >= b3_bytes else "bytes",
         "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:307"),
    ) + tuple(
        (name, r["ms"], r["plain"], r["bound"], "operations" if r["ops"] >= r["bytes"] else "bytes",
         "kzg_tpu_torch/csrc/fft_kernels.cu", replaces)
        for (name, r), replaces in zip(fft_rows.items(), ("kzg_tpu/ops/pallas_fft.py:179", "kzg_tpu/ops/pallas_fft.py:255"))
    ) + (
        ("gather_rows", t_b6, t_b6_plain, b6_bound, "bytes", "kzg_tpu_torch/csrc/gather_kernels.cu",
         "benches/gather_micro.py:182"),
        ("field_inv", t_b7, t_b7_plain, b7_bound, "latency", "kzg_tpu_torch/csrc/field_kernels.cu", None),
        ("g1_ladder", t_b8, t_b8_plain * 1e3, b8_bound, "operations", "kzg_tpu_torch/csrc/g1fft_kernels.cu", None),
    ):
        rows_out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": max_err[name],
            "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4),
            "bound_ms": round(bound, 4),
            "bound_by": by,
            "library_ms": round(t_b6_lib, 4) if name == "gather_rows" else None,
        })
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound {bound:.4f} ms, {by}) [{card}]")
    for name, r in fft_rows.items():
        log(f"{name} bound terms summed over the call's launches: operations {r['ops']:.4f} ms, "
            f"bytes {r['bytes']:.4f} ms at 64 B/value, {r['bytes32']:.4f} ms at 32 B/value; "
            f"the kernel at {r['bound'] / r['ms']:.0%} of its bound, "
            f"{r['bound32'] / r['ms']:.0%} of the bound at 32 B/value [{card}]")
    log(f"B1 timed at K={K64} m={m64} ({E64} elements), {cuda_msm.SCAN_GROUP} warps a block; "
        f"B2 at {p_main.x.shape[-1]} lanes, g = {cuda_msm.GROUP}; "
        f"B3 at the 2048-cell proof MSM's launch, g = {cuda_msm.GROUP}; "
        f"B4 and B5 as the sum of one {N_CELL_BLOBS}-blob cells-and-proofs call's launches; B6 at the gather probe's shape; "
        f"B7 at one Fp lane; B8 at the 9-blob half convolution")
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
