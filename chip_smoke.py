#!/usr/bin/env python3
"""Drive kzg_tpu_torch on one NVIDIA GPU and check it, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. card and builds: the card's name and power limit, torch and CUDA
     versions; build the CUDA kernels (one nvcc per source; registers and
     spills printed) and the native host core, all at the same time;
  2. the main paths at full protocol width, through the public API, with
     the kernels' launch counts zeroed before each call and read after it:
     EIP-4844: load the mainnet setup on the card (builds the 20 x 4096
     fixed-base table), commit to 64 seeded random blobs and prove them;
     EIP-7594: build the FK20 column points and their c = 8 tables on the
     card, compute the cells and proofs of 16 seeded blobs in one batch
     call, then the cells of each blob through compute_cells;
     verification: all 2048 cells and proofs of those 16 blobs in one
     verify_cell_kzg_proof_batch call (a supernode's or a builder's check
     of a block), then a sampling node's 8 columns of them (128 cells),
     and verify_blob_kzg_proof_batch on the 64 blobs: True; False with a
     cell changed, two proofs swapped, a proof of another blob; a
     non-canonical blob raises;
     the bench path: the headline bench (kzg_tpu_torch.bench) at batch 8
     and 3 iterations with its native check, one batch-8 stage split of
     the fixed-base MSM (kzg_tpu_torch.benches.msm_stages, with kernel
     B6's gather) and the gather probe's B6 call;
  3. each kernel against its plain PyTorch version, limb for limb, at the
     main paths' shapes (kernel on the card, plain version on a CPU copy
     or on the card) and on edge cases (B1, B2, B3: identity operands,
     P == Q, P == -Q; B4, B5: an odd batch, the values 0, 1 and r - 1); B2
     also on the FK20 half convolution's 133,120 lanes; B3 at the verify
     paths' shapes (1 and 2 MSMs, c = 13, 20 windows) and at 1024 lanes;
     B6 word for word at the probe's shape, at the MSM's (batch 8, 25-word
     rows) and on edge cases (first and last rows, repeated indices, a
     ragged count, widths 24 and 25, an unaligned table), and an index out
     of range raises;
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
     timed with their launches queued ahead.

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
FMULS = {"seg_scan_phase1": 17, "add_unified": 23}
N_SAMPLE_COLUMNS = 8  # a sampling node's columns (PeerDAS custody of 8 of 128)
BENCH_BATCH, BENCH_ITERS = 8, 3  # the headline bench's batch, cut to 3 iterations
FR_TENSOR_BYTES = 16 * 4  # one Fr value in the (16, ...) int32 limb layout
FR_BYTES = 32  # one Fr value packed: what a 32-bit-limb layout would move


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
    """nvcc for the kernels (one process per source) and g++ for the
    native core, started together."""
    from kzg_tpu_torch import kernels, native

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
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, secs) in results.items():
        if isinstance(res, Exception):
            raise SmokeFailure(f"{name} build failed: {res}")
        log(f"build {name}: {secs:.1f} s")
    report = results["kernels"][0]
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())


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

    from kzg_tpu_torch import api, bench, eip4844, eip7594, native, trusted_setup
    from kzg_tpu_torch.benches import gather_micro, msm_stages
    from kzg_tpu_torch.benches.common import device_ms as cuda_ms
    from kzg_tpu_torch.constants import P_MOD, R_MOD as R
    from kzg_tpu_torch.ops import cuda_fft, cuda_gather, cuda_msm, field as fl, g1, g1fft, launch, msm
    from kzg_tpu_torch.ops.field import FR
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

    # ---- 2. the main paths -----------------------------------------------
    setup_path = os.path.join(repo, "tests", "trusted_setup.txt")
    torch.cuda.reset_peak_memory_stats()
    s, t_setup = timed(lambda: api.load_trusted_setup_file(setup_path))
    check(s.device.type == "cuda", "settings not on the card")
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

    def counted_call(label, fn):
        launch.reset_launches()
        out, secs = timed(fn)
        counts = launch.launches()
        for name, k in counts.items():
            main_launches[name] = main_launches.get(name, 0) + k
        log(f"{label}: {secs:.3f} s; launches {counts}")
        return out, counts, secs

    commits, launches_commit, _ = counted_call(
        f"commit {N_BLOBS} blobs", lambda: api.blob_to_kzg_commitment_batch(blobs, s)
    )
    proofs, launches_prove, _ = counted_call(
        f"prove {N_BLOBS} blobs", lambda: api.compute_blob_kzg_proof_batch(blobs, commits, s)
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
        ok, counts, secs = counted_call(f"verify {count} cells", lambda: api.verify_cell_kzg_proof_batch(cb, idx, cl, pr, s))
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
    ok, counts, secs = counted_call(f"verify {N_BLOBS} blobs", lambda: api.verify_blob_kzg_proof_batch(blobs, commits, proofs, s))
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

    # ---- 3. kernels against their plain versions -------------------------
    max_err = {name: 0 for name in launch.WRAPPERS}

    def compare(name, got, ref):
        """Tolerance: exact. Both sides reduce every limb fully."""
        for a, b in zip(got, ref):
            check(a.shape == b.shape, f"{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
            err = int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max())
            max_err[name] = max(max_err[name], err)
        check(max_err[name] == 0, f"{name}: kernel and plain version differ (max abs limb error {max_err[name]})")

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
        """Copies of p and q with P == Q in lanes 0-49, P == -Q in 50-99,
        the identity on the right in 100-149 and on the left in 150-199."""
        p = g1.map_coords(lambda c: c.clone(memory_format=torch.contiguous_format), p)
        q = g1.map_coords(lambda c: c.clone(memory_format=torch.contiguous_format), q)
        neg_p = g1.neg(p)
        for k in range(4):
            q[k][:, 0:50] = p[k][:, 0:50]
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
    compare("add_unified", cuda_msm.add_points(p7, q7), cuda_msm.add_points_ref(p7, q7))
    log(f"B2 half-convolution lanes of {N_CELL_BLOBS} blobs ({p7.x.shape[-1]} lanes, with edge cases): "
        "exact against the plain version on the card")
    del h_ext, lanes, p7, q7

    # B2: EIP-4844 main-path lane count (chunk aggregates of the 64-blob
    # scan), 2048 and a ragged 1000 with edge cases; plain version on a CPU copy
    agg = g1.map_coords(lambda c: c[:, K64 - 1, :].contiguous(), got64)
    agg_r = g1.map_coords(lambda c: torch.roll(c, 1, dims=-1).contiguous(), agg)
    b2_cases = [("main", agg_r, agg)]
    for M in (2048, 1000):
        b2_cases.append((str(M), *edge_cases(g1.map_coords(lambda c: c[:, :M], agg),
                                             g1.map_coords(lambda c: c[:, M : 2 * M], agg))))
    for label, p, q in b2_cases:
        got = cuda_msm.add_points(p, q)
        ref = cuda_msm.add_points(g1.map_coords(lambda c: c.cpu(), p), g1.map_coords(lambda c: c.cpu(), q))
        compare("add_unified", got, ref)
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
        ("fft 2048 x 5 (edge values)", random_fr(5, 2048), False),
    ]
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
    for label, win in (("2 MSMs", win2), ("1 MSM", win1)):
        got = cuda_msm.horner_windows(win, c_v)
        compare("horner", got, cuda_msm.horner_windows_ref(win, c_v))
        log(f"B3 {label} (c = {c_v}, 20 windows, the 2048-cell proof MSM): exact")

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
    got = cuda_msm.horner_windows(wide, 13)
    compare("horner", got, cuda_msm.horner_windows_ref(wide, 13))
    log("B3 1024 lanes (c = 13, 20 windows, with identity, P == Q and P == -Q lanes): exact against the plain version on the card")

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
    t_b2 = cuda_ms(lambda: cuda_msm.add_points(p_main, q_main), 50, queue_ahead=True)
    t_b2_plain = cuda_ms(lambda: cuda_msm.add_points_ref(p_main, q_main), 3)
    E64 = N_BLOBS * 20 * 4096  # elements the data needs (the rest is padding)
    b1_ops = E64 * FMULS["seg_scan_phase1"] * MULADDS_PER_FMUL
    b1_bytes = rows64.numel() * 4 + idx64.numel() * 4 + first64.numel() + 4 * 24 * 4 * idx64.numel()
    M2 = p_main.x.shape[-1]
    b2_ops = M2 * FMULS["add_unified"] * MULADDS_PER_FMUL
    b2_bytes = 12 * 24 * 4 * M2

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
    # windows). Two bounds: the card's throughput (operations over every
    # SM's multiply-add rate, or bytes) and the latency of one thread's
    # dependent chain of (w - 1)(9 c + 23) products at the SM clock.
    c_c = msm.default_window(cell_inputs[2].x.shape[-1], fixed_base=False)
    win_c = msm.window_sums(cell_inputs[2], cell_inputs[3], c_c)
    b3 = {}
    for label, win, c_w in (("proof MSM", win2, c_v), ("commitment MSM", win_c, c_c)):
        nb_w, w_w = win.x.shape[1:]
        ms = cuda_ms(lambda: cuda_msm.horner_windows(win, c_w), 20)
        plain = cuda_ms(lambda: cuda_msm.horner_windows_ref(win, c_w), 2)
        prods = (w_w - 1) * (9 * c_w + 23)
        t_ops = nb_w * prods * MULADDS_PER_FMUL / peak_imad * 1e3
        t_bytes = 4 * 24 * 4 * nb_w * (w_w + 1) / HBM_BYTES_PER_S * 1e3  # w windows in, one point out
        t_lat = prods * MULADDS_PER_FMUL / (sm_clock_mhz * 1e6) * 1e3
        b3[label] = (ms, plain, t_ops, t_bytes, t_lat)
        log(f"horner {label} ({nb_w} MSMs, c = {c_w}, {w_w} windows): {ms:.4f} ms (plain on the card {plain:.1f} ms); "
            f"throughput bound {max(t_ops, t_bytes):.5f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}; "
            f"operations {t_ops:.5f}, bytes {t_bytes:.6f}); latency bound {t_lat:.4f} ms "
            f"({prods} dependent products, {prods * MULADDS_PER_FMUL} multiply-adds at {sm_clock_mhz:.0f} MHz) [{card}]")
    t_b3, t_b3_plain, b3_ops, b3_bytes, _ = b3["proof MSM"]

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

    rows_out = []
    for name, ms, plain_ms, bound, by, source, replaces in (
        ("seg_scan_phase1", t_b1, t_plain_b1 * 1e3, max(b1_ops / peak_imad, b1_bytes / HBM_BYTES_PER_S) * 1e3,
         "operations" if b1_ops / peak_imad >= b1_bytes / HBM_BYTES_PER_S else "bytes",
         "kzg_tpu_torch/csrc/msm_kernels.cu", "kzg_tpu/ops/pallas_msm.py:94"),
        ("add_unified", t_b2, t_b2_plain, max(b2_ops / peak_imad, b2_bytes / HBM_BYTES_PER_S) * 1e3,
         "operations" if b2_ops / peak_imad >= b2_bytes / HBM_BYTES_PER_S else "bytes",
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
    log(f"B1 timed at K={K64} m={m64} ({E64} elements); B2 at {M2} lanes; B3 at the 2048-cell proof MSM's launch; "
        f"B4 and B5 as the sum of one {N_CELL_BLOBS}-blob cells-and-proofs call's launches; B6 at the gather probe's shape")
    for label, secs in verify_walls.items():
        log(f"verify {label}: {secs:.3f} s, peak device memory {verify_peaks[label] / 2**30:.2f} GiB; "
            f"launches {verify_launches[label]} [{card}]")
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
