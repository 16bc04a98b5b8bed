// The four kernels of the MSMs, for sm_90a, each with a plain C launcher
// (bound with ctypes from kzg_tpu_torch/kernels.py; wrappers in
// kzg_tpu_torch/ops/cuda_msm.py).
//
// B1  seg_scan_phase1: replaces kzg_tpu/ops/pallas_msm.py:_phase1_packed_call
//     (entry seg_scan_phase1_mem). Phase 1 of the bucket segmented scan:
//     each chunk lane runs K sequential mixed additions (XYZZ += affine) over
//     its run of the key-sorted elements, restarting at segment starts and at
//     the chunk start, and writes the inclusive scan at every step.
//     Bound on this card: integer operations. A step of a lane needs 10
//     Montgomery products of 12 x 49 32-bit multiply-adds (madd-2008-s
//     without its doubling), and 7 more in a step where the row equals the
//     running sum (mdbl, the doubling of the row); the bytes (a 100-byte row
//     in, 384 bytes out a step) take a third of the multiply-add time at
//     3.35 TB/s. One thread per lane (the earlier design) ran all 17
//     products, the doubling's included, in one dependent chain at 255
//     registers with spills: 8 warps an SM. Design: scan::GROUP = 3 warps
//     (2, and 4 at six blocks an SM, measured slower: PERF.md) share a
//     block's 32 lanes, the running sums in shared memory slots for
//     all K steps (B2's layout, g1.cuh). A step is 4 dependency rounds of
//     at most 3 products, one warp each: u2 = x zz1, s2 = y zzz1 | pp =
//     pd^2, rr = r^2 | ppp = pd pp, q0 = x1 pp, zz3 = zz1 pp | y3a = r (q0 -
//     x3), sppp = y1 ppp, zzz3 = zzz1 ppp. The warp idle in round 1 gathers
//     the next step's rows into a second row buffer and writes the last
//     step's sums out, so neither is on the chain; the selects of a step
//     (restart, identity operands, doubling) run in round 0 of the next.
//     The doubling's 3 rounds run only in a block where __syncthreads_or
//     finds a lane with P == Q. Under __launch_bounds__(96, 8) eight blocks
//     (24 warps, 28 KB of slots each) fit an SM, so the main path's 1,024
//     blocks (32,768 lanes) run in one wave on 132 SMs. Neighbouring lanes
//     write neighbouring addresses.
//
// B2  add_unified: replaces kzg_tpu/ops/pallas_msm.py:_add_call (entries
//     add_points_tiled, tiled_add_unified). Elementwise complete XYZZ
//     addition over any flat batch: the chunk-aggregate scan and carry-in
//     (phases 2-3) and the bucket-integration reductions and suffix scans.
//     Bound: integer operations, 14 Montgomery products per addition (9
//     more where P == Q) against 384 bytes in and 384 bytes out. One thread
//     per point (the earlier design) ran all 23 products of the addition and
//     its doubling fallback in one dependent chain, at 255 registers with
//     spills, 8 warps an SM at most; a launch of tens of lanes was one
//     thread's latency. Design: GROUP = 4 warps (4 threads per point, chosen
//     by measurement among 2, 4 and 8; g1.cuh) share 32 points, each product of a dependency round on one
//     warp, the values in shared memory (g1.cuh); the doubling runs only in
//     blocks that hold a point with P == Q. The modulus is an immediate
//     operand (field.cuh) and a thread holds one product's operands, so
//     under __launch_bounds__(128, 6) it needs no spills: six blocks of 128
//     threads (24 warps) fit an SM's registers and shared memory (28 KB a
//     block). Each warp
//     loads and stores whole coordinates of the block's 32 points,
//     coalesced.
//
// B3  horner: replaces kzg_tpu/ops/pallas_msm.py:_horner_call (entry
//     horner_windows). The window combination of the variable-base MSM,
//     acc = sum_j 2^(c j) W_j from the high window to the low one: c
//     doublings and one complete addition per window, the first step
//     taking W_{w-1} as it is. On the verify paths there are one or two
//     MSMs (nb <= 2), far from the card's throughput: the time is the
//     latency of the dependent chain. One thread per MSM (the earlier
//     design) ran (w - 1)(9 c + 23) products one after another. Design:
//     the same cooperative addition and doubling as B2, GROUP warps on 32
//     MSM lanes, so the chain is (w - 1)(3 c + 4) product rounds deep; the
//     accumulator stays in shared memory for all w windows, and each
//     window is read from device memory as it is needed. (The TPU kernel's
//     (8, 128) lane tile, VMEM scratch and grid over the windows are not
//     carried over.)
//
// B9  integrate: replaces no TPU kernel (the JAX package integrates with
//     jnp adds; the plain version, ops/cuda_msm.py integrate_buckets_ref,
//     is the square split in some 3,300-6,500 PyTorch launches). Bucket
//     integration of an MSM, sum_{b=1}^{B-1} b S_b for every row (every
//     (batch, window) pair) of XYZZ bucket sums, in one launch.
//     A row's B buckets are spread over T units, unit t owning the buckets
//     b = j T + t (so the units of a row read neighbouring words); each
//     runs the two running sums from the top step down, acc += run then
//     run += S_b, which leaves W_t = sum_j j S_{jT+t} and R_t = sum_j
//     S_{jT+t}, and the row's sum is T sum_t W_t + sum_t t R_t. The two
//     additions of a step are independent, so each unit takes two of the
//     block's 32 lanes of B2's cooperative addition (g1.cuh): a step is one
//     addition, 4 product rounds deep. The units then combine in log T
//     rounds of additions without doublings: an all-reduce of the W (each
//     unit holds Omega = sum W) beside a suffix scan of the R (Suf_t), then
//     Z_t = Omega + Suf_t (Z_0 = Omega) and a tree sum of the Z:
//     sum_t Z_t = T Omega + sum_t t R_t. A row spread over nbk > 1
//     blocks (16 units each) leaves each block's (L, omega, rho) in
//     scratch; the row's last block to finish (an atomic count a row, set
//     back to 0 by that block) adds sum L + 16 ((nbk - 1) Omega +
//     sum_beta beta rho_beta), the second term by the same all-reduce,
//     suffix scan and tree sum, then 4 doublings.
//     Bound on this card: a row of B buckets takes 2 (B - 1) complete
//     additions, 14 products each (9 more where P == Q), as many as the
//     plain square split; the bytes (384 a bucket) take a tenth of that
//     time at 3.35 TB/s. At a few rows the chain (about 4 J + 8 log2 T
//     rounds) bounds it. The wrapper picks T (units of a row: cols in a
//     block, times nbk blocks) from the shape, the fewest rounds on the
//     chain against the rounds the card's SMs must run, with no knob.
//
// All four reduce every field value fully to [0, p), so their outputs
// equal the plain PyTorch versions limb for limb (B9's the same point as
// its plain version's, in other XYZZ coordinates: its additions run in
// another order).
#include <cstdint>
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace kzg;

namespace {

constexpr int ROW_WORDS = 2 * NL + 1;  // [x | y | inf]

// Coordinate pointers of point batches, picked by a warp-uniform index
// through selects (an indexed kernel parameter would go through local memory)
struct Coords4 {
    int32_t *x, *y, *zz, *zzz;
    __device__ __forceinline__ int32_t* operator[](int k) const { return k == 0 ? x : k == 1 ? y : k == 2 ? zz : zzz; }
};

struct Coords8 {
    const int32_t *px, *py, *pzz, *pzzz, *qx, *qy, *qzz, *qzzz;
    __device__ __forceinline__ const int32_t* operator[](int k) const {
        return k < 4 ? (k == 0 ? px : k == 1 ? py : k == 2 ? pzz : pzzz) : (k == 4 ? qx : k == 5 ? qy : k == 6 ? qzz : qzzz);
    }
};

// ---------------------------------------------------------------------------
// B1. Step t of a block keeps its flags in parity t & 1 and reads its row
// from buffer t & 1, so the next step's row and the previous step's flags
// live beside them. The slots:
//   SX .. SZZZ    the running sum (after the selects of the last step)
//   RX, RY        the row (x, y) of buffer 0; RX + 2, RY + 2 of buffer 1
//   PD, RS        pd = u2 - x1, r = s2 - y1 (round 0)
//   PP, RR        pd^2, r^2 (round 1)
//   PPP, Q0, Z3   pd pp, x1 pp, zz1 pp (round 2)
//   X3, Y3A, SP, W3   x3 (in PD's slot), r (q0 - x3) (in PP's), y1 ppp,
//                 zzz1 ppp (round 3)
// The doubling of the row (mdbl, after round 3) writes x3d, v and w into
// SX, SZZ and SZZZ of the lanes that double (no select reads them there),
// and leaves msd and wy (y3d = msd - wy) in Q0's and RS's slots.
// ---------------------------------------------------------------------------
namespace scan {

constexpr int GROUP = 3;  // warps per block of 32 lanes; ops/cuda_msm.py states the same SCAN_GROUP
constexpr int BLOCKS_PER_SM = 8;
constexpr int LOADER = 2 % GROUP;  // round 1's task 2: loads rows, writes sums (a warp idle in round 1)

enum : int {
    SX = 0, SY, SZZ, SZZZ, RX, RY,  // RX + 2 b, RY + 2 b: row buffer b
    PD = 8, RS, PP, RR, PPP, Q0, Z3, SP, W3, T17, NSLOT_SCAN,
    X3 = PD, Y3A = PP,
    DV = RS, DXX = RR, DW = PPP, DS = Q0, DMM = T17, DMSD = Q0, DWY = RS,
};

struct ScanSlots {
    uint32_t w[NSLOT_SCAN][NL][GPTS];
    // per row buffer or step parity, one byte per lane
    uint8_t first[2][GPTS];  // the row restarts the sum (segment or chunk start)
    uint8_t inf2[2][GPTS];   // the row is the identity
    uint8_t inf1[2][GPTS];   // the running sum entering the step is the identity
    uint8_t pd0[2][GPTS], r0[2][GPTS];
};

// Coordinate k (0-3) of the sum after the step of parity q: the selects of
// ops/g1.py madd_unified and of the scan's restart, in their order
__device__ __forceinline__ Fp select(const ScanSlots& S, int k, int q, int lane) {
    const bool inf1 = S.inf1[q][lane], inf2 = S.inf2[q][lane];
    const bool dbl = S.pd0[q][lane] && S.r0[q][lane] && !inf1 && !inf2;
    const Fp old = sld(S, SX + k, lane);  // the doubling's x, zz, zzz where it doubled
    Fp r;
    switch (k) {
        case 0: r = sld(S, X3, lane); break;
        case 1:
            r = dbl ? fsub(sld(S, DMSD, lane), sld(S, DWY, lane)) : fsub(sld(S, Y3A, lane), sld(S, SP, lane));
            break;
        case 2: r = sld(S, Z3, lane); break;
        default: r = sld(S, W3, lane); break;
    }
    r = fsel(dbl && k != 1, old, r);
    r = fsel(inf2, old, r);
    Fp aff = k == 0 ? sld(S, RX + 2 * q, lane) : k == 1 ? sld(S, RY + 2 * q, lane) : fsel(inf2, fzero(), fone());
    return fsel(S.first[q][lane] || inf1, aff, r);
}

// The row of step u (element u * m + j) into row buffer b
__device__ __forceinline__ void load_row(ScanSlots& S, const uint32_t* rows, int r, const uint8_t* first, int u,
                                         int m, int j, bool live, int b, int lane) {
    Fp x = fzero(), y = fzero();
    uint32_t inf = 1;
    bool restart = true;
    if (live) {
        const uint32_t* row = rows + (size_t)r * ROW_WORDS;
#pragma unroll
        for (int i = 0; i < NL; i++) {
            x.v[i] = row[i];
            y.v[i] = row[NL + i];
        }
        inf = row[2 * NL];
        restart = u == 0 || first[(size_t)u * m + j] != 0;
    }
    sst(S, RX + 2 * b, lane, x);
    sst(S, RY + 2 * b, lane, y);
    S.inf2[b][lane] = inf != 0;
    S.first[b][lane] = restart;
}

// rows: (R2, 25) packed point rows; idx, first: (K, m), element (t, j) at
// t * m + j; outputs: (24, K, m) 16-bit limbs. Block: GROUP warps on 32
// chunk lanes j.
__global__ void __launch_bounds__(32 * GROUP, BLOCKS_PER_SM) seg_scan_phase1_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ idx, const uint8_t* __restrict__ first,
    Coords4 out, int K, int m) {
    __shared__ ScanSlots S;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = blockIdx.x * GPTS + lane;
    const bool live = j < m;
    const size_t stride = (size_t)K * m;
    int next_idx = 0;  // the loader's row index of the step after the next

    for (int k = warp; k < 4; k += GROUP) sst(S, SX + k, lane, fzero());
    if (warp == LOADER) {
        load_row(S, rows, live ? idx[j] : 0, first, 0, m, j, live, 0, lane);
        if (live && K > 1) next_idx = idx[(size_t)m + j];
    }
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < K; t++) {
        const int b = t & 1, q = b ^ 1;
        // round 0, after the selects of step t - 1 (parity q). Task 0: x and
        // zz, then pd = x zz1 - x1; task 1: y and zzz, then r = y zzz1 - y1
        for (int k = warp; k < 2; k += GROUP) {
            Fp zz1;
            if (t > 0) {
                sst(S, SX + k, lane, select(S, k, q, lane));
                zz1 = select(S, SZZ + k, q, lane);
                sst(S, SZZ + k, lane, zz1);
            } else {
                zz1 = sld(S, SZZ + k, lane);
            }
            Fp d = fsub(fmul(sld(S, (k == 0 ? RX : RY) + 2 * b, lane), zz1), sld(S, SX + k, lane));
            sst(S, k == 0 ? PD : RS, lane, d);
            if (k == 0) {
                S.pd0[b][lane] = fis_zero(d);
                S.inf1[b][lane] = fis_zero(zz1);
            } else {
                S.r0[b][lane] = fis_zero(d);
            }
        }
        __syncthreads();
        // round 1; task 2 (the loader) brings step t + 1's row and writes
        // step t - 1's sum
        for (int k = warp; k < 3; k += GROUP) {
            if (k < 2) {
                Fp a = sld(S, k == 0 ? PD : RS, lane);
                sst(S, k == 0 ? PP : RR, lane, fmul(a, a));
            } else {
                if (t + 1 < K) {
                    load_row(S, rows, next_idx, first, t + 1, m, j, live, q, lane);
                    if (live && t + 2 < K) next_idx = idx[(size_t)(t + 2) * m + j];
                }
                if (t > 0 && live)
                    for (int c = 0; c < 4; c++) store_limbs16(out[c] + (size_t)(t - 1) * m + j, stride, sld(S, SX + c, lane));
            }
        }
        const bool need_dbl = S.pd0[b][lane] && S.r0[b][lane] && !S.inf1[b][lane] && !S.inf2[b][lane];
        const bool any_dbl = __syncthreads_or(need_dbl);
        // round 2: ppp = pd pp, q0 = x1 pp, zz3 = zz1 pp
        for (int k = warp; k < 3; k += GROUP) {
            Fp a = sld(S, k == 0 ? PD : k == 1 ? SX : SZZ, lane);
            sst(S, k == 0 ? PPP : k == 1 ? Q0 : Z3, lane, fmul(a, sld(S, PP, lane)));
        }
        __syncthreads();
        // round 3: y3a = r (q0 - x3) with x3 = rr - ppp - 2 q0, sppp = y1 ppp,
        // zzz3 = zzz1 ppp
        for (int k = warp; k < 3; k += GROUP) {
            Fp a, c;
            if (k == 0) {
                Fp q0 = sld(S, Q0, lane);
                Fp x3 = fsub(fsub(sld(S, RR, lane), sld(S, PPP, lane)), fadd(q0, q0));
                sst(S, X3, lane, x3);
                a = sld(S, RS, lane);
                c = fsub(q0, x3);
            } else {
                a = sld(S, k == 1 ? SY : SZZZ, lane);
                c = sld(S, PPP, lane);
            }
            sst(S, k == 0 ? Y3A : k == 1 ? SP : W3, lane, fmul(a, c));
        }
        __syncthreads();
        if (any_dbl) {
            // mdbl of the row (dbl-2008-s at zz = zzz = 1, madd_unified's
            // fallback): v = u^2 (u = 2 y), xx = x^2 | w = u v, s = x v,
            // mm = m^2 (m = 3 xx) | msd = m (s - x3d) (x3d = mm - 2 s),
            // wy = w y
            const int rx = RX + 2 * b, ry = RY + 2 * b;
            for (int k = warp; k < 2; k += GROUP) {
                Fp a = sld(S, k == 0 ? ry : rx, lane);
                if (k == 0) a = fadd(a, a);
                Fp r = fmul(a, a);
                sst(S, k == 0 ? DV : DXX, lane, r);
                if (k == 0 && need_dbl) sst(S, SZZ, lane, r);
            }
            __syncthreads();
            for (int k = warp; k < 3; k += GROUP) {
                Fp a, c;
                if (k == 0) {
                    a = sld(S, ry, lane);
                    a = fadd(a, a);
                    c = sld(S, DV, lane);
                } else if (k == 1) {
                    a = sld(S, rx, lane);
                    c = sld(S, DV, lane);
                } else {
                    Fp xx = sld(S, DXX, lane);
                    a = fadd(fadd(xx, xx), xx);
                    c = a;
                }
                Fp r = fmul(a, c);
                sst(S, k == 0 ? DW : k == 1 ? DS : DMM, lane, r);
                if (k == 0 && need_dbl) sst(S, SZZZ, lane, r);
            }
            __syncthreads();
            for (int k = warp; k < 2; k += GROUP) {
                if (k == 0) {
                    Fp s = sld(S, DS, lane);
                    Fp x3d = fsub(sld(S, DMM, lane), fadd(s, s));
                    if (need_dbl) sst(S, SX, lane, x3d);
                    Fp xx = sld(S, DXX, lane);
                    sst(S, DMSD, lane, fmul(fadd(fadd(xx, xx), xx), fsub(s, x3d)));
                } else {
                    sst(S, DWY, lane, fmul(sld(S, DW, lane), sld(S, ry, lane)));
                }
            }
            __syncthreads();
        }
    }
    // the selects of the last step, then its sums
    const int q = (K - 1) & 1;
    for (int k = warp; k < 2; k += GROUP) {
        Fp a = select(S, k, q, lane);
        Fp c = select(S, SZZ + k, q, lane);
        sst(S, SX + k, lane, a);
        sst(S, SZZ + k, lane, c);
    }
    __syncthreads();
    if (live)
        for (int c = warp; c < 4; c += GROUP) store_limbs16(out[c] + (size_t)(K - 1) * m + j, stride, sld(S, SX + c, lane));
}

}  // namespace scan

// p, q (Coords8: px .. pzzz, qx .. qzzz), out: (24, M) 16-bit limbs, element
// i at column i. Block: GROUP warps on 32 points.
__global__ void __launch_bounds__(32 * GROUP, 24 / GROUP) add_unified_kernel(Coords8 in, Coords4 out, int M) {
    __shared__ Slots S;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x * GPTS + lane;
    const bool live = i < M;
    for (int k = warp; k < 8; k += GROUP) sst(S, k, lane, live ? load_limbs16(in[k] + i, M) : fzero());
    __syncthreads();
    group_add(S, warp, lane);
    for (int k = warp; k < 4; k += GROUP) {
        Fp r = add_result(S, k, lane);
        if (live) store_limbs16(out[k] + i, M, r);
    }
}

// win: (24, nb, w) 16-bit limbs, window j of MSM b at column b * w + j;
// out: (24, nb). Block: GROUP warps on 32 MSM lanes; the accumulator in slots
// 0-3, the window added in slots 4-7. One or two MSMs make one block, so
// the registers are not bounded for occupancy.
__global__ void __launch_bounds__(32 * GROUP, 1) horner_kernel(Coords4 win, Coords4 out, int nb, int w, int c) {
    __shared__ Slots S;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x * GPTS + lane;
    const bool live = b < nb;
    const size_t stride = (size_t)nb * w;
    const size_t base = (size_t)b * w;
    const DblSlots acc_dbl = {X1, Y1, ZZ1, ZZZ1, X1, Y1, ZZ1, ZZZ1, U1, U2, S1, S2, PP, RR};
    for (int k = warp; k < 4; k += GROUP) sst(S, X1 + k, lane, live ? load_limbs16(win[k] + base + w - 1, stride) : fzero());
    __syncthreads();
#pragma unroll 1
    for (int j = w - 2; j >= 0; j--) {
#pragma unroll 1
        for (int d = 0; d < c; d++) group_dbl(S, acc_dbl, true, warp, lane);
        for (int k = warp; k < 4; k += GROUP) sst(S, X2 + k, lane, live ? load_limbs16(win[k] + base + j, stride) : fzero());
        __syncthreads();
        group_add(S, warp, lane);
        for (int k = warp; k < 4; k += GROUP) sst(S, X1 + k, lane, add_result(S, k, lane));
        __syncthreads();
    }
    for (int k = warp; k < 4; k += GROUP)
        if (live) store_limbs16(out[k] + b, nb, sld(S, X1 + k, lane));
}

// ---------------------------------------------------------------------------
// B9. Lane 2u of a block accumulates for unit u (P = acc), lane 2u + 1 runs
// (P = run); every addition of the kernel is one group_add over all 32
// lanes, P in slots 0-3 plus Q in slots 4-7, whose result replaces P. Before
// it, each lane stages its Q: another lane's P, a bucket, or the identity.
// Warp c stages and writes back coordinate c of every lane, so a lane's P
// changes only after every lane that reads it has staged.
// ---------------------------------------------------------------------------
namespace integ {

constexpr int UNITS = GPTS / 2;  // units a block; ops/cuda_msm.py states the same INTEGRATE_UNITS
constexpr int LOG_UNITS = 4;
constexpr int CPW = (4 + GROUP - 1) / GROUP;  // coordinates a warp stages and writes back
static_assert(UNITS == 1 << LOG_UNITS, "LOG_UNITS");

struct Plan {
    int rows, B;
    int cols;  // units of a row in a block: a power of two, at most UNITS
    int nbk;   // blocks of a row; cols == UNITS where nbk > 1
    int J;     // steps: the buckets of a unit
};

__device__ __forceinline__ int log2_pow2(int x) { return __ffs(x) - 1; }

// Q of lane `lane`, coordinate c: P of lane `from`, or the identity where from < 0
__device__ __forceinline__ void stage(Slots& S, int c, int lane, int from) {
    sst(S, X2 + c, lane, from >= 0 ? sld(S, X1 + c, from) : fzero());
}

// P + Q on every lane into P, the block synchronized before and after
__device__ __forceinline__ void add_into_p(Slots& S, int warp, int lane) {
    __syncthreads();
    group_add(S, warp, lane);
    for (int c = warp; c < 4; c += GROUP) sst(S, X1 + c, lane, add_result(S, c, lane));
    __syncthreads();
}

// One addition in which every lane stages Q from lane `from` (or the identity)
__device__ __forceinline__ void add_from(Slots& S, int warp, int lane, int from) {
    for (int c = warp; c < 4; c += GROUP) stage(S, c, lane, from);
    add_into_p(S, warp, lane);
}

// A row's partial sums in scratch: (rows, nbk, 3, 4, 12) words, `which` 0
// for omega, 1 for rho, 2 for L
__device__ __forceinline__ uint32_t* part_at(uint32_t* part, const Plan& pl, int row, int beta, int which, int c) {
    return part + ((((size_t)row * pl.nbk + beta) * 3 + which) * 4 + c) * NL;
}

__device__ __forceinline__ void put_words(uint32_t* p, const Fp& a) {
#pragma unroll
    for (int i = 0; i < NL; i++) p[i] = a.v[i];
}

__device__ __forceinline__ Fp get_words(const uint32_t* p) {
    Fp r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = __ldcg(p + i);  // from L2: other blocks wrote them
    return r;
}

// buckets: (24, rows, B) 16-bit limbs, bucket b of row r at column r B + b;
// out: (24, rows). Block: GROUP warps on 16 units, lanes 2u and 2u + 1.
__global__ void __launch_bounds__(32 * GROUP, 5) integrate_kernel(Coords4 in, Coords4 out, Plan pl,
                                                                  uint32_t* __restrict__ part, int* __restrict__ count) {
    __shared__ Slots S;
    __shared__ int is_last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int u = lane >> 1;
    const bool run = lane & 1;
    const int cols = pl.cols, tau = log2_pow2(cols);
    const int i = u & (cols - 1);  // the unit's column in its block's share of the row
    int row, beta, t, T;           // the unit's row, block of the row, column among the row's T units
    if (pl.nbk > 1) {
        row = blockIdx.x / pl.nbk;
        beta = blockIdx.x % pl.nbk;
        t = beta * UNITS + u;
        T = UNITS * pl.nbk;
    } else {
        row = blockIdx.x * (UNITS / cols) + u / cols;
        beta = 0;
        t = i;
        T = cols;
    }
    const bool in_rows = row < pl.rows;
    const size_t plane = (size_t)pl.rows * pl.B;

    // S_b for step j, coordinate c, on a run lane; the identity for b = 0
    // (weight 0) and past the row's end
    auto bucket = [&](int c, int j) -> Fp {
        const int b = j * T + t;
        if (!run || !in_rows || b < 1 || b >= pl.B) return fzero();
        return load_limbs16(in[c] + (size_t)row * pl.B + b, plane);
    };

    // the running sums: acc += run, run += S_b, from the top step down; a
    // step's bucket is loaded one step ahead
    Fp next[CPW];
#pragma unroll
    for (int q = 0; q < CPW; q++) {
        const int c = warp + q * GROUP;
        if (c < 4) {
            sst(S, X1 + c, lane, fzero());
            next[q] = bucket(c, pl.J - 1);
        }
    }
    __syncthreads();
#pragma unroll 1
    for (int j = pl.J - 1; j >= 0; j--) {
#pragma unroll
        for (int q = 0; q < CPW; q++) {
            const int c = warp + q * GROUP;
            if (c >= 4) continue;
            if (run) {
                sst(S, X2 + c, lane, next[q]);
                if (j > 0) next[q] = bucket(c, j - 1);
            } else {
                stage(S, c, lane, lane + 1);
            }
        }
        add_into_p(S, warp, lane);
    }

    // the units of a block's share of the row: all-reduce of W on the acc
    // lanes beside a suffix scan of R on the run lanes, Z_i = Omega + Suf_i
    // (Z_0 = Omega) on the acc lanes, a tree sum of the Z
    for (int l = 0; l < tau; l++) {
        const int h = 1 << l;
        add_from(S, warp, lane, run ? (i + h < cols ? 2 * (u + h) + 1 : -1) : 2 * (u ^ h));
    }
    if (pl.nbk > 1 && u == 0)
        for (int c = warp; c < 4; c += GROUP) put_words(part_at(part, pl, row, beta, run, c), sld(S, X1 + c, lane));
    if (tau > 0) add_from(S, warp, lane, !run && i > 0 ? lane + 1 : -1);
    for (int l = 0; l < tau; l++) {
        const int h = 1 << l;
        add_from(S, warp, lane, !run && (i & (2 * h - 1)) == 0 ? 2 * (u + h) : -1);
    }
    if (pl.nbk == 1) {
        if (!run && i == 0 && in_rows)
            for (int c = warp; c < 4; c += GROUP) store_limbs16(out[c] + row, pl.rows, sld(S, X1 + c, lane));
        return;
    }

    // a row over several blocks: its last block to finish adds the partials
    if (u == 0 && !run)
        for (int c = warp; c < 4; c += GROUP) put_words(part_at(part, pl, row, beta, 2, c), sld(S, X1 + c, lane));
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        is_last = atomicAdd(count + row, 1) == pl.nbk - 1;
        if (is_last) count[row] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const int nb = pl.nbk, tau2 = 32 - __clz(nb - 1);  // nb <= 2^tau2 <= UNITS
    for (int c = warp; c < 4; c += GROUP)
        sst(S, X1 + c, lane, u < nb ? get_words(part_at(part, pl, row, u, run, c)) : fzero());
    __syncthreads();
    // all-reduce of the omegas beside a suffix scan of the rhos
    for (int l = 0; l < tau2; l++) {
        const int h = 1 << l;
        add_from(S, warp, lane, run ? (u + h < (1 << tau2) ? 2 * (u + h) + 1 : -1) : 2 * (u ^ h));
    }
    // run lanes: Z_beta = Omega + Suf_beta for 1 <= beta < nb, else the
    // identity; acc lanes: L_beta
    for (int c = warp; c < 4; c += GROUP) stage(S, c, lane, run ? lane - 1 : -1);
    __syncthreads();
    group_add(S, warp, lane);
    for (int c = warp; c < 4; c += GROUP) {
        Fp r = fzero();
        if (u < nb) r = run ? (u > 0 ? add_result(S, c, lane) : r) : get_words(part_at(part, pl, row, u, 2, c));
        sst(S, X1 + c, lane, r);
    }
    __syncthreads();
    // tree sums of both: sum L on lane 0, sum Z on lane 1
    for (int l = 0; l < tau2; l++) {
        const int h = 1 << l;
        add_from(S, warp, lane, (u & (2 * h - 1)) == 0 ? 2 * (u + h) + run : -1);
    }
    // 16 sum Z (lane 1), then sum L + 16 sum Z (lane 0)
    const DblSlots in_place = {X1, Y1, ZZ1, ZZZ1, X1, Y1, ZZ1, ZZZ1, U1, U2, S1, S2, PP, RR};
#pragma unroll 1
    for (int d = 0; d < LOG_UNITS; d++) group_dbl(S, in_place, lane == 1, warp, lane);
    add_from(S, warp, lane, lane == 0 ? 1 : -1);
    if (lane == 0)
        for (int c = warp; c < 4; c += GROUP) store_limbs16(out[c] + row, pl.rows, sld(S, X1 + c, lane));
}

}  // namespace integ

}  // namespace

extern "C" int kzg_seg_scan_phase1(const void* rows, const void* idx, const void* first, void* ox,
                                   void* oy, void* ozz, void* ozzz, int K, int m, void* stream) {
    // eight blocks' slots need the largest shared memory carveout
    cudaError_t err = cudaFuncSetAttribute(scan::seg_scan_phase1_kernel,
                                           cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    Coords4 out = {(int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz};
    const int grid = (m + GPTS - 1) / GPTS;
    scan::seg_scan_phase1_kernel<<<grid, 32 * scan::GROUP, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)idx, (const uint8_t*)first, out, K, m);
    return (int)cudaGetLastError();
}

extern "C" int kzg_add_unified(const void* px, const void* py, const void* pzz, const void* pzzz,
                               const void* qx, const void* qy, const void* qzz, const void* qzzz,
                               void* ox, void* oy, void* ozz, void* ozzz, int M, void* stream) {
    Coords8 in = {(const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz, (const int32_t*)pzzz,
                  (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)qzz, (const int32_t*)qzzz};
    Coords4 out = {(int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz};
    const int grid = (M + GPTS - 1) / GPTS;
    add_unified_kernel<<<grid, 32 * GROUP, 0, (cudaStream_t)stream>>>(in, out, M);
    return (int)cudaGetLastError();
}

extern "C" int kzg_horner(const void* wx, const void* wy, const void* wzz, const void* wzzz, void* ox,
                          void* oy, void* ozz, void* ozzz, int nb, int w, int c, void* stream) {
    Coords4 win = {(int32_t*)wx, (int32_t*)wy, (int32_t*)wzz, (int32_t*)wzzz};
    Coords4 out = {(int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz};
    const int grid = (nb + GPTS - 1) / GPTS;
    horner_kernel<<<grid, 32 * GROUP, 0, (cudaStream_t)stream>>>(win, out, nb, w, c);
    return (int)cudaGetLastError();
}

extern "C" int kzg_integrate(const void* bx, const void* by, const void* bzz, const void* bzzz, void* ox, void* oy,
                             void* ozz, void* ozzz, int rows, int B, int cols, int nbk, int J, void* part, void* count,
                             void* stream) {
    using namespace integ;
    if (rows < 1 || B < 1 || J < 1 || cols < 1 || cols > UNITS || (cols & (cols - 1)) || nbk < 1 || nbk > UNITS ||
        (nbk > 1 && cols != UNITS) || (long long)J * cols * nbk < B)
        return (int)cudaErrorInvalidValue;
    // five blocks' slots need more than the default shared memory carveout
    cudaError_t err = cudaFuncSetAttribute(integrate_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    Coords4 in = {(int32_t*)bx, (int32_t*)by, (int32_t*)bzz, (int32_t*)bzzz};
    Coords4 out = {(int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz};
    const Plan pl = {rows, B, cols, nbk, J};
    const int grid = nbk > 1 ? rows * nbk : (rows + UNITS / cols - 1) / (UNITS / cols);
    integrate_kernel<<<grid, 32 * GROUP, 0, (cudaStream_t)stream>>>(in, out, pl, (uint32_t*)part, (int*)count);
    return (int)cudaGetLastError();
}
