// The three kernels of the MSMs, for sm_90a, each with a plain C launcher
// (bound with ctypes from kzg_tpu_torch/kernels.py; wrappers in
// kzg_tpu_torch/ops/cuda_msm.py).
//
// B1  seg_scan_phase1: replaces kzg_tpu/ops/pallas_msm.py:_phase1_packed_call
//     (entry seg_scan_phase1_mem). Phase 1 of the bucket segmented scan:
//     each chunk lane runs K sequential mixed additions (XYZZ += affine) over
//     its run of the key-sorted elements, restarting at segment starts and at
//     the chunk start, and writes the inclusive scan at every step.
//     Bound on this card: integer operations. One madd_unified is 17 Montgomery
//     products of 12 x 49 32-bit multiply-adds; the bytes (a 100-byte row in,
//     384 bytes out per step) are far below the multiply-add time at 3.35 TB/s.
//     Design: one thread per chunk lane, the XYZZ accumulator (48 words) kept
//     in registers across all K steps, so nothing but the outputs leaves the
//     SM. The kernel gathers its own rows from the packed point table by the
//     sorted source-row index (the TPU path gathered them in a separate pass);
//     the 32-bit words of a row are the field's 32-bit limbs, so a row needs
//     no unpacking. Neighbouring threads write neighbouring addresses.
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
// All three reduce every field value fully to [0, p), so their outputs
// equal the plain PyTorch versions limb for limb.
#include <cstdint>
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace kzg;

namespace {

constexpr int ROW_WORDS = 2 * NL + 1;  // [x | y | inf]
constexpr int BLOCK = 128;

__device__ __forceinline__ void store_point(int32_t* ox, int32_t* oy, int32_t* ozz, int32_t* ozzz,
                                            size_t off, size_t stride, const Xyzz& p) {
    store_limbs16(ox + off, stride, p.x);
    store_limbs16(oy + off, stride, p.y);
    store_limbs16(ozz + off, stride, p.zz);
    store_limbs16(ozzz + off, stride, p.zzz);
}

// rows: (R2, 25) packed point rows; idx, first: (K, m), element (t, lane) at
// t * m + lane; outputs: (24, K, m) 16-bit limbs.
__global__ void __launch_bounds__(BLOCK) seg_scan_phase1_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ first, int32_t* __restrict__ ox, int32_t* __restrict__ oy,
    int32_t* __restrict__ ozz, int32_t* __restrict__ ozzz, int K, int m) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= m) return;
    const size_t stride = (size_t)K * m;
    Xyzz acc = {fzero(), fzero(), fzero(), fzero()};
    for (int t = 0; t < K; t++) {
        const size_t e = (size_t)t * m + lane;
        const uint32_t* row = rows + (size_t)idx[e] * ROW_WORDS;
        Aff a;
#pragma unroll
        for (int i = 0; i < NL; i++) {
            a.x.v[i] = row[i];
            a.y.v[i] = row[NL + i];
        }
        a.inf = row[2 * NL] != 0;
        Xyzz comb = madd_unified(acc, a);
        // a segment start or the chunk start restarts the running sum
        acc = psel(first[e] != 0 || t == 0, from_affine(a), comb);
        store_point(ox, oy, ozz, ozzz, e, stride, acc);
    }
}

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

}  // namespace

extern "C" int kzg_seg_scan_phase1(const void* rows, const void* idx, const void* first, void* ox,
                                   void* oy, void* ozz, void* ozzz, int K, int m, void* stream) {
    const int grid = (m + BLOCK - 1) / BLOCK;
    seg_scan_phase1_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const int32_t*)idx, (const uint8_t*)first, (int32_t*)ox,
        (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz, K, m);
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
