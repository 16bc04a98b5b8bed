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
//     Bound: integer operations (23 Montgomery products per addition against
//     384 bytes in and 384 bytes out). Design: one thread per point pair, the
//     whole addition in registers, 16-bit limb loads and stores coalesced
//     across the threads of a warp; the launcher takes any lane count.
//
// B3  horner: replaces kzg_tpu/ops/pallas_msm.py:_horner_call (entry
//     horner_windows). The window combination of the variable-base MSM,
//     acc = sum_j 2^(c j) W_j from the high window to the low one: c
//     doublings and one complete addition per window, the first step
//     taking W_{w-1} as it is. On the verify paths there are one or two
//     MSMs (nb <= 2), so the work is one dependent chain of
//     (w - 1)(9 c + 23) Montgomery products per lane: bound by the
//     latency of one thread's chain, far from the card's throughput.
//     Design: one thread per MSM lane, the XYZZ accumulator in registers
//     for all w windows, each window read from device memory as it is
//     needed; any lane count, in blocks of up to 128 threads. (The TPU
//     kernel's (8, 128) lane tile, VMEM scratch and grid over the windows
//     are not carried over.)
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

__device__ __forceinline__ Xyzz load_point(const int32_t* x, const int32_t* y, const int32_t* zz,
                                           const int32_t* zzz, size_t off, size_t stride) {
    return {load_limbs16(x + off, stride), load_limbs16(y + off, stride),
            load_limbs16(zz + off, stride), load_limbs16(zzz + off, stride)};
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

// p, q, out: (24, M) 16-bit limbs, element i at column i.
__global__ void __launch_bounds__(BLOCK) add_unified_kernel(
    const int32_t* __restrict__ px, const int32_t* __restrict__ py,
    const int32_t* __restrict__ pzz, const int32_t* __restrict__ pzzz,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qzz, const int32_t* __restrict__ qzzz,
    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ ozz,
    int32_t* __restrict__ ozzz, int M) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    Xyzz p = load_point(px, py, pzz, pzzz, i, M);
    Xyzz q = load_point(qx, qy, qzz, qzzz, i, M);
    store_point(ox, oy, ozz, ozzz, i, M, add_unified(p, q));
}

// win: (24, nb, w) 16-bit limbs, window j of MSM b at column b * w + j;
// out: (24, nb).
__global__ void __launch_bounds__(BLOCK) horner_kernel(
    const int32_t* __restrict__ wx, const int32_t* __restrict__ wy,
    const int32_t* __restrict__ wzz, const int32_t* __restrict__ wzzz,
    int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ ozz,
    int32_t* __restrict__ ozzz, int nb, int w, int c) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nb) return;
    const size_t stride = (size_t)nb * w;
    const size_t base = (size_t)b * w;
    Xyzz acc = load_point(wx, wy, wzz, wzzz, base + w - 1, stride);
    for (int j = w - 2; j >= 0; j--) {
#pragma unroll 1
        for (int k = 0; k < c; k++) acc = dbl(acc);
        acc = add_unified(acc, load_point(wx, wy, wzz, wzzz, base + j, stride));
    }
    store_point(ox, oy, ozz, ozzz, b, nb, acc);
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
    const int grid = (M + BLOCK - 1) / BLOCK;
    add_unified_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (const int32_t*)py, (const int32_t*)pzz, (const int32_t*)pzzz,
        (const int32_t*)qx, (const int32_t*)qy, (const int32_t*)qzz, (const int32_t*)qzzz,
        (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz, M);
    return (int)cudaGetLastError();
}

extern "C" int kzg_horner(const void* wx, const void* wy, const void* wzz, const void* wzzz, void* ox,
                          void* oy, void* ozz, void* ozzz, int nb, int w, int c, void* stream) {
    const int grid = (nb + BLOCK - 1) / BLOCK;
    const int block = nb < BLOCK ? nb : BLOCK;
    horner_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)wx, (const int32_t*)wy, (const int32_t*)wzz, (const int32_t*)wzzz,
        (int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz, nb, w, c);
    return (int)cudaGetLastError();
}
