// The fixed-scalar G1 ladder of the G1 FFT and of FK20's half convolution,
// for sm_90a, with a plain C launcher (bound with ctypes from
// kzg_tpu_torch/kernels.py; wrapper kzg_tpu_torch/ops/g1fft.py ladder).
//
// B8  g1_ladder: replaces no TPU kernel. The JAX package's ladder
//     (kzg_tpu/ops/g1fft.py) is jnp code, and so is the port's plain
//     version (ops/g1fft.py _ladder): on the card each doubling is dozens of
//     small PyTorch launches and each addition one launch of B2, so FK20's
//     half convolution of 9 blobs (74,880 lanes, 26 windows of c = 5, two
//     GLV tables) was about 130,000 launches with the card idle between
//     them. Lane l multiplies a point by a fixed scalar given as signed
//     c-bit digits: from the top window down, c doublings, then for each
//     table t (1, or 2 for a GLV split) one complete addition of
//     +-mult[|d|] (the point's multiples 0 .. 2^(c-1)), where table 1 is
//     phi of table 0: phi(x, y) = (beta x, y). Digit d of window j and
//     table t is digits[t][j][l mod D], so the digit tables stay as small
//     as their distinct columns (D = 65 taps, h twiddles, or 1 scale).
//     Bound: integer operations. A lane needs w c doublings (9 Montgomery
//     products each) and w T additions (14 each, 9 more where P == Q), of
//     12 x 49 32-bit multiply-adds a product: at the half convolution's
//     shape 1,898 products a lane, 83.6 G multiply-adds, about 5 ms at the
//     card's 16.7 T/s; the bytes (the table entries, read from L2, and 384
//     bytes out a lane) are a small fraction of that.
//     Design: B3's schedule (g1.cuh): GROUP warps on 32 lanes, each product
//     of a dependency round of the doubling and the addition on one warp,
//     the accumulator in shared memory slots for all windows, so the whole
//     ladder is one launch and no intermediate point touches device
//     memory. The multiples are kept once a distinct point, not once a
//     lane (1,152 points against 74,880 lanes in the half convolution):
//     the kernel gathers a lane's entry through its point index `src`,
//     from rows of 24 contiguous limbs (a 16-byte-aligned row of 96
//     bytes, read as six 16-byte loads), negates y where the digit is
//     negative and multiplies x by beta for table 1, so the phi table is
//     never stored. Five blocks of 128 threads and 28 KB of slots an SM
//     (BLOCKS_PER_SM): at B2's six, ptxas caps the registers at 80 and
//     spills; at five it takes 96 and spills nothing, at the same time.
//
// fmul, fadd and fsub reduce every value fully to [0, p), so the result
// equals the plain version limb for limb.
#include <cstdint>
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace kzg;

namespace {

constexpr int LIMBS = 2 * NL;  // 16-bit limbs of an Fp value
constexpr int BLOCKS_PER_SM = 5;

struct Coords4 {
    int32_t *x, *y, *zz, *zzz;
    __device__ __forceinline__ int32_t* operator[](int k) const { return k == 0 ? x : k == 1 ? y : k == 2 ? zz : zzz; }
};

// 24 contiguous 16-bit limbs, 16-byte aligned -> twelve 32-bit words
__device__ __forceinline__ Fp load_row(const int32_t* src) {
    const int4* v = reinterpret_cast<const int4*>(src);
    Fp r;
#pragma unroll
    for (int q = 0; q < LIMBS / 4; q++) {
        const int4 t = __ldg(v + q);
        r.v[2 * q] = (uint32_t)t.x | ((uint32_t)t.y << 16);
        r.v[2 * q + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
    }
    return r;
}

// rows: (P, m, 4, 24) 16-bit limbs, m = 2^(c-1) + 1: coordinate k of
// multiple i of point p; digits: (T, w, D) signed digits in [-(m - 1),
// m - 1]; src: (N,) the point of each lane, or null for lane l on point l;
// beta: (24,) limbs of beta (read for T = 2); out: (24, N). Block: GROUP
// warps on 32 lanes; the accumulator in slots 0-3, the table entry in 4-7.
__global__ void __launch_bounds__(32 * GROUP, BLOCKS_PER_SM) g1_ladder_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ digits, const int32_t* __restrict__ src,
    const int32_t* __restrict__ beta, Coords4 out, int tables, int w, int D, int N, int c) {
    __shared__ Slots S;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int l = blockIdx.x * GPTS + lane;
    const bool live = l < N;
    const size_t m = ((size_t)1 << (c - 1)) + 1;
    const size_t point = live ? (src ? (size_t)src[l] : (size_t)l) : 0;
    const int32_t* lane_rows = rows + point * m * 4 * LIMBS;
    const int col = live ? l % D : 0;
    const DblSlots acc_dbl = {X1, Y1, ZZ1, ZZZ1, X1, Y1, ZZ1, ZZZ1, U1, U2, S1, S2, PP, RR};
    for (int k = warp; k < 4; k += GROUP) sst(S, X1 + k, lane, fzero());
    __syncthreads();
#pragma unroll 1
    for (int j = w - 1; j >= 0; j--) {
#pragma unroll 1
        for (int d = 0; d < c; d++) group_dbl(S, acc_dbl, true, warp, lane);
#pragma unroll 1
        for (int t = 0; t < tables; t++) {
            // a dead lane adds the identity (multiple 0) to the identity
            const int digit = live ? __ldg(digits + ((size_t)t * w + j) * D + col) : 0;
            const size_t mag = digit < 0 ? -digit : digit;
            for (int k = warp; k < 4; k += GROUP) {
                Fp v = load_row(lane_rows + (mag * 4 + k) * LIMBS);
                if (k == 0 && t == 1) v = fmul(v, load_limbs16(beta, 1));
                if (k == 1) v = fsel(digit < 0, fsub(fzero(), v), v);
                sst(S, X2 + k, lane, v);
            }
            __syncthreads();
            group_add(S, warp, lane);
            for (int k = warp; k < 4; k += GROUP) sst(S, X1 + k, lane, add_result(S, k, lane));
            __syncthreads();
        }
    }
    if (live)
        for (int k = warp; k < 4; k += GROUP) store_limbs16(out[k] + l, N, sld(S, X1 + k, lane));
}

}  // namespace

extern "C" int kzg_g1_ladder(const void* rows, const void* digits, const void* src, const void* beta, void* ox,
                             void* oy, void* ozz, void* ozzz, int tables, int w, int D, int N, int c,
                             void* stream) {
    if (tables < 1 || tables > 2 || (tables == 2 && beta == nullptr) || w < 1 || D < 1 || N < 1 || c < 1 || c > 8)
        return (int)cudaErrorInvalidValue;
    // five blocks' slots need the larger part of the SM's shared memory
    cudaError_t err = cudaFuncSetAttribute(g1_ladder_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    Coords4 out = {(int32_t*)ox, (int32_t*)oy, (int32_t*)ozz, (int32_t*)ozzz};
    const int grid = (N + GPTS - 1) / GPTS;
    g1_ladder_kernel<<<grid, 32 * GROUP, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const int32_t*)digits, (const int32_t*)src, (const int32_t*)beta, out, tables, w, D, N,
        c);
    return (int)cudaGetLastError();
}
