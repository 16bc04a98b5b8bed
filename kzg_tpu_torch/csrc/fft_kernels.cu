// The two kernels of the radix-2 Fr NTT (ops/fft.py), for sm_90a, each with
// a plain C launcher (bound with ctypes from kzg_tpu_torch/kernels.py;
// wrappers in kzg_tpu_torch/ops/cuda_fft.py).
//
// Tensors keep the package's layout: (16, B, n) int32, 16-bit limbs on axis
// 0, B independent transforms of length n = 2^log_n, Montgomery form. The
// transform is decimation in time on bit-reversed input: stage s pairs
// positions a and a + 2^s (a's bit s clear) with the twiddle
// w_{2^(s+1)}^(a mod 2^s) = w_n^((a mod 2^s) << (log_n - s - 1)), so one table
// of w_n^k, k < n/2, serves every stage. It is limb-major, (8, n/2) 32-bit
// words, so neighbouring threads read neighbouring words.
//
// B4  ntt_tile: replaces kzg_tpu/ops/pallas_fft.py:_kernel_ab (entry
//     fft_pallas). One block owns a tile of 2^S consecutive positions of one
//     transform, S = min(log_n, 11): it gathers its elements through the
//     bit-reversal permutation itself (the TPU path ran the gather as a
//     separate XLA pass), applies the inverse transform's 1/n scale on load
//     (as the TPU kernel does; the scale commutes with the stages), runs
//     stages 0..S-1 in shared memory with __syncthreads() between stages, one
//     Fr product per butterfly pair, and writes the tile back. A transform of
//     n <= 2^11 (the FK20 Toeplitz transforms, n = 128) is one block of its
//     own: 1024 of them per 16 blobs keep every SM busy without packing.
//     S = 11 (64 KB of dynamic shared memory, three blocks per SM) rather
//     than 12 (128 KB, one block per SM): the n = 8192 transform needs a
//     global pass either way, and three resident blocks hide the
//     __syncthreads() of one behind the others' arithmetic.
//     Shared memory is limb-major (word w of element i at w * tile + i), so
//     a warp touching 32 neighbouring elements hits 32 banks; the first five
//     stages pair elements closer than a warp and see up to 2-way conflicts.
//     Bound: integer operations (264 32-bit multiply-adds per product, n/2
//     products per stage) above the bytes (64 bytes in and out per element).
//
// B5  ntt_stage: replaces kzg_tpu/ops/pallas_fft.py:_kernel_c_stage. One
//     stage s >= S over device memory, one thread per butterfly pair, one
//     launch per stage (the TPU path also ran one call per tile stage).
//     Neighbouring threads take neighbouring pairs, so loads and stores are
//     coalesced for 2^s >= 32. Bound: bytes (two values in and two out, 256
//     bytes in the 16-bit limb layout per product: about five times the
//     product's multiply-add time), so the design keeps to one pass per
//     stage and neighbouring addresses.
//
// Both reduce every value fully to [0, r), so their outputs equal the plain
// PyTorch versions limb for limb.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int MAX_LOG_TILE = 11;
constexpr int THREADS = 256;

__device__ __forceinline__ Fr load_words(const uint32_t* base, size_t stride, size_t i) {
    Fr r;
#pragma unroll
    for (int w = 0; w < NLR; w++) r.v[w] = base[w * stride + i];
    return r;
}

__device__ __forceinline__ void store_words(uint32_t* base, size_t stride, size_t i, const Fr& a) {
#pragma unroll
    for (int w = 0; w < NLR; w++) base[w * stride + i] = a.v[w];
}

// in, out: (16, B, n) 16-bit limbs, total = B * n; tw: (8, n/2) words;
// scale: 8 words of 1/n in Montgomery form, or null for the forward
// transform. Block g owns flattened positions [g * tile, (g + 1) * tile).
__global__ void __launch_bounds__(THREADS) ntt_tile_kernel(
    const int32_t* __restrict__ in, int32_t* __restrict__ out, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ scale, int log_n, int log_tile, size_t total) {
    extern __shared__ uint32_t sm[];
    const int tile = 1 << log_tile;
    const size_t half_n = (size_t)1 << (log_n - 1);
    const size_t g0 = (size_t)blockIdx.x << log_tile;
    const size_t row = g0 >> log_n << log_n;  // first element of this transform
    const unsigned p0 = (unsigned)(g0 - row);  // tile offset inside it
    Fr sc;
    if (scale != nullptr) {
#pragma unroll
        for (int w = 0; w < NLR; w++) sc.v[w] = scale[w];
    }
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const unsigned src = __brev(p0 + (unsigned)i) >> (32 - log_n);
        Fr v = load_fr16(in + row + src, total);
        if (scale != nullptr) v = rmul(v, sc);
        store_words(sm, tile, i, v);
    }
    __syncthreads();
    for (int s = 0; s < log_tile; s++) {
        const int h = 1 << s;
        for (int k = threadIdx.x; k < tile / 2; k += blockDim.x) {
            const int j = k & (h - 1);
            const int a = ((k >> s) << (s + 1)) | j;
            Fr x = load_words(sm, tile, a);
            Fr y = load_words(sm, tile, a + h);
            // the tile is aligned to 2^(s+1), so a mod 2^s is j; stage 0's
            // twiddle is one
            if (s > 0) y = rmul(y, load_words(tw, half_n, (size_t)j << (log_n - s - 1)));
            store_words(sm, tile, a, radd(x, y));
            store_words(sm, tile, a + h, rsub(x, y));
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < tile; i += blockDim.x)
        store_fr16(out + g0 + i, total, load_words(sm, tile, i));
}

// in, out: (16, B, n) 16-bit limbs, total = B * n; one thread per pair of
// stage s over the flattened batch (n is a multiple of 2^(s+1), so a pair
// never straddles two transforms).
__global__ void __launch_bounds__(THREADS) ntt_stage_kernel(
    const int32_t* __restrict__ in, int32_t* __restrict__ out, const uint32_t* __restrict__ tw,
    int log_n, int s, size_t total) {
    const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= total / 2) return;
    const size_t half_n = (size_t)1 << (log_n - 1);
    const size_t h = (size_t)1 << s;
    const size_t j = k & (h - 1);
    const size_t a = ((k >> s) << (s + 1)) | j;
    Fr x = load_fr16(in + a, total);
    Fr y = rmul(load_fr16(in + a + h, total), load_words(tw, half_n, j << (log_n - s - 1)));
    store_fr16(out + a, total, radd(x, y));
    store_fr16(out + a + h, total, rsub(x, y));
}

}  // namespace

extern "C" int kzg_ntt_tile(const void* in, void* out, const void* tw, const void* scale, int log_n,
                            long long total, void* stream) {
    const int log_tile = log_n < MAX_LOG_TILE ? log_n : MAX_LOG_TILE;
    const int tile = 1 << log_tile;
    const int threads = tile / 2 < THREADS ? tile / 2 : THREADS;
    const size_t smem = sizeof(uint32_t) * NLR * (size_t)tile;
    cudaError_t err = cudaFuncSetAttribute(ntt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long grid = total >> log_tile;
    ntt_tile_kernel<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, (const uint32_t*)tw, (const uint32_t*)scale, log_n, log_tile,
        (size_t)total);
    return (int)cudaGetLastError();
}

extern "C" int kzg_ntt_stage(const void* in, void* out, const void* tw, int log_n, int s, long long total,
                             void* stream) {
    const long long pairs = total / 2;
    const long long grid = (pairs + THREADS - 1) / THREADS;
    ntt_stage_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, (const uint32_t*)tw, log_n, s, (size_t)total);
    return (int)cudaGetLastError();
}
