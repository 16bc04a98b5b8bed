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
//     fft_pallas). The tile of 2^S consecutive positions of one transform,
//     S = min(log_n, 11): the bit-reversal gather (the TPU path ran it as a
//     separate XLA pass), the inverse transform's 1/n scale on load (as the
//     TPU kernel; the scale commutes with the stages), and stages 0..S-1.
//     Bound: integer operations (264 32-bit multiply-adds per product, n/2
//     products per stage) above the bytes (64 bytes in and out per value).
//     The earlier design ran a whole 2^11 tile in one block: 32 and 64
//     blocks for the cells call's inverse 4096 and forward 8192 of 16 blobs,
//     a quarter and a half of the 132 SMs, each block 11 stages of 4
//     dependent butterflies a thread. Design: a block holds 2^8 values (one
//     butterfly a thread a stage, 128 threads), and the 8 blocks of a tile
//     form a thread block cluster. The gather: the tile's 2^11 inputs lie
//     n / 2^11 apart, but the 2^8 that one block's positions need lie 8
//     times further apart, a 32-byte sector for every 4-byte limb; so each
//     block reads 2^8 of the tile's inputs in order, and after a cluster
//     barrier each block reads, through distributed shared memory, the
//     inputs of its own positions from the blocks that read them. Values
//     cross between blocks in value-major buffers, 32 bytes in two 16-byte
//     accesses. Pass A: each block
//     runs stages 0-7 in its shared memory, the stages' twiddles staged
//     there too. Pass B: after a cluster barrier each block reads the 8
//     values at each of its 32 positions mod 2^8 from the 8 blocks, runs
//     stages 8-10 on them in its own shared memory (each thread's three
//     twiddles loaded at the start, off the chain), and writes them out
//     (runs of 32 consecutive positions). So the two long transforms run
//     on 256 and 512 blocks. A transform of n <= 2^8 (the FK20 Toeplitz
//     transforms, n = 128) is one block and a cluster of one.
//     Shared memory is limb-major (word w of value i at w * 256 + i), so a
//     warp touching 32 neighbouring values hits 32 banks.
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
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace cg = cooperative_groups;

using namespace kzg;

namespace {

constexpr int MAX_LOG_TILE = 11;
constexpr int LOG_SUB = 8;  // B4: values a block holds
constexpr int SUB = 1 << LOG_SUB;
constexpr int TILE_SMEM_A = 4 * NLR * (SUB + SUB / 2);  // B4's shared memory: a block's transform
constexpr int TILE_SMEM_B = TILE_SMEM_A + 4 * 2 * NLR * SUB;  // and a cluster's block, with its exchange buffers
constexpr int THREADS = 256;  // B5

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

// value i of a value-major buffer (8 words a value, 16-byte aligned), in
// two 16-byte accesses: the form in which values cross between the blocks
// of a cluster
__device__ __forceinline__ Fr load_value(const uint32_t* base, int i) {
    const uint4* p = reinterpret_cast<const uint4*>(base + i * NLR);
    const uint4 a = p[0], b = p[1];
    return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store_value(uint32_t* base, int i, const Fr& v) {
    uint4* p = reinterpret_cast<uint4*>(base + i * NLR);
    p[0] = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
    p[1] = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
}

// in, out: (16, B, n) 16-bit limbs, total = B * n; tw: (8, n/2) words;
// scale: 8 words of 1/n in Montgomery form, or null for the forward
// transform. The tile of 2^log_tile positions is a cluster of 2^log_c blocks
// of 2^log_sub values, log_sub = min(log_tile, 8); block g holds flattened
// positions [g * 2^log_sub, (g + 1) * 2^log_sub) in pass A. 2^(log_sub - 1)
// threads a block: one butterfly a thread a stage.
__global__ void __launch_bounds__(SUB / 2) ntt_tile_kernel(
    const int32_t* __restrict__ in, int32_t* __restrict__ out, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ scale, int log_n, int log_tile, size_t total) {
    // dynamic shared memory, TILE_SMEM_A bytes for one block's transform
    // and TILE_SMEM_B for a cluster's block: va, pass A's values, and tws,
    // its twiddles w_{2^log_sub}^j (limb-major); then the value-major
    // exchange buffers xa, the inputs this block read (then, limb-major, vb:
    // pass B's values), and xb, pass A's results
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* va = smem;
    uint32_t* tws = va + NLR * SUB;
    uint32_t* xa = tws + NLR * SUB / 2;
    uint32_t* xb = xa + NLR * SUB;
    uint32_t* vb = xa;
    const int log_sub = log_tile < LOG_SUB ? log_tile : LOG_SUB;
    const int log_c = log_tile - log_sub;
    const int sub = 1 << log_sub, half = sub >> 1;
    const size_t half_n = (size_t)1 << (log_n - 1);
    const size_t g0 = (size_t)blockIdx.x << log_sub;
    const size_t row = g0 >> log_n << log_n;  // first element of this transform
    const unsigned p0 = (unsigned)(g0 - row);  // this block's offset inside it
    const int tid = threadIdx.x;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = log_c ? (int)cluster.block_rank() : 0;
    // pass B: block `rank` takes the positions j0 + jj (jj < 2^log_per) of
    // every block k of the cluster; value i = k 2^log_per + jj of vb sits at
    // tile position k 2^log_sub + j0 + jj. Thread tid runs pair tid of each
    // stage log_sub + s2, whose twiddles it loads now, off the chain.
    const int log_per = log_sub - log_c, per = 1 << log_per, j0 = rank << log_per;
    Fr twb[MAX_LOG_TILE - LOG_SUB];
#pragma unroll
    for (int s2 = 0; s2 < MAX_LOG_TILE - LOG_SUB; s2++) {
        if (s2 < log_c) {
            const int h = 1 << s2, kk = tid >> log_per;
            const int kl = ((kk >> s2) << (s2 + 1)) | (kk & (h - 1));
            // the pair's position mod 2^s, s = log_sub + s2
            const size_t pos = (size_t)(j0 + (tid & (per - 1))) + ((size_t)(kl & (h - 1)) << log_sub);
            twb[s2] = load_words(tw, half_n, pos << (log_n - log_sub - s2 - 1));
        }
    }

    // stage s < log_sub reads w_{2^(s+1)}^j = tws[j << (log_sub - 1 - s)]
    for (int k = tid; k < half; k += blockDim.x)
        store_words(tws, SUB / 2, k, load_words(tw, half_n, (size_t)k << (log_n - log_sub)));
    Fr sc;
    if (scale != nullptr) {
#pragma unroll
        for (int w = 0; w < NLR; w++) sc.v[w] = scale[w];
    }
    if (log_c == 0) {
        // one block, one transform of n <= 2^8 (or its tile): the
        // bit-reversal gather reads within 2^log_sub neighbouring values
        for (int i = tid; i < sub; i += blockDim.x) {
            const unsigned src = __brev(p0 + (unsigned)i) >> (32 - log_n);
            Fr v = load_fr16(in + row + src, total);
            if (scale != nullptr) v = rmul(v, sc);
            store_words(va, SUB, i, v);
        }
        __syncthreads();
    } else {
        // the cluster's tile reads inputs off + k stride (k < 2^log_tile):
        // block `rank` reads k in [rank 2^log_sub, (rank + 1) 2^log_sub) in
        // order into xa; position q of the tile takes input k = brev(q) from
        // block k >> log_sub
        const size_t tile0 = g0 - ((size_t)rank << log_sub);
        const unsigned t_idx = (unsigned)((tile0 - row) >> log_tile);
        const int log_stride = log_n - log_tile;
        const size_t off = log_stride ? __brev(t_idx) >> (32 - log_stride) : 0;
        for (int i = tid; i < sub; i += blockDim.x) {
            const size_t k = ((size_t)rank << log_sub) + i;
            Fr v = load_fr16(in + row + off + (k << log_stride), total);
            if (scale != nullptr) v = rmul(v, sc);
            store_value(xa, i, v);
        }
        cluster.sync();
        for (int i = tid; i < sub; i += blockDim.x) {
            const unsigned k = __brev(((unsigned)rank << log_sub) + i) >> (32 - log_tile);
            store_words(va, SUB, i, load_value(cluster.map_shared_rank(xa, k >> log_sub), k & (sub - 1)));
        }
        __syncthreads();
    }
    // pass A: the block is aligned to 2^log_sub, so a mod 2^s is j; stage
    // 0's twiddle is one
    for (int s = 0; s < log_sub; s++) {
        const int h = 1 << s;
        for (int k = tid; k < half; k += blockDim.x) {
            const int j = k & (h - 1);
            const int a = ((k >> s) << (s + 1)) | j;
            Fr x = load_words(va, SUB, a);
            Fr y = load_words(va, SUB, a + h);
            if (s > 0) y = rmul(y, load_words(tws, SUB / 2, j << (log_sub - 1 - s)));
            store_words(va, SUB, a, radd(x, y));
            store_words(va, SUB, a + h, rsub(x, y));
        }
        __syncthreads();
    }
    if (log_c == 0) {
        for (int i = tid; i < sub; i += blockDim.x) store_fr16(out + g0 + i, total, load_words(va, SUB, i));
        return;
    }
    for (int i = tid; i < sub; i += blockDim.x) store_value(xb, i, load_words(va, SUB, i));
    // every block has read the others' xa, so vb (xa's storage) may be written
    cluster.sync();
    for (int i = tid; i < sub; i += blockDim.x)
        store_words(vb, SUB, i, load_value(cluster.map_shared_rank(xb, (unsigned)(i >> log_per)), j0 + (i & (per - 1))));
    cluster.sync();  // every block has read the others' xb: each may go on, and exit
#pragma unroll
    for (int s2 = 0; s2 < MAX_LOG_TILE - LOG_SUB; s2++) {
        if (s2 < log_c) {
            const int h = 1 << s2, jj = tid & (per - 1), kk = tid >> log_per;
            const int il = ((((kk >> s2) << (s2 + 1)) | (kk & (h - 1))) << log_per) | jj;
            const int iu = il + (h << log_per);
            Fr x = load_words(vb, SUB, il);
            Fr y = rmul(load_words(vb, SUB, iu), twb[s2]);
            store_words(vb, SUB, il, radd(x, y));
            store_words(vb, SUB, iu, rsub(x, y));
            __syncthreads();
        }
    }
    const size_t tile0 = g0 - ((size_t)rank << log_sub);
    for (int i = tid; i < sub; i += blockDim.x)
        store_fr16(out + tile0 + ((size_t)(i >> log_per) << log_sub) + j0 + (i & (per - 1)), total,
                   load_words(vb, SUB, i));
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
    const int log_sub = log_tile < LOG_SUB ? log_tile : LOG_SUB;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(total >> log_sub));
    cfg.blockDim = dim3(1u << (log_sub - 1));
    cfg.dynamicSmemBytes = log_tile > log_sub ? TILE_SMEM_B : TILE_SMEM_A;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1u << (log_tile - log_sub);
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, ntt_tile_kernel, (const int32_t*)in, (int32_t*)out,
                                         (const uint32_t*)tw, (const uint32_t*)scale, log_n, log_tile, (size_t)total);
    if (err != cudaSuccess) return (int)err;
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
