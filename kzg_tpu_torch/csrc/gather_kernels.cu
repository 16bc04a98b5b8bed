// The row gather of the MSM's point table, for sm_90a, with a plain C
// launcher (bound with ctypes from kzg_tpu_torch/kernels.py; wrapper in
// kzg_tpu_torch/ops/cuda_gather.py).
//
// B6  gather_rows: replaces benches/gather_micro.py:182 (pdg, the pallas_dg
//     variant of the gather probe; kernel body :168-172). out[e, :] =
//     table[idx[e], :] for E int32 indices into a table of R rows of `width`
//     32-bit words (int32 bit patterns). The TPU kernel held one 4096-row
//     window slice in VMEM and gathered along the sublanes into a
//     (grid, 4096, 120) block, the 24 words of a row repeated five times to
//     fill 120 of the 128 lanes: that was the lane tile, not the function.
//     This kernel writes (E, width) rows in element order.
//     Bound on this card: bytes (each output word written once, each index
//     read once, the rows the indices touch read once; no arithmetic). The
//     probe's slice is 384 KB and the MSM's 163,840 x 100-byte rows are
//     16.4 MB, both inside the 50 MB L2, so the scattered row reads are L2
//     hits after the first touch and the writes set the time. A slice does
//     not fit in the 227 KB of shared memory a block may have, so nothing is
//     staged there.
//     Design: one block per 256 consecutive rows of the output; its threads
//     walk the block's words (or 16-byte chunks, where the width is a
//     multiple of four words and both tables are 16-byte aligned) in order,
//     so neighbouring threads store neighbouring addresses and every warp's
//     stores coalesce, at width 25 (100-byte rows, no alignment) as well as
//     at 24. A thread finds its row by a multiply-high with a reciprocal of
//     the chunk count computed once by the launcher, not by a division.
//     An index outside [0, R) reads nothing: its row is written as zeros and
//     the kernel sets flag[0] to 1, which the wrapper reads and raises on.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 256;
constexpr int MAX_CHUNKS = 4096;  // keeps the reciprocal exact: items per block * chunks < 2^32

template <typename T>
__device__ __forceinline__ T zero_item();
template <>
__device__ __forceinline__ uint32_t zero_item<uint32_t>() { return 0u; }
template <>
__device__ __forceinline__ uint4 zero_item<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }

// table: (n_rows, chunks) items of T; idx: (n_idx,); out: (n_idx, chunks).
// recip = ceil(2^32 / chunks): local / chunks == (local * recip) >> 32 for
// every local < ROWS_PER_BLOCK * chunks.
template <typename T>
__global__ void __launch_bounds__(THREADS) gather_rows_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ idx, T* __restrict__ out,
    int32_t* __restrict__ flag, long long n_rows, long long n_idx, int chunks, unsigned long long recip) {
    const long long row0 = (long long)blockIdx.x * ROWS_PER_BLOCK;
    const long long rows_here = n_idx - row0 < ROWS_PER_BLOCK ? n_idx - row0 : ROWS_PER_BLOCK;
    const unsigned items = (unsigned)rows_here * (unsigned)chunks;
    T* dst = out + (size_t)row0 * chunks;
    for (unsigned local = threadIdx.x; local < items; local += THREADS) {
        const unsigned e = (unsigned)(((unsigned long long)local * recip) >> 32);
        const unsigned k = local - e * (unsigned)chunks;
        const int32_t r = __ldg(idx + row0 + e);
        T v = zero_item<T>();
        if (r >= 0 && r < n_rows) {
            v = __ldg(table + (size_t)r * chunks + k);
        } else {
            *flag = 1;
        }
        dst[local] = v;
    }
}

}  // namespace

extern "C" int kzg_gather_rows(const void* table, const void* idx, void* out, void* flag, long long n_rows,
                               long long n_idx, int width, void* stream) {
    const bool vec = width % 4 == 0 && (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
    const int chunks = vec ? width / 4 : width;
    if (chunks < 1 || chunks > MAX_CHUNKS || n_idx < 1) return (int)cudaErrorInvalidValue;
    const unsigned long long recip = ((1ull << 32) + chunks - 1) / chunks;
    const long long grid = (n_idx + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
        gather_rows_kernel<uint4><<<(unsigned)grid, THREADS, 0, s>>>(
            (const uint4*)table, (const int32_t*)idx, (uint4*)out, (int32_t*)flag, n_rows, n_idx, chunks, recip);
    } else {
        gather_rows_kernel<uint32_t><<<(unsigned)grid, THREADS, 0, s>>>(
            (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, (int32_t*)flag, n_rows, n_idx, chunks,
            recip);
    }
    return (int)cudaGetLastError();
}
