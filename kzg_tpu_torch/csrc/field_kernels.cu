// The Fermat inversion of Fp and Fr values, for sm_90a, with a plain C
// launcher (bound with ctypes from kzg_tpu_torch/kernels.py; wrapper
// kzg_tpu_torch/ops/field.py inv).
//
// B7  field_inv: replaces no TPU kernel. The JAX package and the port's
//     plain version (ops/field.py pow_fixed) compute a^(m - 2) as a chain
//     of Montgomery products over whole tensors: on the card each product
//     is about 170 small PyTorch launches, so one Fp inversion (608
//     products) was 96,672 launches and one Fr inversion (417) 57,546,
//     while the lanes are few (one root per batch inversion, one a blob).
//     out[:, i] = a[:, i]^e for each lane i of an (L, N) int32 tensor of
//     16-bit limbs in Montgomery form: L = 24 is Fp (fmul), L = 16 is Fr
//     (rmul). The exponent e (m - 2) comes from the host as 32-bit words,
//     so neither modulus is written a second time here.
//     Bound: latency. Each lane is one chain of dependent products, (bits
//     - 1) squarings and (ones - 1) multiplications, each a chain of
//     dependent multiply-adds on the carry flag; the card's throughput is
//     idle at the lane counts the callers give (1 to a few thousand).
//     Design: one thread a lane, 128 threads a block; the whole
//     exponentiation stays in registers in one launch, left to right
//     over the exponent's bits (the accumulator starts at a for the top
//     bit, so no one is needed and 0 stays 0). Every thread reads the same
//     exponent bit, so the branch on it never diverges. A fixed window
//     would save a fifth of the products but index its table with a
//     runtime value, which puts the table in local memory.
//
// fmul and rmul reduce every product fully, so the result equals the plain
// version limb for limb.
#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) { return fmul(a, b); }
__device__ __forceinline__ Fr mul(const Fr& a, const Fr& b) { return rmul(a, b); }
__device__ __forceinline__ void load(const int32_t* src, size_t stride, Fp* r) { *r = load_limbs16(src, stride); }
__device__ __forceinline__ void load(const int32_t* src, size_t stride, Fr* r) { *r = load_fr16(src, stride); }
__device__ __forceinline__ void store(int32_t* dst, size_t stride, const Fp& a) { store_limbs16(dst, stride, a); }
__device__ __forceinline__ void store(int32_t* dst, size_t stride, const Fr& a) { store_fr16(dst, stride, a); }

// a: (L, n) int32 limbs; out: (L, n); e: the exponent's 32-bit words,
// little-endian, n_bits its bit length (>= 1)
template <typename F>
__global__ void __launch_bounds__(THREADS) field_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                                            const uint32_t* __restrict__ e, int n_bits, size_t n) {
    const size_t lane = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (lane >= n) return;
    F base;
    load(a + lane, n, &base);
    F acc = base;
    for (int i = n_bits - 2; i >= 0; i--) {
        acc = mul(acc, acc);
        if ((__ldg(e + (i >> 5)) >> (i & 31)) & 1u) acc = mul(acc, base);
    }
    store(out + lane, n, acc);
}

}  // namespace

extern "C" int kzg_field_inv(const void* a, void* out, const void* e, int n_bits, int n_limbs, long long n,
                             void* stream) {
    if (n < 1 || n_bits < 1 || n_bits > 16 * n_limbs) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (n_limbs == 2 * NL) {
        field_inv_kernel<Fp><<<grid, THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out, (const uint32_t*)e, n_bits,
                                                      (size_t)n);
    } else if (n_limbs == 2 * NLR) {
        field_inv_kernel<Fr><<<grid, THREADS, 0, s>>>((const int32_t*)a, (int32_t*)out, (const uint32_t*)e, n_bits,
                                                      (size_t)n);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
