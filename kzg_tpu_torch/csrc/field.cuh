// Fp and Fr arithmetic for BLS12-381 on 32-bit limbs (twelve for Fp, eight
// for Fr), for sm_90a.
//
// Shared header of the package's CUDA kernels. Values are little-endian
// 32-bit limbs in Montgomery form with R = 2^384 (Fp) and R = 2^256 (Fr),
// the same radices as the package's 16-bit-limb tensors (two 16-bit limbs
// make one 32-bit limb), so every fully reduced result here equals the
// plain PyTorch version limb for limb.
//
// The Montgomery product is CIOS: per 32-bit word b_i of one operand,
// t += a * b_i, then t += m * p with m = t_0 * (-p^-1) mod 2^32, then a
// one-word shift. Each "+= x * y" is two PTX carry chains (mad.lo.cc /
// madc.lo.cc over the low halves of the products, mad.hi.cc / madc.hi.cc
// over the high halves), each chain inside one asm statement so that the
// carry flag never has to survive between statements. With a, b < p every
// intermediate t stays below 2^416 (14 words) and the result below 2p;
// one conditional subtraction reduces it fully. The modulus words are
// immediate operands of the instructions that use them, not registers.
#pragma once
#include <cstdint>

namespace kzg {

constexpr int NL = 12;

struct Fp {
    uint32_t v[NL];
};

// p = 0x1a0111ea...ffffaaab appears as immediate operands in mac_lo_p,
// mac_hi_p, sub_p and add_p below, so a product holds no register for it.
// R mod p: the Montgomery form of one
__device__ __constant__ uint32_t ONE_MONT[NL] = {
    0x0002fffd, 0x76090000, 0xc40c0002, 0xebf4000b, 0x53c758ba, 0x5f489857,
    0x70525745, 0x77ce5853, 0xa256ec6d, 0x5c071a97, 0xfa80e493, 0x15f65ec3};
// -p^-1 mod 2^32
constexpr uint32_t P_INV = 0xfffcfffd;

// t[0..11] += lo(a[j] * b); the carry runs on into t[12], t[13]
__device__ __forceinline__ void mac_lo(uint32_t t[14], const uint32_t a[NL], uint32_t b) {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %14, %26, %0;\n\t"
        "madc.lo.cc.u32 %1, %15, %26, %1;\n\t"
        "madc.lo.cc.u32 %2, %16, %26, %2;\n\t"
        "madc.lo.cc.u32 %3, %17, %26, %3;\n\t"
        "madc.lo.cc.u32 %4, %18, %26, %4;\n\t"
        "madc.lo.cc.u32 %5, %19, %26, %5;\n\t"
        "madc.lo.cc.u32 %6, %20, %26, %6;\n\t"
        "madc.lo.cc.u32 %7, %21, %26, %7;\n\t"
        "madc.lo.cc.u32 %8, %22, %26, %8;\n\t"
        "madc.lo.cc.u32 %9, %23, %26, %9;\n\t"
        "madc.lo.cc.u32 %10, %24, %26, %10;\n\t"
        "madc.lo.cc.u32 %11, %25, %26, %11;\n\t"
        "addc.cc.u32 %12, %12, 0;\n\t"
        "addc.u32 %13, %13, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
}

// t[1..12] += hi(a[j] * b); the carry runs on into t[13]
__device__ __forceinline__ void mac_hi(uint32_t t[14], const uint32_t a[NL], uint32_t b) {
    asm("{\n\t"
        "mad.hi.cc.u32 %1, %14, %26, %1;\n\t"
        "madc.hi.cc.u32 %2, %15, %26, %2;\n\t"
        "madc.hi.cc.u32 %3, %16, %26, %3;\n\t"
        "madc.hi.cc.u32 %4, %17, %26, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %26, %5;\n\t"
        "madc.hi.cc.u32 %6, %19, %26, %6;\n\t"
        "madc.hi.cc.u32 %7, %20, %26, %7;\n\t"
        "madc.hi.cc.u32 %8, %21, %26, %8;\n\t"
        "madc.hi.cc.u32 %9, %22, %26, %9;\n\t"
        "madc.hi.cc.u32 %10, %23, %26, %10;\n\t"
        "madc.hi.cc.u32 %11, %24, %26, %11;\n\t"
        "madc.hi.cc.u32 %12, %25, %26, %12;\n\t"
        "addc.u32 %13, %13, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
}

// r = a + b over 12 words; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add_words(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
    uint32_t carry;
    asm("{\n\t"
        "add.cc.u32 %0, %13, %25;\n\t"
        "addc.cc.u32 %1, %14, %26;\n\t"
        "addc.cc.u32 %2, %15, %27;\n\t"
        "addc.cc.u32 %3, %16, %28;\n\t"
        "addc.cc.u32 %4, %17, %29;\n\t"
        "addc.cc.u32 %5, %18, %30;\n\t"
        "addc.cc.u32 %6, %19, %31;\n\t"
        "addc.cc.u32 %7, %20, %32;\n\t"
        "addc.cc.u32 %8, %21, %33;\n\t"
        "addc.cc.u32 %9, %22, %34;\n\t"
        "addc.cc.u32 %10, %23, %35;\n\t"
        "addc.cc.u32 %11, %24, %36;\n\t"
        "addc.u32 %12, 0, 0;"
        "\n\t}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(r[8]), "=r"(r[9]), "=r"(r[10]), "=r"(r[11]), "=r"(carry)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    return carry;
}

// r = a - b over 12 words; returns 0xffffffff on a borrow out, else 0
__device__ __forceinline__ uint32_t sub_words(uint32_t r[NL], const uint32_t a[NL], const uint32_t b[NL]) {
    uint32_t borrow;
    asm("{\n\t"
        "sub.cc.u32 %0, %13, %25;\n\t"
        "subc.cc.u32 %1, %14, %26;\n\t"
        "subc.cc.u32 %2, %15, %27;\n\t"
        "subc.cc.u32 %3, %16, %28;\n\t"
        "subc.cc.u32 %4, %17, %29;\n\t"
        "subc.cc.u32 %5, %18, %30;\n\t"
        "subc.cc.u32 %6, %19, %31;\n\t"
        "subc.cc.u32 %7, %20, %32;\n\t"
        "subc.cc.u32 %8, %21, %33;\n\t"
        "subc.cc.u32 %9, %22, %34;\n\t"
        "subc.cc.u32 %10, %23, %35;\n\t"
        "subc.cc.u32 %11, %24, %36;\n\t"
        "subc.u32 %12, 0, 0;"
        "\n\t}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(r[8]), "=r"(r[9]), "=r"(r[10]), "=r"(r[11]), "=r"(borrow)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    return borrow;
}

// t[0..11] += lo(p[j] * m), p as immediate operands; the carry runs on into
// t[12], t[13]
__device__ __forceinline__ void mac_lo_p(uint32_t t[14], uint32_t m) {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %14, 0xffffaaab, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, 0xb9feffff, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, 0xb153ffff, %2;\n\t"
        "madc.lo.cc.u32 %3, %14, 0x1eabfffe, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, 0xf6b0f624, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, 0x6730d2a0, %5;\n\t"
        "madc.lo.cc.u32 %6, %14, 0xf38512bf, %6;\n\t"
        "madc.lo.cc.u32 %7, %14, 0x64774b84, %7;\n\t"
        "madc.lo.cc.u32 %8, %14, 0x434bacd7, %8;\n\t"
        "madc.lo.cc.u32 %9, %14, 0x4b1ba7b6, %9;\n\t"
        "madc.lo.cc.u32 %10, %14, 0x397fe69a, %10;\n\t"
        "madc.lo.cc.u32 %11, %14, 0x1a0111ea, %11;\n\t"
        "addc.cc.u32 %12, %12, 0;\n\t"
        "addc.u32 %13, %13, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(m));
}

// t[1..12] += hi(p[j] * m), p as immediate operands; the carry runs on into t[13]
__device__ __forceinline__ void mac_hi_p(uint32_t t[14], uint32_t m) {
    asm("{\n\t"
        "mad.hi.cc.u32 %1, %14, 0xffffaaab, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, 0xb9feffff, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, 0xb153ffff, %3;\n\t"
        "madc.hi.cc.u32 %4, %14, 0x1eabfffe, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, 0xf6b0f624, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, 0x6730d2a0, %6;\n\t"
        "madc.hi.cc.u32 %7, %14, 0xf38512bf, %7;\n\t"
        "madc.hi.cc.u32 %8, %14, 0x64774b84, %8;\n\t"
        "madc.hi.cc.u32 %9, %14, 0x434bacd7, %9;\n\t"
        "madc.hi.cc.u32 %10, %14, 0x4b1ba7b6, %10;\n\t"
        "madc.hi.cc.u32 %11, %14, 0x397fe69a, %11;\n\t"
        "madc.hi.cc.u32 %12, %14, 0x1a0111ea, %12;\n\t"
        "addc.u32 %13, %13, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
        : "r"(m));
}

// r = a - p over 12 words; returns 0xffffffff on a borrow out, else 0
__device__ __forceinline__ uint32_t sub_p(uint32_t r[NL], const uint32_t a[NL]) {
    uint32_t borrow;
    asm("{\n\t"
        "sub.cc.u32 %0, %13, 0xffffaaab;\n\t"
        "subc.cc.u32 %1, %14, 0xb9feffff;\n\t"
        "subc.cc.u32 %2, %15, 0xb153ffff;\n\t"
        "subc.cc.u32 %3, %16, 0x1eabfffe;\n\t"
        "subc.cc.u32 %4, %17, 0xf6b0f624;\n\t"
        "subc.cc.u32 %5, %18, 0x6730d2a0;\n\t"
        "subc.cc.u32 %6, %19, 0xf38512bf;\n\t"
        "subc.cc.u32 %7, %20, 0x64774b84;\n\t"
        "subc.cc.u32 %8, %21, 0x434bacd7;\n\t"
        "subc.cc.u32 %9, %22, 0x4b1ba7b6;\n\t"
        "subc.cc.u32 %10, %23, 0x397fe69a;\n\t"
        "subc.cc.u32 %11, %24, 0x1a0111ea;\n\t"
        "subc.u32 %12, 0, 0;"
        "\n\t}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(r[8]), "=r"(r[9]), "=r"(r[10]), "=r"(r[11]), "=r"(borrow)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
    return borrow;
}

// r = a + p over 12 words, modulo 2^384
__device__ __forceinline__ void add_p(uint32_t r[NL], const uint32_t a[NL]) {
    asm("{\n\t"
        "add.cc.u32 %0, %12, 0xffffaaab;\n\t"
        "addc.cc.u32 %1, %13, 0xb9feffff;\n\t"
        "addc.cc.u32 %2, %14, 0xb153ffff;\n\t"
        "addc.cc.u32 %3, %15, 0x1eabfffe;\n\t"
        "addc.cc.u32 %4, %16, 0xf6b0f624;\n\t"
        "addc.cc.u32 %5, %17, 0x6730d2a0;\n\t"
        "addc.cc.u32 %6, %18, 0xf38512bf;\n\t"
        "addc.cc.u32 %7, %19, 0x64774b84;\n\t"
        "addc.cc.u32 %8, %20, 0x434bacd7;\n\t"
        "addc.cc.u32 %9, %21, 0x4b1ba7b6;\n\t"
        "addc.cc.u32 %10, %22, 0x397fe69a;\n\t"
        "addc.u32 %11, %23, 0x1a0111ea;"
        "\n\t}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(r[8]), "=r"(r[9]), "=r"(r[10]), "=r"(r[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]));
}

// mask ? a : b, limb by limb (mask is 0 or 0xffffffff)
__device__ __forceinline__ Fp fsel_mask(uint32_t mask, const Fp& a, const Fp& b) {
    Fp r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = (a.v[i] & mask) | (b.v[i] & ~mask);
    return r;
}

__device__ __forceinline__ Fp fsel(bool c, const Fp& a, const Fp& b) {
    return fsel_mask(0u - (uint32_t)c, a, b);
}

__device__ __forceinline__ bool fis_zero(const Fp& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) acc |= a.v[i];
    return acc == 0;
}

__device__ __forceinline__ Fp fzero() {
    Fp r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = 0;
    return r;
}

__device__ __forceinline__ Fp fone() {
    Fp r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = ONE_MONT[i];
    return r;
}

// (a + b) mod p for a, b < p
__device__ __forceinline__ Fp fadd(const Fp& a, const Fp& b) {
    Fp s, d;
    uint32_t carry = add_words(s.v, a.v, b.v);
    uint32_t borrow = sub_p(d.v, s.v);
    // keep s - p when a + b >= p: a carry out, or no borrow
    return fsel_mask((0u - carry) | ~borrow, d, s);
}

// (a - b) mod p for a, b < p
__device__ __forceinline__ Fp fsub(const Fp& a, const Fp& b) {
    Fp d, s;
    uint32_t borrow = sub_words(d.v, a.v, b.v);
    add_p(s.v, d.v);  // the carry out cancels the borrow
    return fsel_mask(borrow, s, d);
}

// a * b * 2^-384 mod p, fully reduced, for a, b < p (CIOS)
__device__ __forceinline__ Fp fmul(const Fp& a, const Fp& b) {
    uint32_t t[14];
#pragma unroll
    for (int i = 0; i < 14; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        mac_lo(t, a.v, b.v[i]);
        mac_hi(t, a.v, b.v[i]);
        uint32_t m = t[0] * P_INV;
        mac_lo_p(t, m);
        mac_hi_p(t, m);
        // t[0] is now 0: shift down one word
#pragma unroll
        for (int j = 0; j < 13; j++) t[j] = t[j + 1];
        t[13] = 0;
    }
    // t < 2p < 2^382: t[12] == 0
    Fp r, d;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = t[i];
    uint32_t borrow = sub_p(d.v, r.v);
    return fsel_mask(borrow, r, d);
}

// 24 16-bit limbs (strided int32 loads) <-> twelve 32-bit words
__device__ __forceinline__ Fp load_limbs16(const int32_t* src, size_t stride) {
    Fp r;
#pragma unroll
    for (int i = 0; i < NL; i++) {
        uint32_t lo = (uint32_t)src[(2 * i) * stride];
        uint32_t hi = (uint32_t)src[(2 * i + 1) * stride];
        r.v[i] = lo | (hi << 16);
    }
    return r;
}

__device__ __forceinline__ void store_limbs16(int32_t* dst, size_t stride, const Fp& a) {
#pragma unroll
    for (int i = 0; i < NL; i++) {
        dst[(2 * i) * stride] = (int32_t)(a.v[i] & 0xffffu);
        dst[(2 * i + 1) * stride] = (int32_t)(a.v[i] >> 16);
    }
}

// ---------------------------------------------------------------------------
// Fr: the scalar field, eight 32-bit limbs, R = 2^256. The same CIOS product
// and carry chains as Fp above, at eight words: with a, b < r < 2^255 every
// intermediate t stays below 2^289 (10 words) and the result below 2r.
// ---------------------------------------------------------------------------

constexpr int NLR = 8;

struct Fr {
    uint32_t v[NLR];
};

__device__ __constant__ uint32_t R_MOD_W[NLR] = {
    0x00000001, 0xffffffff, 0xfffe5bfe, 0x53bda402, 0x09a1d805, 0x3339d808, 0x299d7d48, 0x73eda753};
// -r^-1 mod 2^32
constexpr uint32_t R_INV = 0xffffffff;

// t[0..7] += lo(a[j] * b); the carry runs on into t[8], t[9]
__device__ __forceinline__ void mac_lo_r(uint32_t t[10], const uint32_t a[NLR], uint32_t b) {
    asm("{\n\t"
        "mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b));
}

// t[1..8] += hi(a[j] * b); the carry runs on into t[9]
__device__ __forceinline__ void mac_hi_r(uint32_t t[10], const uint32_t a[NLR], uint32_t b) {
    asm("{\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        "\n\t}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b));
}

// r = a + b over 8 words; returns the carry out (0 or 1)
__device__ __forceinline__ uint32_t add_words_r(uint32_t r[NLR], const uint32_t a[NLR], const uint32_t b[NLR]) {
    uint32_t carry;
    asm("{\n\t"
        "add.cc.u32 %0, %9, %17;\n\t"
        "addc.cc.u32 %1, %10, %18;\n\t"
        "addc.cc.u32 %2, %11, %19;\n\t"
        "addc.cc.u32 %3, %12, %20;\n\t"
        "addc.cc.u32 %4, %13, %21;\n\t"
        "addc.cc.u32 %5, %14, %22;\n\t"
        "addc.cc.u32 %6, %15, %23;\n\t"
        "addc.cc.u32 %7, %16, %24;\n\t"
        "addc.u32 %8, 0, 0;"
        "\n\t}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(carry)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    return carry;
}

// r = a - b over 8 words; returns 0xffffffff on a borrow out, else 0
__device__ __forceinline__ uint32_t sub_words_r(uint32_t r[NLR], const uint32_t a[NLR], const uint32_t b[NLR]) {
    uint32_t borrow;
    asm("{\n\t"
        "sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        "\n\t}"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(borrow)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
          "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    return borrow;
}

__device__ __forceinline__ void load_r(uint32_t r[NLR]) {
#pragma unroll
    for (int i = 0; i < NLR; i++) r[i] = R_MOD_W[i];
}

// mask ? a : b, limb by limb (mask is 0 or 0xffffffff)
__device__ __forceinline__ Fr rsel_mask(uint32_t mask, const Fr& a, const Fr& b) {
    Fr r;
#pragma unroll
    for (int i = 0; i < NLR; i++) r.v[i] = (a.v[i] & mask) | (b.v[i] & ~mask);
    return r;
}

// (a + b) mod r for a, b < r
__device__ __forceinline__ Fr radd(const Fr& a, const Fr& b) {
    uint32_t m[NLR];
    load_r(m);
    Fr s, d;
    uint32_t carry = add_words_r(s.v, a.v, b.v);
    uint32_t borrow = sub_words_r(d.v, s.v, m);
    return rsel_mask((0u - carry) | ~borrow, d, s);
}

// (a - b) mod r for a, b < r
__device__ __forceinline__ Fr rsub(const Fr& a, const Fr& b) {
    uint32_t m[NLR];
    load_r(m);
    Fr d, s;
    uint32_t borrow = sub_words_r(d.v, a.v, b.v);
    add_words_r(s.v, d.v, m);  // the carry out cancels the borrow
    return rsel_mask(borrow, s, d);
}

// a * b * 2^-256 mod r, fully reduced, for a, b < r (CIOS)
__device__ __forceinline__ Fr rmul(const Fr& a, const Fr& b) {
    uint32_t m[NLR];
    load_r(m);
    uint32_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < NLR; i++) {
        mac_lo_r(t, a.v, b.v[i]);
        mac_hi_r(t, a.v, b.v[i]);
        uint32_t q = t[0] * R_INV;
        mac_lo_r(t, m, q);
        mac_hi_r(t, m, q);
        // t[0] is now 0: shift down one word
#pragma unroll
        for (int j = 0; j < 9; j++) t[j] = t[j + 1];
        t[9] = 0;
    }
    // t < 2r < 2^256: t[8] == 0
    Fr r, d;
#pragma unroll
    for (int i = 0; i < NLR; i++) r.v[i] = t[i];
    uint32_t borrow = sub_words_r(d.v, r.v, m);
    return rsel_mask(borrow, r, d);
}

// 16 16-bit limbs (strided int32 loads) <-> eight 32-bit words
__device__ __forceinline__ Fr load_fr16(const int32_t* src, size_t stride) {
    Fr r;
#pragma unroll
    for (int i = 0; i < NLR; i++) {
        uint32_t lo = (uint32_t)src[(2 * i) * stride];
        uint32_t hi = (uint32_t)src[(2 * i + 1) * stride];
        r.v[i] = lo | (hi << 16);
    }
    return r;
}

__device__ __forceinline__ void store_fr16(int32_t* dst, size_t stride, const Fr& a) {
#pragma unroll
    for (int i = 0; i < NLR; i++) {
        dst[(2 * i) * stride] = (int32_t)(a.v[i] & 0xffffu);
        dst[(2 * i + 1) * stride] = (int32_t)(a.v[i] >> 16);
    }
}

}  // namespace kzg
