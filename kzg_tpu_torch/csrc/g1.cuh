// G1 point arithmetic on XYZZ coordinates for sm_90a, on top of field.cuh.
//
// The same formulas and the same selects of the edge cases (identity
// operands, P == Q, P == -Q) as the package's ops/g1.py: the addition
// (XYZZ + XYZZ, add-2008-s with the dbl-2008-s fallback) and the doubling
// (dbl-2008-s) for a block of warps, cooperatively; the mixed addition of
// kernel B1 (msm_kernels.cu) uses the same slot layout and accessors. Every
// field result is fully reduced, so the points equal the plain PyTorch
// version's limb for limb.
#pragma once
#include "field.cuh"

namespace kzg {

// ---------------------------------------------------------------------------
// Cooperative point arithmetic (kernels B2 and B3). A block of GROUP warps
// works on 32 points, one per lane: the group of threads of a point is its
// lane in each of the GROUP warps. The
// block's field values live in shared memory slots laid out [slot][word]
// [lane], so the 32 lanes of a warp read a value from 32 banks. The
// products of an operation fall into dependency rounds (the add without its
// doubling: 4, 4, 3, 3 products; the doubling: 2, 4, 3); in each round warp
// k computes products k, k + GROUP, ... of the round for all 32 points, and a
// block barrier ends the round. Which product a warp computes depends only on
// the warp and the round, so no warp diverges. The doubling fallback of the
// addition runs only in blocks where some point has P == Q.
//
// Products, linear steps and selects are those of ops/g1.py (add_unified_plain,
// dbl) on fully reduced values, so the results equal the plain version limb
// for limb whatever order the independent products run in.
// ---------------------------------------------------------------------------

// Threads per point (warps per block), chosen by measurement on the card
// among 2, 4 and 8 (PERF.md); ops/cuda_msm.py states the same GROUP.
constexpr int GROUP = 4;
constexpr int GPTS = 32;   // points per block: one per lane
constexpr int NSLOT = 18;  // field values per point held at once

struct Slots {
    uint32_t w[NSLOT][NL][GPTS];
    // flags of the last addition, one byte per point
    uint8_t pd0[GPTS], r0[GPTS], inf1[GPTS], inf2[GPTS];
};

// field value s of a block's point `lane`, in any slot struct with a
// w[slot][word][lane] array
template <class SlotsT>
__device__ __forceinline__ Fp sld(const SlotsT& S, int s, int lane) {
    Fp r;
#pragma unroll
    for (int i = 0; i < NL; i++) r.v[i] = S.w[s][i][lane];
    return r;
}

template <class SlotsT>
__device__ __forceinline__ void sst(SlotsT& S, int s, int lane, const Fp& a) {
#pragma unroll
    for (int i = 0; i < NL; i++) S.w[s][i][lane] = a.v[i];
}

// Slots of the addition P + Q. Inputs: P in 0-3, Q in 4-7. A later value
// takes the slot of one that no later product reads; the result before the
// identity selects ends in ADD_X .. ADD_ZZZ.
enum : int {
    X1 = 0, Y1, ZZ1, ZZZ1, X2, Y2, ZZ2, ZZZ2,
    U1 = 8, U2, S1, S2, PP, RR, ZZA, ZZZA, PPP, Q0,
    SPPP = U1, ADD_X = RR, ADD_Y = U2, ADD_Z = ZZA, ADD_ZZZ = ZZZA,
};

// Slots of one doubling: input point, output point (may be the input), temps
struct DblSlots {
    int x, y, zz, zzz, ox, oy, ozz, ozzz, v, xx, w, s, mm, y3a;  // wy reuses v
};

// One dependency round of the doubling (dbl-2008-s, as ops/g1.py:dbl):
//   round 0: v = u^2 (u = 2y), xx = x^2
//   round 1: w = u v, s = x v, mm = m^2 (m = 3 xx), zz3 = v zz
//   round 2: y3a = m (s - x3) (x3 = mm - 2 s), wy = w y, zzz3 = w zzz
// The output slots are written only where `keep` holds.
__device__ __forceinline__ void dbl_round(Slots& S, const DblSlots& d, int round, bool keep, int warp, int lane) {
    const int n = round == 1 ? 4 : round == 0 ? 2 : 3;
    for (int k = warp; k < n; k += GROUP) {
        Fp a, b;
        int dst;
        bool st = true;
        switch (round * 4 + k) {
            case 0: a = sld(S, d.y, lane); a = fadd(a, a); b = a; dst = d.v; break;
            case 1: a = sld(S, d.x, lane); b = a; dst = d.xx; break;
            case 4: a = sld(S, d.y, lane); a = fadd(a, a); b = sld(S, d.v, lane); dst = d.w; break;
            case 5: a = sld(S, d.x, lane); b = sld(S, d.v, lane); dst = d.s; break;
            case 6: {
                Fp xx = sld(S, d.xx, lane);
                a = fadd(fadd(xx, xx), xx);
                b = a;
                dst = d.mm;
                break;
            }
            case 7: a = sld(S, d.v, lane); b = sld(S, d.zz, lane); dst = d.ozz; st = keep; break;
            case 8: {
                Fp s = sld(S, d.s, lane);
                Fp x3 = fsub(sld(S, d.mm, lane), fadd(s, s));
                if (keep) sst(S, d.ox, lane, x3);
                Fp xx = sld(S, d.xx, lane);
                a = fadd(fadd(xx, xx), xx);
                b = fsub(s, x3);
                dst = d.y3a;
                break;
            }
            case 9: a = sld(S, d.w, lane); b = sld(S, d.y, lane); dst = d.v; break;
            default: a = sld(S, d.w, lane); b = sld(S, d.zzz, lane); dst = d.ozzz; st = keep; break;
        }
        Fp r = fmul(a, b);
        if (st) sst(S, dst, lane, r);
    }
}

// The doubling of the block's points (9 products in 3 rounds); returns with
// the block synchronized.
__device__ __forceinline__ void group_dbl(Slots& S, const DblSlots& d, bool keep, int warp, int lane) {
#pragma unroll 1
    for (int round = 0; round < 3; round++) {
        dbl_round(S, d, round, keep, warp, lane);
        __syncthreads();
    }
    if (warp == 0 && keep) sst(S, d.oy, lane, fsub(sld(S, d.y3a, lane), sld(S, d.v, lane)));
    __syncthreads();
}

// One dependency round of the addition without its doubling (add-2008-s, as
// ops/g1.py:add_unified_plain):
//   round 0: u1 = x1 zz2, u2 = x2 zz1, s1 = y1 zzz2, s2 = y2 zzz1
//   round 1: pp = pd^2 (pd = u2 - u1), rr = r^2 (r = s2 - s1), zza = zz1 zz2,
//            zzza = zzz1 zzz2; the flags pd == 0, r == 0, P and Q identity
//   round 2: ppp = pd pp, q0 = u1 pp, zz3 = zza pp
//   round 3: y3a = r (q0 - x3) (x3 = rr - ppp - 2 q0), sppp = s1 ppp,
//            zzz3 = zzza ppp
__device__ __forceinline__ void add_round(Slots& S, int round, int warp, int lane) {
    const int n = round < 2 ? 4 : 3;
    for (int k = warp; k < n; k += GROUP) {
        Fp a, b;
        int dst;
        switch (round * 4 + k) {
            case 0: a = sld(S, X1, lane); b = sld(S, ZZ2, lane); dst = U1; break;
            case 1: a = sld(S, X2, lane); b = sld(S, ZZ1, lane); dst = U2; break;
            case 2: a = sld(S, Y1, lane); b = sld(S, ZZZ2, lane); dst = S1; break;
            case 3: a = sld(S, Y2, lane); b = sld(S, ZZZ1, lane); dst = S2; break;
            case 4:
                a = fsub(sld(S, U2, lane), sld(S, U1, lane));
                b = a;
                S.pd0[lane] = fis_zero(a);
                dst = PP;
                break;
            case 5:
                a = fsub(sld(S, S2, lane), sld(S, S1, lane));
                b = a;
                S.r0[lane] = fis_zero(a);
                dst = RR;
                break;
            case 6:
                a = sld(S, ZZ1, lane);
                b = sld(S, ZZ2, lane);
                S.inf1[lane] = fis_zero(a);
                S.inf2[lane] = fis_zero(b);
                dst = ZZA;
                break;
            case 7: a = sld(S, ZZZ1, lane); b = sld(S, ZZZ2, lane); dst = ZZZA; break;
            case 8: a = fsub(sld(S, U2, lane), sld(S, U1, lane)); b = sld(S, PP, lane); dst = PPP; break;
            case 9: a = sld(S, U1, lane); b = sld(S, PP, lane); dst = Q0; break;
            case 10: a = sld(S, ZZA, lane); b = sld(S, PP, lane); dst = ADD_Z; break;
            case 12: {
                Fp q0 = sld(S, Q0, lane);
                Fp x3 = fsub(fsub(sld(S, RR, lane), sld(S, PPP, lane)), fadd(q0, q0));
                sst(S, ADD_X, lane, x3);
                a = fsub(sld(S, S2, lane), sld(S, S1, lane));
                b = fsub(q0, x3);
                dst = ADD_Y;
                break;
            }
            case 13: a = sld(S, S1, lane); b = sld(S, PPP, lane); dst = SPPP; break;
            default: a = sld(S, ZZZA, lane); b = sld(S, PPP, lane); dst = ADD_ZZZ; break;
        }
        sst(S, dst, lane, fmul(a, b));
    }
}

// P (slots 0-3) + Q (slots 4-7) for the block's points: the sum before the
// identity selects in ADD_X .. ADD_ZZZ (the doubling of P where P == Q), the
// flags in S; returns with the block synchronized. 14 products in 4 rounds,
// and 9 more in 3 rounds in a block where some point doubles.
__device__ __forceinline__ void group_add(Slots& S, int warp, int lane) {
#pragma unroll 1
    for (int round = 0; round < 4; round++) {
        add_round(S, round, warp, lane);
        __syncthreads();
    }
    if (warp == 0) sst(S, ADD_Y, lane, fsub(sld(S, ADD_Y, lane), sld(S, SPPP, lane)));
    const bool need_dbl = S.pd0[lane] && S.r0[lane] && !S.inf1[lane] && !S.inf2[lane];
    // the doubling of P, into the result slots of the points that take it,
    // on slots the addition has left free
    const DblSlots fallback = {X1, Y1, ZZ1, ZZZ1, ADD_X, ADD_Y, ADD_Z, ADD_ZZZ, U1, S1, S2, PP, PPP, Q0};
    if (__syncthreads_or(need_dbl)) group_dbl(S, fallback, need_dbl, warp, lane);
}

// coordinate k (0-3) of the sum after group_add, with the identity selects
__device__ __forceinline__ Fp add_result(const Slots& S, int k, int lane) {
    Fp r = sld(S, k == 0 ? ADD_X : k == 1 ? ADD_Y : ADD_Z + k - 2, lane);
    r = fsel(S.inf2[lane], sld(S, X1 + k, lane), r);
    return fsel(S.inf1[lane], sld(S, X2 + k, lane), r);
}

}  // namespace kzg
