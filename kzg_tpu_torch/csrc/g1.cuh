// G1 point arithmetic on XYZZ coordinates for sm_90a, on top of field.cuh.
//
// The same formulas, in the same order, and the same branchless selects of
// the edge cases (identity operands, P == Q, P == -Q) as the package's
// ops/g1.py: dbl (dbl-2008-s), madd_unified (XYZZ + affine, madd-2008-s
// with the mdbl fallback) and add_unified (XYZZ + XYZZ, add-2008-s with
// the dbl-2008-s fallback). Every field result is fully reduced, so the
// points equal the plain PyTorch version's limb for limb.
#pragma once
#include "field.cuh"

namespace kzg {

struct Xyzz {
    Fp x, y, zz, zzz;
};

struct Aff {
    Fp x, y;
    bool inf;
};

__device__ __forceinline__ Xyzz psel(bool c, const Xyzz& a, const Xyzz& b) {
    return {fsel(c, a.x, b.x), fsel(c, a.y, b.y), fsel(c, a.zz, b.zz), fsel(c, a.zzz, b.zzz)};
}

__device__ __forceinline__ Xyzz from_affine(const Aff& a) {
    Fp zz = fsel(a.inf, fzero(), fone());
    return {a.x, a.y, zz, zz};
}

// XYZZ doubling (dbl-2008-s, a = 0): 9 products, in the order of
// ops/g1.py:dbl. The identity doubles to the identity (zz3 = V * zz = 0).
__device__ __forceinline__ Xyzz dbl(const Xyzz& p) {
    Fp u = fadd(p.y, p.y);
    Fp v = fmul(u, u);
    Fp xx = fmul(p.x, p.x);
    Fp w = fmul(u, v);
    Fp s = fmul(p.x, v);
    Fp m = fadd(fadd(xx, xx), xx);
    Fp mm = fmul(m, m);
    Fp wy = fmul(w, p.y);
    Fp zz3 = fmul(v, p.zz);
    Fp zzz3 = fmul(w, p.zzz);
    Fp x3 = fsub(mm, fadd(s, s));
    Fp y3a = fmul(m, fsub(s, x3));
    return {x3, fsub(y3a, wy), zz3, zzz3};
}

__device__ __forceinline__ Xyzz madd_unified(const Xyzz& p, const Aff& a) {
    Fp U = fadd(a.y, a.y);
    Fp u2 = fmul(a.x, p.zz);
    Fp s2 = fmul(a.y, p.zzz);
    Fp V = fmul(U, U);
    Fp xx = fmul(a.x, a.x);
    Fp pd = fsub(u2, p.x);
    Fp r = fsub(s2, p.y);

    bool inf1 = fis_zero(p.zz);
    bool inf2 = a.inf;
    bool need_dbl = !inf1 && !inf2 && fis_zero(pd) && fis_zero(r);

    Fp pp = fmul(pd, pd);
    Fp W = fmul(U, V);
    Fp Sd = fmul(a.x, V);
    Fp M = fadd(fadd(xx, xx), xx);
    Fp ppp = fmul(pd, pp);
    Fp q0 = fmul(p.x, pp);
    Fp rr = fmul(r, r);
    Fp MM = fmul(M, M);
    Fp x3 = fsub(fsub(rr, ppp), fadd(q0, q0));
    Fp x3d = fsub(MM, fadd(Sd, Sd));
    Fp y3a = fmul(r, fsub(q0, x3));
    Fp sppp = fmul(p.y, ppp);
    Fp zz3 = fmul(p.zz, pp);
    Fp zzz3 = fmul(p.zzz, ppp);
    Fp msd = fmul(M, fsub(Sd, x3d));
    Fp wy = fmul(W, a.y);

    Xyzz res = {x3, fsub(y3a, sppp), zz3, zzz3};
    Xyzz dres = {x3d, fsub(msd, wy), V, W};
    res = psel(need_dbl, dres, res);
    res = psel(inf2, p, res);
    return psel(inf1, from_affine(a), res);
}

__device__ __forceinline__ Xyzz add_unified(const Xyzz& p, const Xyzz& q) {
    // round 1 (the last two products start the doubling of p)
    Fp u = fadd(p.y, p.y);
    Fp u1 = fmul(p.x, q.zz);
    Fp u2 = fmul(q.x, p.zz);
    Fp s1 = fmul(p.y, q.zzz);
    Fp s2 = fmul(q.y, p.zzz);
    Fp v = fmul(u, u);
    Fp xx = fmul(p.x, p.x);
    Fp pd = fsub(u2, u1);
    Fp r = fsub(s2, s1);

    bool inf1 = fis_zero(p.zz);
    bool inf2 = fis_zero(q.zz);
    bool need_dbl = !inf1 && !inf2 && fis_zero(pd) && fis_zero(r);

    // round 2
    Fp pp = fmul(pd, pd);
    Fp w = fmul(u, v);
    Fp s = fmul(p.x, v);
    Fp m = fadd(fadd(xx, xx), xx);
    // round 3
    Fp ppp = fmul(pd, pp);
    Fp q0 = fmul(u1, pp);
    Fp zza = fmul(p.zz, q.zz);
    Fp zzza = fmul(p.zzz, q.zzz);
    Fp rr = fmul(r, r);
    Fp mm = fmul(m, m);
    Fp wy = fmul(w, p.y);
    Fp zz3d = fmul(v, p.zz);
    Fp zzz3d = fmul(w, p.zzz);
    Fp x3 = fsub(fsub(rr, ppp), fadd(q0, q0));
    Fp x3d = fsub(mm, fadd(s, s));
    // round 4
    Fp y3a = fmul(r, fsub(q0, x3));
    Fp sppp = fmul(s1, ppp);
    Fp zz3 = fmul(zza, pp);
    Fp zzz3 = fmul(zzza, ppp);
    Fp y3da = fmul(m, fsub(s, x3d));

    Xyzz res = {x3, fsub(y3a, sppp), zz3, zzz3};
    Xyzz dres = {x3d, fsub(y3da, wy), zz3d, zzz3d};
    res = psel(need_dbl, dres, res);
    res = psel(inf2, p, res);
    return psel(inf1, q, res);
}

}  // namespace kzg
