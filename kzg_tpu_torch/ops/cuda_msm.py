"""Wrappers of the MSMs' three CUDA kernels, each beside its plain PyTorch
version. The counterpart of the JAX package's ops/pallas_msm.py.

  seg_scan_phase1_mem  kernel B1 (csrc/msm_kernels.cu), replaces
                       pallas_msm.py:_phase1_packed_call
  add_points           kernel B2 (csrc/msm_kernels.cu), replaces
                       pallas_msm.py:_add_call
  horner_windows       kernel B3 (csrc/msm_kernels.cu), replaces
                       pallas_msm.py:_horner_call
  integrate_buckets    kernel B9 (csrc/msm_kernels.cu), bucket integration
                       (no TPU kernel: the JAX package's is jnp code)

A wrapper runs its plain version (`*_ref`) for tensors on the CPU. For a
CUDA tensor it launches the kernel, or raises: nothing falls back. Each
wrapper checks device, dtype, shape and contiguity, and raises on anything
else. Each counts its launches in the tracing registry (tracing.py).
"""

from __future__ import annotations

import torch

from . import field as fl
from . import g1
from .. import tracing
from . import launch
from .field import FP

L = FP.n_limbs
ROW_WORDS = L + 1  # [12 packed x words | 12 packed y words | inf]

# Montgomery products per point operation, as ops/g1.py computes them (a
# CPU test counts them there), and the least number of dependency rounds
# they fall into.
MADD_FMULS = 17  # madd_unified, with its mdbl fallback
# Of those, the ones P != Q needs (madd-2008-s): u2 = x zz1, s2 = y zzz1,
# pp = pd^2, rr = r^2, ppp = pd pp, q0 = x1 pp, zz3 = zz1 pp,
# y3a = r (q0 - x3), sppp = y1 ppp, zzz3 = zzz1 ppp. The other 7 (v = u^2,
# xx = x^2, w = u v, s = x v, mm = m^2, m (s - x3d), w y) double the row,
# for P == Q only. Their chain u2 -> pp -> ppp -> y3a is 4 rounds deep.
MADD_FMULS_DISTINCT = 10
MDBL_FMULS = MADD_FMULS - MADD_FMULS_DISTINCT
ADD_FMULS = 23  # add_unified_plain, with its doubling fallback
ADD_FMULS_DISTINCT = 14  # of those, the ones P != Q needs: ADD_FMULS - DBL_FMULS
DBL_FMULS = 9  # dbl
# Addition: u1, u2, s1, s2 need only the inputs; pp = (u2 - u1)^2 needs
# u1, u2; ppp = pd pp needs pp; y3a = r (q0 - x3) needs q0 = u1 pp and
# x3 = rr - ppp - 2 q0. The longest chain u1 -> pp -> ppp -> y3a is 4 deep.
ADD_DEPTH = 4
# Doubling: v = u^2 and xx = x^2 need only the input; w = u v, s = x v and
# mm = (3 xx)^2 need them; y3a = m (s - x3) with x3 = mm - 2 s needs mm
# and s, and wy = w y needs w. The chains x -> xx -> mm -> y3a and
# y -> v -> w -> wy are 3 deep.
DBL_DEPTH = 3
# Threads per point in B2 and B3 (warps per block of 32 points): the
# kernels' compile-time GROUP in csrc/g1.cuh, chosen by measurement on the
# card among 2, 4 and 8 (PERF.md). A CPU test holds the two equal.
GROUP = 4
# Units of a block of B9, two of its 32 addition lanes each: the kernel's
# compile-time integ::UNITS in csrc/msm_kernels.cu. A CPU test holds the two
# equal.
INTEGRATE_UNITS = 16
# Blocks an SM runs at the pace of one, in B9's plan: a block keeps one
# product a round in flight on each of the SM's four schedulers, and a
# round (a product's dependent chain of multiply-adds and the block's
# barrier) is longer than the issue time of its products. Measured on the
# H100 (PERF.md): a round 3.2 us with one block an SM, 7.2 us with 4.4;
# at 2.5 the plan picks, at each of the MSMs' shapes, a grid within 6% of
# the fastest of the grids timed there.
SM_BLOCKS_AT_PACE = 2.5
# Warps per block of 32 chunk lanes in B1: the kernel's compile-time
# scan::GROUP in csrc/msm_kernels.cu, one per product of a round of the
# mixed addition (at most 3). A CPU test holds the two equal.
SCAN_GROUP = 3


# ---------------------------------------------------------------------------
# B1: phase 1 of the bucket segmented scan
# ---------------------------------------------------------------------------


def unpack_rows(g: torch.Tensor):
    """Packed rows (..., 25) int32 -> (x, y) as (24, ...) 16-bit limbs and
    inf (...) bool. Word k holds limbs 2k (low half) and 2k + 1."""
    w = g[..., : 2 * (L // 2)].to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1)  # (..., 24, 2)
    limbs = limbs.reshape(g.shape[:-1] + (2, L)).to(fl.LIMB_DTYPE)
    limbs = limbs.movedim(-1, 0)  # (24, ..., 2)
    return limbs[..., 0], limbs[..., 1], g[..., 2 * (L // 2)] != 0


def seg_scan_phase1_mem_ref(rows: torch.Tensor, idx: torch.Tensor, first: torch.Tensor) -> g1.G1XYZZ:
    """Plain version of B1: gather the rows, then K steps of madd_unified
    with a restart at segment starts (`first`) and at the chunk start."""
    K = idx.shape[0]
    x, y, inf = unpack_rows(rows[idx.long()])  # (24, K, m), (K, m)
    acc = None
    steps = []
    for t in range(K):
        cur = g1.G1Aff(x[:, t], y[:, t], inf[t])
        fresh = g1.from_affine(cur)
        if t == 0:
            acc = fresh
        else:
            acc = g1.select_point(first[t], fresh, g1.madd_unified(acc, cur))
        steps.append(acc)
    return g1.G1XYZZ(*(torch.stack([s[k] for s in steps], dim=1) for k in range(4)))


@launch.counted("seg_scan_phase1")
def seg_scan_phase1_mem(rows: torch.Tensor, idx: torch.Tensor, first: torch.Tensor) -> g1.G1XYZZ:
    """Within-chunk inclusive segmented scan. Lane j of the m chunk lanes
    scans the sorted elements j*K .. j*K + K - 1; element (t, j) sits at
    column t*m + j.

    rows: (R2, 25) int32 packed point rows (negated-y copies in the upper
    half); idx: (K, m) int32 row index of each element; first: (K, m) bool
    segment starts. Returns XYZZ coordinates, each (24, K, m) int32."""
    dev = rows.device
    K, m = idx.shape
    launch.check(rows, "rows", torch.int32, (rows.shape[0], ROW_WORDS), dev)
    launch.check(idx, "idx", torch.int32, (K, m), dev)
    launch.check(first, "first", torch.bool, (K, m), dev)
    if dev.type == "cpu":
        return seg_scan_phase1_mem_ref(rows, idx, first)
    launch.require_cuda(dev)
    out = [torch.empty((L, K, m), dtype=fl.LIMB_DTYPE, device=dev) for _ in range(4)]
    if K * m == 0:
        return g1.G1XYZZ(*out)
    rc = launch.kernels().kzg_seg_scan_phase1(
        rows.data_ptr(), idx.data_ptr(), first.data_ptr(), *(o.data_ptr() for o in out),
        K, m, launch.stream(),
    )
    tracing.count("launch.seg_scan_phase1")
    launch.check_launch(rc, "seg_scan_phase1")
    return g1.G1XYZZ(*out)


# ---------------------------------------------------------------------------
# B2: elementwise complete XYZZ addition
# ---------------------------------------------------------------------------


def add_points_ref(p: g1.G1XYZZ, q: g1.G1XYZZ) -> g1.G1XYZZ:
    """Plain version of B2."""
    return g1.add_unified_plain(p, q)


@launch.counted("add_unified")
def add_points(p: g1.G1XYZZ, q: g1.G1XYZZ) -> g1.G1XYZZ:
    """Complete XYZZ addition of two flat batches, each coordinate a
    contiguous (24, M) int32 tensor."""
    dev = p.x.device
    M = p.x.shape[-1]
    for name, c in zip(("px", "py", "pzz", "pzzz", "qx", "qy", "qzz", "qzzz"), (*p, *q)):
        launch.check(c, name, torch.int32, (L, M), dev)
    if dev.type == "cpu":
        return add_points_ref(p, q)
    launch.require_cuda(dev)
    out = [torch.empty((L, M), dtype=fl.LIMB_DTYPE, device=dev) for _ in range(4)]
    if M == 0:
        return g1.G1XYZZ(*out)
    rc = launch.kernels().kzg_add_unified(
        *(c.data_ptr() for c in (*p, *q)), *(o.data_ptr() for o in out), M, launch.stream()
    )
    tracing.count("launch.add_unified")
    launch.check_launch(rc, "add_unified")
    return g1.G1XYZZ(*out)


# ---------------------------------------------------------------------------
# B3: the variable-base MSM's window combination
# ---------------------------------------------------------------------------


def horner_windows_ref(win: g1.G1XYZZ, c: int) -> g1.G1XYZZ:
    """Plain version of B3, the JAX package's loop form: acc = W_{w-1};
    then for j = w-2 .. 0, acc = dbl^c(acc) + W_j."""
    w = win.x.shape[-1]
    acc = g1.map_coords(lambda t: t[..., w - 1], win)
    for j in range(w - 2, -1, -1):
        for _ in range(c):
            acc = g1.dbl(acc)
        acc = g1.add_unified_plain(acc, g1.map_coords(lambda t: t[..., j], win))
    return acc


@launch.counted("horner")
def horner_windows(win: g1.G1XYZZ, c: int) -> g1.G1XYZZ:
    """sum_j 2^(c j) W_j over the last axis. win: XYZZ window sums, each
    coordinate a contiguous (24, nb, w) int32 tensor (nb independent
    MSMs); c >= 1. Returns XYZZ (24, nb)."""
    dev = win.x.device
    if win.x.dim() != 3:
        raise ValueError(f"wx: shape {tuple(win.x.shape)}, expected (24, nb, w)")
    _, nb, w = win.x.shape
    for name, t in zip(("wx", "wy", "wzz", "wzzz"), win):
        launch.check(t, name, torch.int32, (L, nb, w), dev)
    if w < 1 or c < 1:
        raise ValueError(f"horner_windows: needs w >= 1 and c >= 1, got w={w}, c={c}")
    if dev.type == "cpu":
        return horner_windows_ref(win, c)
    launch.require_cuda(dev)
    out = [torch.empty((L, nb), dtype=fl.LIMB_DTYPE, device=dev) for _ in range(4)]
    if nb == 0:
        return g1.G1XYZZ(*out)
    rc = launch.kernels().kzg_horner(
        *(t.data_ptr() for t in win), *(o.data_ptr() for o in out), nb, w, c, launch.stream()
    )
    tracing.count("launch.horner")
    launch.check_launch(rc, "horner")
    return g1.G1XYZZ(*out)


# ---------------------------------------------------------------------------
# B9: bucket integration
# ---------------------------------------------------------------------------


def _weighted_index_sum(p: g1.G1XYZZ) -> g1.G1XYZZ:
    """sum_k k * p[..., k] over a small last axis by a suffix scan:
    sum_k k S_k = sum_{j>=1} sum_{k>=j} S_k. Returns (..., 1)."""
    tail = g1.map_coords(lambda c: c[..., 1:], p)
    return g1.tree_reduce(g1.suffix_scan_add(tail))


def integrate_buckets_ref(buckets: g1.G1XYZZ) -> g1.G1XYZZ:
    """Plain version of B9: sum_b b * buckets[..., b] over the last axis
    (index 0 has weight 0). With b = hi * G + lo (G about sqrt(B)): G *
    sum_hi hi A_hi + sum_lo lo B_lo, where A_hi and B_lo sum the rows and
    the columns of the (H, G) bucket square. Returns (..., 1)."""
    B = buckets.x.shape[-1]
    if B <= 32:
        return _weighted_index_sum(buckets)
    g_bits = (B - 1).bit_length() // 2
    G = 1 << g_bits
    H = -(-B // G)
    buckets = g1.map_coords(lambda c: fl._pad_last(c, H * G), buckets)
    sq = g1.map_coords(lambda c: c.reshape(c.shape[:-1] + (H, G)), buckets)
    a_hi = g1.map_coords(lambda c: c[..., 0], g1.tree_reduce(sq))  # (..., H)
    b_lo = g1.tree_reduce(g1.map_coords(lambda c: c.transpose(-1, -2), sq))
    b_lo = g1.map_coords(lambda c: c[..., 0], b_lo)  # (..., G)
    wa = g1.dbl_n(g1.map_coords(lambda c: c[..., 0], _weighted_index_sum(a_hi)), g_bits)
    wb = g1.map_coords(lambda c: c[..., 0], _weighted_index_sum(b_lo))
    return g1.map_coords(lambda c: c[..., None], g1.add_unified(wa, wb))


def integrate_rounds(cols: int, nbk: int, J: int):
    """Product rounds on the chain of one of B9's blocks (J steps, then the
    combination of its cols units), and of a row's last block after it
    where the row spans nbk > 1 blocks: (block, last)."""
    tau = cols.bit_length() - 1
    block = ADD_DEPTH * (J + (2 * tau + 1 if tau else 0))
    if nbk == 1:
        return block, 0
    tau2 = (nbk - 1).bit_length()
    return block, ADD_DEPTH * (2 * tau2 + 2) + DBL_DEPTH * (INTEGRATE_UNITS.bit_length() - 1)


def integrate_plan(rows: int, B: int, sms: int):
    """B9's grid for rows of B buckets on a card of `sms` SMs: (cols, nbk,
    J), a row's units cols in a block (a power of two) times nbk blocks (cols
    = INTEGRATE_UNITS where nbk > 1), each unit summing J buckets. Of the
    shapes that cover B, the one whose longer time is least: the rounds on
    its chain, or the rounds of all its blocks shared by the SMs, each
    running SM_BLOCKS_AT_PACE blocks at the pace of one; fewer blocks
    break a tie."""
    U = INTEGRATE_UNITS
    best = None
    for cols, nbk in [(1 << k, 1) for k in range(U.bit_length())] + [(U, n) for n in range(2, U + 1)]:
        J = -(-B // (cols * nbk))
        blocks = rows * nbk if nbk > 1 else -(-rows * cols // U)
        block, last = integrate_rounds(cols, nbk, J)
        key = (max(block + last, blocks * block / (sms * SM_BLOCKS_AT_PACE)), blocks)
        if best is None or key < best[0]:
            best = (key, (cols, nbk, J))
    return best[1]


_row_counts: dict = {}


def _counts(dev: torch.device, rows: int) -> torch.Tensor:
    """B9's arrivals a row (int32), zeroed when allocated; each launch
    leaves them at zero."""
    c = _row_counts.get(dev)
    if c is None or c.numel() < rows:
        c = torch.zeros(max(rows, 64), dtype=torch.int32, device=dev)
        _row_counts[dev] = c
    return c


@launch.counted("integrate")
def integrate_buckets(buckets: g1.G1XYZZ) -> g1.G1XYZZ:
    """sum_{b=1}^{B-1} b S_b of every row. buckets: XYZZ bucket sums, each
    coordinate a contiguous (24, rows, B) int32 tensor, B at least 1.
    Returns XYZZ (24, rows): the plain version's points, in other
    coordinates on the card."""
    dev = buckets.x.device
    if buckets.x.dim() != 3 or buckets.x.shape[2] < 1:
        raise ValueError(f"bx: shape {tuple(buckets.x.shape)}, expected (24, rows, B), B at least 1")
    _, rows, B = buckets.x.shape
    for name, t in zip(("bx", "by", "bzz", "bzzz"), buckets):
        launch.check(t, name, torch.int32, (L, rows, B), dev)
    if dev.type == "cpu":
        return g1.map_coords(lambda t: t[..., 0], integrate_buckets_ref(buckets))
    launch.require_cuda(dev)
    out = [torch.empty((L, rows), dtype=fl.LIMB_DTYPE, device=dev) for _ in range(4)]
    if rows == 0:
        return g1.G1XYZZ(*out)
    cols, nbk, J = integrate_plan(rows, B, torch.cuda.get_device_properties(dev).multi_processor_count)
    # a row over nbk > 1 blocks: its blocks' partial sums, and the count of
    # its blocks that have finished
    part = torch.empty(rows * nbk * 3 * 4 * (L // 2), dtype=torch.int32, device=dev) if nbk > 1 else None
    count = _counts(dev, rows) if nbk > 1 else None
    rc = launch.kernels().kzg_integrate(
        *(t.data_ptr() for t in buckets), *(o.data_ptr() for o in out), rows, B, cols, nbk, J,
        None if part is None else part.data_ptr(), None if count is None else count.data_ptr(), launch.stream(),
    )
    tracing.count("launch.integrate")
    launch.check_launch(rc, "integrate")
    return g1.G1XYZZ(*out)
