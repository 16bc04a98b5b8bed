"""Multi-scalar multiplication in PyTorch: Pippenger as one sort and one
segmented scan. The counterpart of the JAX package's ops/msm.py, fixed-base
(`msm_fixed`) and variable-base (`msm`) paths.

  1. Scalars -> signed window digits.
  2. Bucket sums: sort the (batch, bucket) keys with the point row as
     payload, then a segmented scan of the sorted points. Phase 1 runs in
     chunk lanes, K sequential mixed additions each (kernel B1 on the
     card); phase 2 scans the chunk aggregates and phase 3 adds the carry
     into each chunk's first segment end (complete additions, kernel B2 on
     the card). Bucket b's sum is read at its last sorted element.
  3. Bucket integration sum_b b * S_b by a square split of the bucket axis.
  4. Window combination. Fixed base: none, the table holds 2^(c j) P_i for
     every window j (BGMW), so all windows share one bucket space. Variable
     base: every (batch, window) pair has its own buckets, and the window
     sums combine high to low by c doublings and one addition each (kernel
     B3 on the card).
Leading batch dims of the scalars are independent MSMs folded into the
sort key.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cuda_msm
from . import field as fl
from . import g1
from .field import FP, FR
from .g1 import G1Aff, G1XYZZ, map_coords

# Chunk lanes of phase 1. The JAX package aims at 2048 (one TPU vector tile
# set). On the card phase 1 runs one thread per lane, with the accumulator
# in registers; 32768 lanes are 256 blocks of 128 threads, about two blocks
# on each of the H100's 132 SMs. On the CPU the plain version does the
# same work either way, but phase 2 scans the lanes in m log m additions,
# so it keeps 2048. The sum does not depend on the choice.
CUDA_CHUNK_LANES = 32768
CPU_CHUNK_LANES = 2048


def default_window(n: int, fixed_base: bool) -> int:
    """Window-size heuristic of the JAX package: segmented-scan work is about
    2 n w + 2 * 2^(c-1) additions; minimise over c, avoiding c | 255."""
    best_c, best_cost = 4, float("inf")
    for c in range(4, 17):
        if 255 % c == 0:
            continue
        w = -(-255 // c)
        cost = 2 * n * w + 2 * (1 << (c - 1))
        if not fixed_base:
            cost += 255 + w
        if cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def num_windows(c: int) -> int:
    if 255 % c == 0:
        raise ValueError("255 % c == 0 would overflow the top signed digit")
    return -(-255 // c)


def signed_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical Fr limbs (16, *batch) -> signed window digits (w, *batch)
    int64 in [-2^(c-1), 2^(c-1)]: a digit above 2^(c-1) borrows from the
    next window; the top window absorbs the carry (255 % c != 0)."""
    w = num_windows(c)
    half = 1 << (c - 1)
    full = 1 << c
    s = scalars.to(torch.int64)
    digits = []
    for j in range(w):
        bit_lo = c * j
        limb = bit_lo // 16
        sh = bit_lo % 16
        raw = s[limb] >> sh
        have = 16 - sh
        k = 1
        while have < c and limb + k < s.shape[0]:
            raw = raw | (s[limb + k] << have)
            have += 16
            k += 1
        digits.append(raw & (full - 1))
    out = []
    carry = torch.zeros_like(digits[0])
    for j in range(w):
        d = digits[j] + carry
        wrap = d > half
        out.append(torch.where(wrap, d - full, d))
        carry = wrap.to(torch.int64)
    return torch.stack(out, dim=0)


def _pick_chunk(E: int, lanes: int) -> int:
    """Chunk length K so that the chunk-lane count E/K lands on `lanes`."""
    return max(1, -(-E // lanes))


def chunk_lanes(device: torch.device) -> int:
    return CUDA_CHUNK_LANES if device.type == "cuda" else CPU_CHUNK_LANES


def _seg_scan_hs(points: G1XYZZ, flags: torch.Tensor) -> G1XYZZ:
    """Inclusive segmented scan along the last axis, Hillis-Steele with
    rolls (n log n additions); flags mark segment starts."""
    n = flags.shape[-1]
    idx = torch.arange(n, device=flags.device)
    p, f = points, flags
    for d in range((n - 1).bit_length()):
        s = 1 << d
        rp = map_coords(lambda c: torch.roll(c, s, dims=-1), p)
        rf = torch.roll(f, s, dims=-1)
        valid = idx >= s
        p = g1.select_point(valid & ~f, g1.add_unified(rp, p), p)
        f = torch.where(valid, f | rf, f)
    return p


def _pack_point_rows(xs: torch.Tensor, ys: torch.Tensor, infs: torch.Tensor):
    """(24, ...) x/y limbs + (...) inf mask -> (2R, 25) int32 row table
    [packed x | packed y | inf], negated-y copies in the upper half (the
    digit sign picks the half, so the sort payload carries everything the
    scan needs). Packed word k = limb 2k | limb 2k+1 << 16, the k-th 32-bit
    limb, stored as its int32 bit pattern."""
    L = FP.n_limbs
    R = int(np.prod(xs.shape[1:]))

    def pack(a):  # (24, ...) -> (R, 12)
        a = a.reshape(L, R).to(torch.int64)
        w = a[0::2] | (a[1::2] << 16)  # < 2^32
        w = w - ((w >> 31) << 32)  # the same bits as a signed 32-bit value
        return w.to(torch.int32).T

    xr = pack(xs)
    infc = infs.reshape(R, 1).to(torch.int32)
    pos = torch.cat([xr, pack(ys), infc], dim=1)
    neg = torch.cat([xr, pack(fl.neg(FP, ys)), infc], dim=1)
    return torch.cat([pos, neg], dim=0).contiguous(), R


class ScanLayout(NamedTuple):
    """The chunked layout of the sorted elements that phase 1 scans."""

    idx: torch.Tensor  # (K, m) int32 source row of element (t, lane)
    first: torch.Tensor  # (K, m) bool segment starts
    fl2: torch.Tensor  # (m, K) segment starts, lane-major
    la2: torch.Tensor  # (m, K) segment ends, lane-major
    sorted_keys: torch.Tensor  # (E,)
    K: int
    m: int


def _scan_layout(flat_keys: torch.Tensor, aug_src: torch.Tensor) -> ScanLayout:
    """Sort the keys with the row index as payload and cut the sorted run
    into m chunk lanes of K elements. Element (t, lane) sits at column
    t * m + lane; its sorted rank is lane * K + t, so each lane scans a
    consecutive run of ranks."""
    sorted_keys, order = torch.sort(flat_keys, stable=True)
    return _chunk_layout(sorted_keys, aug_src[order])


def _chunk_layout(sorted_keys: torch.Tensor, src_sorted: torch.Tensor) -> ScanLayout:
    """The chunked layout of _scan_layout from the sorted keys and the row
    index in sorted order."""
    dev = sorted_keys.device
    E = sorted_keys.shape[0]
    diff = sorted_keys[1:] != sorted_keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, diff])
    last = torch.cat([diff, one])
    K = _pick_chunk(E, chunk_lanes(dev))
    m = -(-(-(-E // K)) // 128) * 128  # lanes, a whole number of 128-thread blocks
    pad = m * K - E
    if pad:
        # padded ranks sit at the tail; first=True isolates each in its own
        # segment, and no bucket key resolves to them
        src_sorted = torch.cat([src_sorted, src_sorted.new_zeros(pad)])
        first = torch.cat([first, first.new_ones(pad)])
        last = torch.cat([last, last.new_ones(pad)])
    fl2 = first.reshape(m, K)
    idx = src_sorted.reshape(m, K).T.contiguous().to(torch.int32)
    return ScanLayout(idx, fl2.T.contiguous(), fl2, last.reshape(m, K), sorted_keys, K, m)


def _bucket_sums_mem(rows_packed: torch.Tensor, lay: ScanLayout, n_keys: int) -> G1XYZZ:
    """Sums of the rows sharing a key, from the sorted layout. Returns
    (24, n_keys) XYZZ sums (identity for empty keys)."""
    dev = lay.idx.device
    L = FP.n_limbs
    K, m, fl2, la2, sorted_keys = lay.K, lay.m, lay.fl2, lay.la2, lay.sorted_keys
    E = sorted_keys.shape[0]
    pts = cuda_msm.seg_scan_phase1_mem(rows_packed, lay.idx, lay.first)  # (24, K, m)

    # phase 2: scan the chunk aggregates (the step K-1 plane) with chunk flags
    agg = map_coords(lambda c: c[:, K - 1, :], pts)
    scanned = _seg_scan_hs(agg, fl2.any(dim=-1))
    # exclusive carry into chunk i = inclusive scan at i - 1 (identity at 0)
    carry = map_coords(lambda c: torch.roll(c, 1, dims=-1), scanned)
    lane = torch.arange(m, device=dev)
    carry = g1.select_point(lane == 0, g1.infinity((m,), dev), carry)

    # phase 3: of a chunk's head piece (before its first segment start) only
    # the segment end is ever read, and there is at most one: correct it
    head = torch.cumsum(fl2.to(torch.int32), dim=-1) == 0
    hl = head & la2
    has = hl.any(dim=-1)
    pos = hl.to(torch.int8).argmax(dim=-1)  # first True (0 if none)
    gathered = map_coords(lambda c: c[:, pos, lane], pts)
    newv = g1.select_point(has, g1.add_unified(carry, gathered), gathered)
    for c, v in zip(pts, newv):
        c[:, pos, lane] = v

    # bucket extraction: each key's last sorted element, rank -> layout
    flat = map_coords(lambda c: c.reshape(L, m * K), pts)
    slots = torch.arange(n_keys, dtype=sorted_keys.dtype, device=dev)
    pos_r = torch.searchsorted(sorted_keys, slots, right=True) - 1
    pos_c = pos_r.clamp(0, E - 1)
    hit = (pos_r >= 0) & (sorted_keys[pos_c] == slots)
    f = (pos_c % K) * m + pos_c // K
    out = map_coords(lambda c: c[:, f], flat)
    return g1.select_point(hit, out, g1.infinity((n_keys,), dev))


def _weighted_index_sum(p: G1XYZZ) -> G1XYZZ:
    """sum_k k * p[..., k] over a small last axis by a suffix scan:
    sum_k k S_k = sum_{j>=1} sum_{k>=j} S_k. Returns (..., 1)."""
    tail = map_coords(lambda c: c[..., 1:], p)
    return g1.tree_reduce(g1.suffix_scan_add(tail))


def _dbl_n(p: G1XYZZ, n: int) -> G1XYZZ:
    for _ in range(n):
        p = g1.dbl(p)
    return p


def integrate_buckets(buckets: G1XYZZ) -> G1XYZZ:
    """sum_b b * buckets[..., b] over the last axis (index 0 has weight 0).
    With b = hi * G + lo (G about sqrt(B)): G * sum_hi hi A_hi +
    sum_lo lo B_lo, where A_hi and B_lo sum the rows and the columns of the
    (H, G) bucket square. Returns (..., 1)."""
    B = buckets.x.shape[-1]
    if B <= 32:
        return _weighted_index_sum(buckets)
    g_bits = (B - 1).bit_length() // 2
    G = 1 << g_bits
    H = -(-B // G)
    buckets = map_coords(lambda c: fl._pad_last(c, H * G), buckets)
    sq = map_coords(lambda c: c.reshape(c.shape[:-1] + (H, G)), buckets)
    a_hi = map_coords(lambda c: c[..., 0], g1.tree_reduce(sq))  # (..., H)
    b_lo = g1.tree_reduce(map_coords(lambda c: c.transpose(-1, -2), sq))
    b_lo = map_coords(lambda c: c[..., 0], b_lo)  # (..., G)
    wa = _dbl_n(map_coords(lambda c: c[..., 0], _weighted_index_sum(a_hi)), g_bits)
    wb = map_coords(lambda c: c[..., 0], _weighted_index_sum(b_lo))
    return map_coords(lambda c: c[..., None], g1.add_unified(wa, wb))


class FixedBaseTable(NamedTuple):
    """Window multiples 2^(c j) P_i. x/y: (24, w, *tb, n) int32; inf:
    (w, *tb, n). The table's own batch dims tb (none for one point set)
    hold distinct point sets, such as the 128 FK20 columns."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor
    c: int

    @property
    def n(self) -> int:
        return self.x.shape[-1]


def build_fixed_base_table(points: G1Aff, c: Optional[int] = None) -> FixedBaseTable:
    """Once per setup: w doubling chains over the batch, then one batch
    affine conversion. Runs on the points' device. Points (24, *tb, n)
    give a table with batch dims tb."""
    n = points.x.shape[-1]
    if c is None:
        c = default_window(n, fixed_base=True)
    w = num_windows(c)
    cur = g1.from_affine(points)
    rows = [cur]
    for _ in range(w - 1):
        cur = _dbl_n(cur, c)
        rows.append(cur)
    stacked = G1XYZZ(*(torch.stack([r[k] for r in rows], dim=1) for k in range(4)))
    aff = g1.to_affine(stacked)
    return FixedBaseTable(aff.x, aff.y, aff.inf, c)


def _fixed_keys(table: FixedBaseTable, scalars: torch.Tensor):
    """Digits, sort keys, packed rows and source rows of a fixed-base MSM.
    Returns (keys (E,), source rows (E,), rows_packed, n_keys, nb, batch)."""
    c = table.c
    w = num_windows(c)
    half = 1 << (c - 1)
    n = table.n
    if scalars.shape[0] != FR.n_limbs or scalars.shape[-1] != n:
        raise ValueError(f"scalars: shape {tuple(scalars.shape)}, expected (16, ..., {n})")
    dev = table.x.device
    batch = tuple(scalars.shape[1:-1])
    nb = int(np.prod(batch)) if batch else 1
    tb = tuple(table.x.shape[2:-1])  # the table's own batch dims
    if len(tb) > len(batch) or batch[len(batch) - len(tb):] != tb:
        raise ValueError(f"scalars' batch {batch} does not end in the table's batch dims {tb}")
    Tb = int(np.prod(tb)) if tb else 1

    digits = signed_digits(scalars, c).reshape(w, nb, n)
    sign = digits < 0
    bidx = torch.arange(nb, device=dev).reshape(1, nb, 1)
    keys = bidx * (half + 1) + digits.abs()  # windows share the bucket space
    E = nb * w * n

    # source row of element (j, b, i): batch b uses the table's point set
    # b mod Tb (its batch dims broadcast over the table's from the right)
    rows_packed, R0 = _pack_point_rows(table.x, table.y, table.inf)
    src_nat = (
        torch.arange(w, device=dev).reshape(w, 1, 1) * Tb
        + (torch.arange(nb, device=dev) % Tb).reshape(1, nb, 1)
    ) * n + torch.arange(n, device=dev).reshape(1, 1, n)
    aug = torch.where(sign, src_nat + R0, src_nat).reshape(E)
    return keys.reshape(E), aug, rows_packed, nb * (half + 1), nb, batch


def _fixed_inputs(table: FixedBaseTable, scalars: torch.Tensor):
    """Keys, packed rows and scan layout of a fixed-base MSM: the inputs of
    phase 1. Returns (rows_packed, layout, n_keys, nb, batch)."""
    keys, aug, rows_packed, n_keys, nb, batch = _fixed_keys(table, scalars)
    return rows_packed, _scan_layout(keys, aug), n_keys, nb, batch


def _fixed_result(sums: G1XYZZ, nb: int, batch: tuple) -> G1XYZZ:
    """Bucket integration of a fixed-base MSM's (24, nb (half + 1)) bucket
    sums: XYZZ sums of batch shape (*batch,)."""
    buckets = map_coords(lambda cc: cc.reshape(FP.n_limbs, nb, -1), sums)
    acc = map_coords(lambda cc: cc[..., 0], integrate_buckets(buckets))  # (24, nb)
    return map_coords(lambda cc: cc.reshape((FP.n_limbs,) + batch), acc)


def phase1_inputs(table: FixedBaseTable, scalars: torch.Tensor):
    """(rows, idx, first): the arguments the MSM passes to kernel B1."""
    rows_packed, lay, _, _, _ = _fixed_inputs(table, scalars)
    return rows_packed, lay.idx, lay.first


def msm_fixed(table: FixedBaseTable, scalars: torch.Tensor) -> G1XYZZ:
    """Fixed-base MSM: scalars are canonical Fr limbs (16, *batch, n) with
    n == table.n, on the table's device; batch dims are independent MSMs,
    over the same points, or, where the table has batch dims tb (the
    trailing batch dims must equal them), over the point set of their
    index in tb. Returns XYZZ sums of batch shape (*batch,)."""
    rows_packed, lay, n_keys, nb, batch = _fixed_inputs(table, scalars)
    return _fixed_result(_bucket_sums_mem(rows_packed, lay, n_keys), nb, batch)


# ---------------------------------------------------------------------------
# Variable-base MSM
# ---------------------------------------------------------------------------


def msm(points: G1Aff, scalars: torch.Tensor, c: Optional[int] = None) -> G1XYZZ:
    """Variable-base MSM. points: affine (24, *batch, n); scalars: canonical
    Fr limbs (16, *batch, n), on the points' device. Returns XYZZ sums of
    batch shape (*batch,). Below 8 points with no batch axis it takes the
    per-lane ladder, as the JAX package's msm does."""
    n = points.x.shape[-1]
    if n < 8 and points.x.dim() == 2:
        return map_coords(lambda cc: cc[..., 0], g1.msm_ladder(points, scalars))
    if c is None:
        c = default_window(n, fixed_base=False)
    return msm_core(points, scalars, c)


def _var_inputs(points: G1Aff, scalars: torch.Tensor, c: int):
    """Keys, packed rows and scan layout of a variable-base MSM: every
    (batch b, window j) pair owns the buckets (b w + j)(half + 1) + |digit|,
    and every element's row is its own point, b n + i, in the negated-y
    half for a negative digit. Returns (rows_packed, layout, n_keys, nb,
    w)."""
    n = points.x.shape[-1]
    if scalars.shape[0] != FR.n_limbs or tuple(scalars.shape[1:]) != tuple(points.x.shape[1:]):
        raise ValueError(f"scalars: shape {tuple(scalars.shape)}, expected (16, {tuple(points.x.shape[1:])})")
    dev = points.x.device
    batch = tuple(points.x.shape[1:-1])
    nb = int(np.prod(batch)) if batch else 1
    w = num_windows(c)
    half = 1 << (c - 1)

    digits = signed_digits(scalars, c).reshape(w, nb, n)
    seg = torch.arange(nb, device=dev).reshape(1, nb, 1) * w + torch.arange(w, device=dev).reshape(w, 1, 1)
    keys = seg * (half + 1) + digits.abs()
    E = w * nb * n

    L = FP.n_limbs
    rows_packed, R0 = _pack_point_rows(
        points.x.reshape(L, nb, n), points.y.reshape(L, nb, n), points.inf.reshape(nb, n)
    )
    src_nat = torch.arange(nb * n, device=dev).reshape(1, nb, n)
    aug = torch.where(digits < 0, src_nat + R0, src_nat).reshape(E)
    return rows_packed, _scan_layout(keys.reshape(E), aug), nb * w * (half + 1), nb, w


def window_sums(points: G1Aff, scalars: torch.Tensor, c: int) -> G1XYZZ:
    """The window sums W_j of each MSM: the bucket sums of every (batch,
    window) pair, integrated. Returns XYZZ (24, nb, w), the input of B3."""
    rows_packed, lay, n_keys, nb, w = _var_inputs(points, scalars, c)
    sums = _bucket_sums_mem(rows_packed, lay, n_keys)
    buckets = map_coords(lambda cc: cc.reshape(FP.n_limbs, nb, w, -1), sums)
    return map_coords(lambda cc: cc[..., 0].contiguous(), integrate_buckets(buckets))


def msm_core(points: G1Aff, scalars: torch.Tensor, c: int) -> G1XYZZ:
    """The variable-base MSM's bucket path at window c, whatever n: the
    window sums, then their combination through the B3 wrapper."""
    acc = cuda_msm.horner_windows(window_sums(points, scalars, c), c)  # (24, nb)
    return map_coords(lambda cc: cc.reshape((FP.n_limbs,) + tuple(points.x.shape[1:-1])), acc)
