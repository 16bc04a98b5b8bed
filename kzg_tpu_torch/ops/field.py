"""Batched prime-field arithmetic in PyTorch on 16-bit limbs.

Layout, as in the JAX package: a batch of field elements is a tensor of
shape (L, *batch), limbs on axis 0, little-endian, every limb < 2^16,
stored as int32 (so the values equal the JAX package's uint32 arrays). All
values are in Montgomery form with R = 2^(16 L): 2^256 for Fr, 2^384 for Fp.

Inside, the arithmetic widens to int64 (column sums to float64, where
integers below 2^53 are exact) and never relies on wrap-around: every
intermediate is non-negative before it is masked, and below 2^53.

The Montgomery product computes the schoolbook columns of a * b, then the
whole-number reduction q = (T mod R) * N' mod R, U = (T + q m) / R, and one
conditional subtraction. The two products by a constant (N' and m) are
float64 matrix products with a Toeplitz matrix of the constant's limbs.
Because the radix is the same, the fully reduced result equals the JAX
package's limb for limb, whatever limb size the product uses inside.
"""

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import List

import numpy as np
import torch

from .. import tracing
from . import launch
from ..constants import (
    FP_LIMBS,
    FP_N0_INV,
    FP_R2,
    FR_LIMBS,
    FR_N0_INV,
    FR_R2,
    LIMB_BITS,
    LIMB_MASK,
    P_MOD,
    R_MOD,
)

LIMB_DTYPE = torch.int32
_W = torch.int64


# ---------------------------------------------------------------------------
# Copies between the host and the device. PyTorch synchronizes the stream
# around a copy between pageable host memory and the card, so each is a
# point where the host waits for the card: the span kzg.wait.
# ---------------------------------------------------------------------------


@tracing.span(tracing.WAIT)
def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` (on the CPU, the array's own
    memory)."""
    return torch.from_numpy(a).to(device)


@tracing.span(tracing.WAIT)
def to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor's copy on the CPU (the tensor itself if it is there)."""
    return t.cpu()


def int_to_limbs(v: int, n_limbs: int) -> np.ndarray:
    """Python int -> little-endian 16-bit limb vector (int32)."""
    return np.array(
        [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)], dtype=np.int32
    )


def ints_to_limbs(vs, n_limbs: int) -> np.ndarray:
    """List of ints -> (L, B) int32 limb array."""
    out = np.empty((n_limbs, len(vs)), dtype=np.int32)
    for b, v in enumerate(vs):
        for i in range(n_limbs):
            out[i, b] = (v >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_ints(a) -> List[int]:
    """(L, *batch) limbs (tensor or array) -> flat list of python ints."""
    if isinstance(a, torch.Tensor):
        a = to_host(a.detach()).numpy()
    a = np.asarray(a).astype(np.uint64)
    flat = a.reshape(a.shape[0], -1)
    out = []
    for b in range(flat.shape[1]):
        v = 0
        for i in range(flat.shape[0] - 1, -1, -1):
            v = (v << LIMB_BITS) | int(flat[i, b])
        out.append(v)
    return out


@dataclass(frozen=True)
class FieldSpec:
    """A prime field in limb representation, plus Montgomery constants."""

    name: str
    modulus: int
    n_limbs: int
    r2: int
    n0_inv: int

    @cached_property
    def mod_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.n_limbs)

    @cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2, self.n_limbs)

    @cached_property
    def one_mont(self) -> np.ndarray:
        return int_to_limbs((1 << (LIMB_BITS * self.n_limbs)) % self.modulus, self.n_limbs)

    def const(self, v: int) -> np.ndarray:
        """Montgomery-form limb vector of a python int constant."""
        r = 1 << (LIMB_BITS * self.n_limbs)
        return int_to_limbs((v % self.modulus) * r % self.modulus, self.n_limbs)

    def encode_host(self, vs) -> np.ndarray:
        """Python ints -> Montgomery-form (L, B) int32 numpy limbs."""
        if isinstance(vs, int):
            vs = [vs]
        r = 1 << (LIMB_BITS * self.n_limbs)
        return ints_to_limbs([v % self.modulus * r % self.modulus for v in vs], self.n_limbs)

    def encode(self, vs, device) -> torch.Tensor:
        """Python ints -> Montgomery-form (L, B) limb tensor on `device`."""
        return to_device(self.encode_host(vs), device)

    @cached_property
    def r_inv(self) -> int:
        """R^-1 mod m."""
        return pow(1 << (LIMB_BITS * self.n_limbs), -1, self.modulus)

    def decode(self, a) -> List[int]:
        """Montgomery-form limbs -> python ints."""
        return [v * self.r_inv % self.modulus for v in limbs_to_ints(a)]


FR = FieldSpec("Fr", R_MOD, FR_LIMBS, FR_R2, FR_N0_INV)
FP = FieldSpec("Fp", P_MOD, FP_LIMBS, FP_R2, FP_N0_INV)
_SPECS = {"Fr": FR, "Fp": FP}


# ---------------------------------------------------------------------------
# Constants resident on each device (built once per device)
# ---------------------------------------------------------------------------

# The Montgomery product works on 16 wide limbs: 16-bit ones for Fr (R =
# 2^256) and 24-bit ones for Fp (R = 2^384). A 24-bit limb product is below
# 2^48 and a column of 16 of them below 2^52, inside int64 and exact in
# float64; Fp then needs 256 limb products where 16-bit limbs need 576.
_WIDE_BITS = {"Fr": 16, "Fp": 24}
_NW = 16


@lru_cache(maxsize=None)
def _limb_const(name: str, what: str, device: str) -> torch.Tensor:
    """(L, 1) int64 limbs of a constant, 16-bit ('mod', 'one', 'r2') or
    wide ('mod_wide')."""
    spec = _SPECS[name]
    if what == "mod_wide":
        wb = _WIDE_BITS[name]
        arr = [(spec.modulus >> (wb * k)) & ((1 << wb) - 1) for k in range(_NW)]
    else:
        arr = {"mod": spec.mod_limbs, "one": spec.one_mont, "r2": spec.r2_limbs}[what]
    return torch.tensor([int(v) for v in arr], dtype=_W, device=device).reshape(-1, 1)


@lru_cache(maxsize=None)
def _toeplitz(name: str, what: str, device: str) -> torch.Tensor:
    """float64 matrices of the two constant products of the reduction, on
    wide limbs: 'nprime' (16, 16), row k @ T_lo = column k of (T mod R) N';
    'mod' (32, 16), row k @ q = column k of q m."""
    spec = _SPECS[name]
    wb = _WIDE_BITS[name]
    rr = 1 << (wb * _NW)
    c = (-pow(spec.modulus, -1, rr)) % rr if what == "nprime" else spec.modulus
    limbs = [(c >> (wb * k)) & ((1 << wb) - 1) for k in range(_NW)]
    rows = _NW if what == "nprime" else 2 * _NW
    mat = np.zeros((rows, _NW), np.float64)
    for k in range(rows):
        for j in range(_NW):
            if 0 <= k - j < _NW:
                mat[k, j] = limbs[k - j]
    return torch.from_numpy(mat).to(device)


def _dev(t: torch.Tensor) -> str:
    return str(t.device)


def _broadcast(*shapes) -> tuple:
    """Broadcast shape (torch.broadcast_shapes is slow in Python, and most
    calls here have equal shapes)."""
    shapes = [tuple(sh) for sh in shapes]
    if all(sh == shapes[0] for sh in shapes):
        return shapes[0]
    n = max(len(sh) for sh in shapes)
    out = [1] * n
    for sh in shapes:
        for i, d in enumerate((1,) * (n - len(sh)) + sh):
            if d != 1 and out[i] not in (1, d):
                raise ValueError(f"shapes {shapes} do not broadcast")
            out[i] = d if d != 1 else out[i]
    return tuple(out)


def _bshape(a: torch.Tensor, b: torch.Tensor) -> tuple:
    return _broadcast(a.shape, b.shape)


# ---------------------------------------------------------------------------
# Carries and borrows on int64 limb tensors (limb axis 0)
#
# Two forms with equal results. A chain walks the limbs in order: a few small
# ops per limb, the least element work, the fastest on the CPU for wide
# batches. The lookahead form resolves all limbs at once with about twenty
# ops on whole (C, N) tensors: shift-and-add rounds leave only 0/1 carries,
# which then ripple as one integer addition of packed generate and
# propagate bit masks (one bit per limb; the carry-lookahead identity). It
# is used on the card, where it needs far fewer launches, and for narrow
# batches on the CPU, where it needs far fewer ops.
# ---------------------------------------------------------------------------

_CHAIN_MIN_LANES = 512


def _use_chain(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and x.shape[-1] > _CHAIN_MIN_LANES


def _carry_chain(cols: torch.Tensor, bits: int):
    mask = (1 << bits) - 1
    out = []
    carry = None
    for k in range(cols.shape[0]):
        t = cols[k] if carry is None else cols[k] + carry
        out.append(t & mask)
        carry = t >> bits
    return torch.stack(out), carry


def _borrow_chain(x: torch.Tensor, y: torch.Tensor, bits: int):
    base = 1 << bits
    out = []
    borrow = None
    for k in range(x.shape[0]):
        t = x[k] + (base - y[k])
        if borrow is not None:
            t = t - borrow
        out.append(t & (base - 1))
        borrow = 1 - (t >> bits)
    return torch.stack(out), borrow


@lru_cache(maxsize=None)
def _bit_weights(n: int, device: str):
    k = torch.arange(n, dtype=_W, device=device).reshape(n, 1)
    return torch.ones_like(k) << k, k


def _ripple(g: torch.Tensor, a: torch.Tensor):
    """0/1 carries through C limbs in one addition. g: limbs that generate a
    carry; a: limbs that generate or propagate one (0/1, (C, N)). Returns
    (carry into each limb (C, N), carry out (N,))."""
    C = g.shape[0]
    w, k = _bit_weights(C, _dev(g))
    G = (g * w).sum(0)
    A = (a * w).sum(0)
    S = A + G
    return ((S ^ A ^ G).unsqueeze(0) >> k) & 1, S >> C


def _carry_lookahead(x: torch.Tensor, bits: int, rounds: int):
    mask = (1 << bits) - 1
    top = torch.zeros_like(x[0])
    for _ in range(rounds):
        c = x >> bits
        x = x & mask
        x[1:] += c[:-1]
        top = top + c[-1]
    g = x >> bits  # every limb is now <= 2^bits
    cin, out = _ripple(g, g | (x == mask).to(_W))
    return (x + cin) & mask, top + out


def _normalize(cols: torch.Tensor, bits: int, rounds: int):
    """Non-negative lazy columns (C, N) -> (`bits`-bit limbs (C, N), carry
    out of the top (N,)). `rounds` shift-and-add passes must bring every
    column to at most 2^bits (three do below 2^53 for 24-bit limbs and
    below 2^37 for 16-bit ones; one does for a sum of two limbs)."""
    if _use_chain(cols):
        return _carry_chain(cols, bits)
    return _carry_lookahead(cols, bits, rounds)


def _sub_limbs(x: torch.Tensor, y: torch.Tensor, bits: int):
    """x - y over limbs (y (C, 1) or (C, N)), every intermediate
    non-negative. Returns ((x - y) mod 2^(bits C), borrow out (N,))."""
    if _use_chain(x):
        return _borrow_chain(x, y, bits)
    lt = (x < y).to(_W)
    bin_, bout = _ripple(lt, lt | (x == y).to(_W))
    return (x - y - bin_ + (1 << bits)) & ((1 << bits) - 1), bout


def _cond_sub(x: torch.Tensor, m: torch.Tensor, bits: int, extra=None) -> torch.Tensor:
    """x - m where x >= m (or `extra`, a carry beyond the top limb), else x."""
    d, borrow = _sub_limbs(x, m, bits)
    ge = borrow == 0
    if extra is not None:
        ge = ge | (extra != 0)
    return torch.where(ge.unsqueeze(0), d, x)


def _flat(a: torch.Tensor, shape) -> torch.Tensor:
    return a.to(_W).expand(shape).reshape(shape[0], -1)


def _to_wide(name: str, x: torch.Tensor) -> torch.Tensor:
    """(24, N) 16-bit limbs -> (16, N) 24-bit limbs for Fp (in the input's
    integer type: 24 bits fit int32); Fr unchanged."""
    if _WIDE_BITS[name] == 16:
        return x
    x3 = x.reshape(8, 3, -1)
    lo = x3[:, 0] | ((x3[:, 1] & 0xFF) << 16)
    hi = (x3[:, 1] >> 8) | (x3[:, 2] << 8)
    return torch.stack([lo, hi], dim=1).reshape(_NW, -1)


def _from_wide(name: str, x: torch.Tensor) -> torch.Tensor:
    if _WIDE_BITS[name] == 16:
        return x
    x2 = x.reshape(8, 2, -1)
    lo, hi = x2[:, 0], x2[:, 1]
    limbs = [lo & LIMB_MASK, (lo >> 16) | ((hi & 0xFF) << 8), hi >> 8]
    return torch.stack(limbs, dim=1).reshape(24, -1)


# ---------------------------------------------------------------------------
# Narrow batches on the CPU: Python integers. A torch op costs microseconds
# of dispatch whatever its width, and a Montgomery product is about a
# hundred of them; up to _INT_MAX_LANES lanes on the CPU (an MSM ladder's
# or window combination's handful) add, sub and mont_mul compute the same
# fully reduced values with Python's integers, limb for limb what the
# tensor code gives, some tens of times faster. On the card, and for wider
# batches, the tensor code runs.
# ---------------------------------------------------------------------------

_INT_MAX_LANES = 32


def _int_path(t: torch.Tensor, shape) -> bool:
    return t.device.type == "cpu" and int(np.prod(shape[1:])) <= _INT_MAX_LANES


def _to_pyints(a: torch.Tensor, shape) -> List[int]:
    """(L, *batch) limbs, broadcast to `shape` -> one int per lane."""
    L = shape[0]
    raw = a.expand(shape).reshape(L, -1).numpy().T.astype("<u2").tobytes()
    return [int.from_bytes(raw[2 * L * i : 2 * L * (i + 1)], "little") for i in range(len(raw) // (2 * L))]


def _from_pyints(vals: List[int], shape) -> torch.Tensor:
    L = shape[0]
    raw = b"".join(v.to_bytes(2 * L, "little") for v in vals)
    limbs = np.frombuffer(raw, dtype="<u2").reshape(len(vals), L).T.astype(np.int32)
    return torch.from_numpy(limbs).reshape(shape)


def _int_op(a, b, shape, fn) -> torch.Tensor:
    return _from_pyints([fn(x, y) for x, y in zip(_to_pyints(a, shape), _to_pyints(b, shape))], shape)


# ---------------------------------------------------------------------------
# Public ops on (L, *batch) int32 limb tensors
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a, b) -> torch.Tensor:
    shape = _bshape(a, b)
    if _int_path(a, shape):
        m = spec.modulus
        return _int_op(a, b, shape, lambda x, y: (x + y) % m)
    s, top = _normalize(_flat(a, shape) + _flat(b, shape), LIMB_BITS, 1)
    m = _limb_const(spec.name, "mod", _dev(s))
    return _cond_sub(s, m, LIMB_BITS, top).to(LIMB_DTYPE).reshape(shape)


def sub(spec: FieldSpec, a, b) -> torch.Tensor:
    shape = _bshape(a, b)
    if _int_path(a, shape):
        m = spec.modulus
        return _int_op(a, b, shape, lambda x, y: (x - y) % m)
    d, under = _sub_limbs(_flat(a, shape), _flat(b, shape), LIMB_BITS)
    m = _limb_const(spec.name, "mod", _dev(d))
    s, _ = _normalize(d + m * under, LIMB_BITS, 1)  # the carry out cancels the borrow
    return s.to(LIMB_DTYPE).reshape(shape)


def neg(spec: FieldSpec, a) -> torch.Tensor:
    """m - a, with 0 -> 0."""
    return sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a, b) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod m, fully reduced, over the
    broadcast batch. Inputs must be < m, or one of them < R with the other
    < m (as from_canonical uses it): then T + q m < 2 m R and one
    conditional subtraction reduces fully.

    The column sums are accumulated in float64, where they are exact
    integers (every column stays below 2^53) and the CPU has a native
    fused multiply-add; carries run on int64."""
    shape = _bshape(a, b)
    if _int_path(a, shape):
        m, rinv = spec.modulus, spec.r_inv
        return _int_op(a, b, shape, lambda x, y: x * y * rinv % m)
    name = spec.name
    bits = _WIDE_BITS[name]
    f64 = torch.float64
    aw = _to_wide(name, a.expand(shape).reshape(shape[0], -1)).to(f64)
    bw = _to_wide(name, b.expand(shape).reshape(shape[0], -1)).to(f64)
    dev = _dev(aw)
    cols = aw.new_zeros((2 * _NW, aw.shape[1]))
    for i in range(_NW):
        cols[i : i + _NW].addcmul_(aw[i], bw)  # each column < 2^52
    t_lo, _ = _normalize(cols[:_NW].to(_W), bits, 3)
    q_cols = _toeplitz(name, "nprime", dev) @ t_lo.to(f64)
    q, _ = _normalize(q_cols.to(_W), bits, 3)  # (T mod R) N' mod R
    # U = T + q m, column by column (< 2^53); divisible by R, below 2 m R
    u = torch.addmm(cols, _toeplitz(name, "mod", dev), q.to(f64)).to(_W)
    u, _ = _normalize(u, bits, 3)
    out = _cond_sub(u[_NW:], _limb_const(name, "mod_wide", dev), bits)
    return _from_wide(name, out).to(LIMB_DTYPE).reshape(shape)


def mul_many(spec: FieldSpec, pairs):
    """Many independent products with ONE mont_mul call, stacked along the
    last batch axis (all pairs broadcast to one batch shape)."""
    if len(pairs) == 1:
        return [mont_mul(spec, *pairs[0])]
    shape = _broadcast(*[t.shape for pair in pairs for t in pair])
    if _int_path(pairs[0][0], shape):  # narrow CPU batches: each product on Python ints
        return [mont_mul(spec, a, b) for a, b in pairs]
    if len(shape) == 1:  # no batch axis to stack along
        out = mul_many(spec, [(a.expand(shape)[:, None], b.expand(shape)[:, None]) for a, b in pairs])
        return [o[:, 0] for o in out]
    aa = torch.cat([a.expand(shape) for a, _ in pairs], dim=-1)
    bb = torch.cat([b.expand(shape) for _, b in pairs], dim=-1)
    out = mont_mul(spec, aa, bb)
    n = shape[-1]
    return [out[..., i * n : (i + 1) * n] for i in range(len(pairs))]


def mul_const(spec: FieldSpec, a, c_mont: np.ndarray) -> torch.Tensor:
    """Multiply a batch by one Montgomery-form constant."""
    c = to_device(np.asarray(c_mont, dtype=np.int32), a.device)
    return mont_mul(spec, a, c.reshape((spec.n_limbs,) + (1,) * (a.dim() - 1)))


def is_zero(spec: FieldSpec, a) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a, b) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask, a, b) -> torch.Tensor:
    """Elementwise mask ? a : b; mask has the batch shape."""
    return torch.where(mask.unsqueeze(0), a, b)


def one_like(spec: FieldSpec, a) -> torch.Tensor:
    """Montgomery one broadcast to the shape of a."""
    one = _limb_const(spec.name, "one", _dev(a)).to(LIMB_DTYPE)
    return one.reshape((spec.n_limbs,) + (1,) * (a.dim() - 1)).expand(a.shape)


def pow_fixed(spec: FieldSpec, a, exponent: int) -> torch.Tensor:
    """a^exponent for a host-known exponent (square and multiply on the
    exponent's bits; the bits are known on the host, so nothing branches on
    device data)."""
    acc = None
    base = a
    for i in range(max(1, exponent.bit_length())):
        if (exponent >> i) & 1:
            acc = base if acc is None else mont_mul(spec, acc, base)
        if i + 1 < exponent.bit_length():
            base = mont_mul(spec, base, base)
    return one_like(spec, a).clone() if acc is None else acc


def inv_exponent_words(spec: FieldSpec) -> np.ndarray:
    """m - 2 as little-endian 32-bit words (uint32): kernel B7's exponent."""
    e = spec.modulus - 2
    return np.array([(e >> (32 * k)) & 0xFFFFFFFF for k in range(spec.n_limbs // 2)], dtype=np.uint32)


@lru_cache(maxsize=None)
def _inv_exponent(name: str, device: str) -> torch.Tensor:
    return to_device(inv_exponent_words(_SPECS[name]).view(np.int32), device)


@launch.counted("field_inv")
@tracing.span("kzg.inv")
def inv(spec: FieldSpec, a) -> torch.Tensor:
    """Fermat inverse a^(m-2) of every lane of (L, *batch) limbs; maps 0 to
    0. Counted in the tracing registry as `field.inversions`.

    On the CPU the plain version, pow_fixed. For a CUDA tensor one launch
    of kernel B7 (csrc/field_kernels.cu), counted as `launch.field_inv`;
    broadcast or strided lanes are first copied to a contiguous (L, N).
    Nothing falls back."""
    tracing.count("field.inversions")
    dev = a.device
    if dev.type == "cpu":
        return pow_fixed(spec, a, spec.modulus - 2)
    launch.require_cuda(dev)
    L = spec.n_limbs
    if a.dim() == 0 or a.shape[0] != L:
        raise ValueError(f"a: shape {tuple(a.shape)}, expected ({L}, ...) limbs of {spec.name}")
    if a.dtype != LIMB_DTYPE:
        raise ValueError(f"a: dtype {a.dtype}, expected {LIMB_DTYPE}")
    x = a.reshape(L, -1).contiguous()
    N = x.shape[1]
    out = torch.empty_like(x)
    if N == 0:
        return out.reshape(a.shape)
    rc = launch.kernels().kzg_field_inv(
        x.data_ptr(), out.data_ptr(), _inv_exponent(spec.name, str(dev)).data_ptr(),
        (spec.modulus - 2).bit_length(), L, N, launch.stream(),
    )
    tracing.count("launch.field_inv")
    launch.check_launch(rc, "field_inv")
    return out.reshape(a.shape)


def _pad_last(a: torch.Tensor, m: int, fill: torch.Tensor = None) -> torch.Tensor:
    n = a.shape[-1]
    if m == n:
        return a
    if fill is None:
        pad = a.new_zeros(a.shape[:-1] + (m - n,))
    else:
        pad = fill.expand(a.shape[:-1] + (m - n,))
    return torch.cat([a, pad], dim=-1)


def sum_tree(spec: FieldSpec, a) -> torch.Tensor:
    """Sum along the last axis in log depth; returns (..., 1)."""
    n = a.shape[-1]
    m = 1 << max(0, n - 1).bit_length()
    a = _pad_last(a, m)
    while m > 1:
        h = m // 2
        a = add(spec, a[..., :h], a[..., h:])
        m = h
    return a


def reduce_sums(spec: FieldSpec, cols: torch.Tensor) -> torch.Tensor:
    """Limb-wise sums of values below m, (L, N) int64 with every column
    below 2^37 (up to 2^21 addends), -> their sum mod m as (L, N) limbs.
    Montgomery form carries through a sum, so Montgomery addends give the
    Montgomery form of their sum. The carried sum is lo + hi 2^(16 L) with
    lo < R = 2^(16 L) and hi small: lo mod m is the Montgomery product of lo
    with R mod m, and hi R mod m that of hi with R^2 mod m."""
    lo, hi = _normalize(cols, LIMB_BITS, 3)
    hi_limbs = torch.stack([(hi >> (LIMB_BITS * k)) & LIMB_MASK for k in range(spec.n_limbs)])
    lo_m = mul_const(spec, lo.to(LIMB_DTYPE), spec.one_mont)
    return add(spec, lo_m, from_canonical(spec, hi_limbs.to(LIMB_DTYPE)))


def to_canonical(spec: FieldSpec, a) -> torch.Tensor:
    """Montgomery form -> canonical limbs (a Montgomery product with 1)."""
    one_raw = np.zeros(spec.n_limbs, dtype=np.int32)
    one_raw[0] = 1
    c = to_device(one_raw, a.device)
    return mont_mul(spec, a, c.reshape((spec.n_limbs,) + (1,) * (a.dim() - 1)))


def from_canonical(spec: FieldSpec, a) -> torch.Tensor:
    """Canonical limbs (any value < R) -> Montgomery form."""
    return mul_const(spec, a, spec.r2_limbs)


def batch_inv_tree(spec: FieldSpec, a, zero_to_one: bool = False):
    """Batch inversion over the last axis in log depth: an up-sweep of
    pairwise products, one Fermat inversion at the root, a down-sweep that
    hands each child its inverse. Returns (inverses, was_zero); zeros are
    replaced by one before inversion."""
    was_zero = is_zero(spec, a)
    one = one_like(spec, a)
    safe = torch.where(was_zero.unsqueeze(0), one, a)
    n = a.shape[-1]
    m = 1 << max(0, n - 1).bit_length()
    safe = _pad_last(safe, m, one[..., :1])
    levels = [safe]
    cur = safe
    while cur.shape[-1] > 1:
        cur = mont_mul(spec, cur[..., 0::2], cur[..., 1::2])
        levels.append(cur)
    inv_cur = inv(spec, levels[-1])
    for k in range(len(levels) - 2, -1, -1):
        lvl = levels[k]
        left, right = lvl[..., 0::2], lvl[..., 1::2]
        inv_left, inv_right = mul_many(spec, [(inv_cur, right), (inv_cur, left)])
        inv_cur = torch.stack([inv_left, inv_right], dim=-1).reshape(lvl.shape)
    out = inv_cur[..., :n]
    if zero_to_one:
        out = torch.where(was_zero.unsqueeze(0), one, out)
    return out, was_zero
