"""EIP-4844 blob commitments, proofs and their verification on a torch
device.

The counterpart of the JAX package's eip4844.py. Everything O(blob) runs
on the settings' device, batched over blobs: byte -> limb conversion with
the canonicality check, barycentric evaluation, the quotient, the
fixed-base MSM and the affine conversion; batch verification adds the
r-weighted lincombs as one variable-base MSM. The host does the SHA-256
Fiat-Shamir challenges, the 48-byte point codecs and the pairings (native
core). Batches run in chunks of BATCH_CHUNK blobs.

The batch entry points take an optional mesh (parallel/distributed.py)
with a "blobs" axis: every rank of the process group calls with the same
arguments, computes its share of the blobs (and of the verification's
lincomb points) on its own device, and gets back the whole answer.
"""

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import bytes as bs
from . import native
from .constants import (
    BYTES_PER_BLOB,
    FIAT_SHAMIR_PROTOCOL_DOMAIN,
    FIELD_ELEMENTS_PER_BLOB,
    G1_GENERATOR_X,
    G1_GENERATOR_Y,
    G2_GENERATOR_X_C0,
    G2_GENERATOR_X_C1,
    G2_GENERATOR_Y_C0,
    G2_GENERATOR_Y_C1,
    P_MOD,
    RANDOM_CHALLENGE_KZG_BATCH_DOMAIN,
    R_MOD as R,
)
from .ops import field as fl
from .ops import g1 as dg1
from .ops import msm as dmsm
from .ops.field import FR
from .parallel.distributed import all_gather, axis_size, gather_shards, shard
from .parallel.sharded_msm import msm_sharded
from .settings import TorchKZGSettings
from .tracing import span

BATCH_CHUNK = 64  # blobs per device pass (bounds the scan's working set)

G1_GENERATOR = (G1_GENERATOR_X, G1_GENERATOR_Y)
G2_GENERATOR = ((G2_GENERATOR_X_C0, G2_GENERATOR_X_C1), (G2_GENERATOR_Y_C0, G2_GENERATOR_Y_C1))


# ---------------------------------------------------------------------------
# Device bodies (batch dim B = number of blobs)
# ---------------------------------------------------------------------------


def _bytes_to_limbs(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blob bytes on the device -> limbs and canonicality (the counterpart
    of the JAX package's _words_to_limbs, which reads the same bytes as u32
    words). raw: (B, n, 32) uint8, each scalar 32 bytes big-endian; limb k
    = byte[30 - 2k] << 8 | byte[31 - 2k]. Returns ((16, B, n) canonical
    int32 limbs, (B, n) bool: value < r)."""
    r = raw.to(torch.int32)
    x = torch.stack([(r[..., 30 - 2 * k] << 8) | r[..., 31 - 2 * k] for k in range(FR.n_limbs)])
    lt = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
    eq = torch.ones_like(lt)
    for k in range(FR.n_limbs - 1, -1, -1):
        m = int(FR.mod_limbs[k])
        lt = lt | (eq & (x[k] < m))
        eq = eq & (x[k] == m)
    return x, lt


def _eval_barycentric_body(poly_m, z_m, roots_m):
    """Barycentric evaluation of blobs at points, all in Montgomery form.
    poly_m: (16, B, n) evaluations at the bit-reversed roots; z_m: (16, B,
    1); roots_m: (16, n). Returns (y_m (16, B, 1), inv_diff (16, B, n),
    was_zero (B, n)); the last two feed the quotient."""
    n = poly_m.shape[-1]
    rb = roots_m[:, None, :].expand(poly_m.shape)
    diff = fl.sub(FR, z_m.expand(poly_m.shape), rb)
    inv_diff, was_zero = fl.batch_inv_tree(FR, diff)
    # a zero difference (z in the domain) must contribute nothing below
    zeros = torch.zeros_like(inv_diff)
    inv_diff = torch.where(was_zero.unsqueeze(0), zeros, inv_diff)
    in_domain = was_zero.any(dim=-1)  # (B,)
    y_in = fl.sum_tree(FR, torch.where(was_zero.unsqueeze(0), poly_m, zeros))
    terms = fl.mont_mul(FR, fl.mont_mul(FR, poly_m, rb), inv_diff)
    ssum = fl.sum_tree(FR, terms)  # (16, B, 1)
    z_pow = z_m
    for _ in range(n.bit_length() - 1):
        z_pow = fl.mont_mul(FR, z_pow, z_pow)
    factor = fl.sub(FR, z_pow, fl.one_like(FR, z_pow))
    y_out = fl.mul_const(FR, fl.mont_mul(FR, ssum, factor), FR.const(pow(n, R - 2, R)))
    y = torch.where(in_domain[None, :, None], y_in, y_out)
    return y, inv_diff, was_zero


def _quotient_body(poly_m, y_m, z_m, inv_diff, was_zero, roots_m):
    """Quotient q_i = (p_i - y) / (w_i - z), with the in-domain slot m
    q_m = sum_{i != m} (p_i - y) w_i / (z (z - w_i)) selected branchlessly.
    Returns canonical limbs."""
    rb = roots_m[:, None, :].expand(poly_m.shape)
    p_minus_y = fl.sub(FR, poly_m, y_m.expand(poly_m.shape))
    q_std = fl.mont_mul(FR, fl.neg(FR, p_minus_y), inv_diff)
    zinv = fl.inv(FR, z_m)
    t = fl.mont_mul(FR, fl.mont_mul(FR, p_minus_y, rb), inv_diff)
    q_m = fl.mont_mul(FR, fl.sum_tree(FR, t), zinv)  # (16, B, 1)
    q = torch.where(was_zero.unsqueeze(0), q_m.expand(q_std.shape), q_std)
    return fl.to_canonical(FR, q)


@span("kzg.body.prove")
def _prove_body(poly_limbs, z_limbs, roots_m, table: dmsm.FixedBaseTable):
    """Canonical blob limbs (16, B, n) + canonical z limbs (16, B, 1) ->
    (proofs as affine points (B,), the evaluations y (16, B, 1) in
    Montgomery form)."""
    poly_m = fl.from_canonical(FR, poly_limbs)
    z_m = fl.from_canonical(FR, z_limbs)
    y_m, inv_diff, was_zero = _eval_barycentric_body(poly_m, z_m, roots_m)
    q = _quotient_body(poly_m, y_m, z_m, inv_diff, was_zero, roots_m)
    return dg1.to_affine(dmsm.msm_fixed(table, q)), y_m


def _require_canonical(ok: torch.Tensor, mesh=None) -> None:
    """Raise unless every scalar is canonical. On a mesh, unless every
    rank's blobs are: the ranks agree through one all_gather of their
    flags, so all of them raise together and none is left waiting in a
    collective."""
    flag = ok.all().to(torch.int32).reshape(1)
    if mesh is not None:
        flag = all_gather(flag, mesh, "blobs")
    if not bool(fl.to_host(flag.all())):
        raise ValueError("Invalid blob: scalar is not canonical")


@span("kzg.body.eval")
def _eval_body(raw: torch.Tensor, z_limbs: torch.Tensor, roots_m, mesh=None) -> torch.Tensor:
    """(B, n, 32) uint8 blob bytes + canonical z limbs (16, B, 1) ->
    canonical evaluations y (16, B, 1). Raises before the evaluation if a
    scalar is not canonical (on a mesh: any rank's)."""
    poly, ok = _bytes_to_limbs(raw)
    _require_canonical(ok, mesh)
    y_m, _, _ = _eval_barycentric_body(fl.from_canonical(FR, poly), fl.from_canonical(FR, z_limbs), roots_m)
    return fl.to_canonical(FR, y_m)


@span("kzg.body.lincomb")
def _lincomb_body(points: dg1.G1Aff, scalars: torch.Tensor) -> dg1.G1Aff:
    """The r-weighted lincombs of batch verification as one batch-2
    variable-base MSM over the same points (24, m): scalars (16, 2, m).
    Returns the two sums as affine points (2,)."""
    return dg1.to_affine(dmsm.msm(dg1.repeat_batch(points, 2), scalars))


@span("kzg.body.commit")
def _commit_body(raw: torch.Tensor, table: dmsm.FixedBaseTable, mesh=None) -> dg1.G1Aff:
    """(B, n, 32) uint8 blob bytes -> commitments as affine points (B,).
    Raises before any point work if a scalar is not canonical (on a mesh:
    any rank's)."""
    scalars, ok = _bytes_to_limbs(raw)
    _require_canonical(ok, mesh)
    return dg1.to_affine(dmsm.msm_fixed(table, scalars))


# ---------------------------------------------------------------------------
# The same bodies sharded over a mesh's "blobs" axis: every rank passes the
# full inputs, computes its block, and gets back the whole result
# ---------------------------------------------------------------------------


def _commit_sharded(raw: torch.Tensor, table: dmsm.FixedBaseTable, mesh) -> dg1.G1Aff:
    """Commitments with the blobs (B, n, 32) cut over the mesh's "blobs"
    axis, B a multiple of its size; the table on every rank. Returns the
    affine points (B,) on every rank."""
    aff = _commit_body(shard(raw, mesh, "blobs", 0), table, mesh)
    return dg1.G1Aff(*(gather_shards(t, mesh, "blobs", t.dim() - 1) for t in aff))


def _eval_sharded(raw: torch.Tensor, z_limbs: torch.Tensor, roots_m, mesh) -> torch.Tensor:
    """Evaluations with the blobs cut over the mesh's "blobs" axis: raw
    (B, n, 32), z (16, B, 1). Returns canonical y (16, B, 1) on every
    rank."""
    y = _eval_body(shard(raw, mesh, "blobs", 0), shard(z_limbs, mesh, "blobs", 1), roots_m, mesh)
    return gather_shards(y, mesh, "blobs", 1)


def _lincomb_sharded(points: dg1.G1Aff, scalars: torch.Tensor, mesh, c=None) -> dg1.G1Aff:
    """Variable-base MSMs over the same points, with the points cut over
    the mesh's "blobs" axis: points (24, k, m), scalars (16, k, m). The
    points are padded with the identity (scalar 0) to a multiple of the
    axis's size. Returns the k sums as affine points on every rank."""
    m = points.x.shape[-1]
    m += (-m) % axis_size(mesh, "blobs")
    points = dg1.G1Aff(fl._pad_last(points.x, m), fl._pad_last(points.y, m), fl._pad_last(points.inf, m, points.inf.new_ones(1)))
    scalars = fl._pad_last(scalars, m)
    return dg1.to_affine(msm_sharded(points, scalars, mesh, point_axis="blobs", c=c))


# ---------------------------------------------------------------------------
# Host glue
# ---------------------------------------------------------------------------


def _check_blob_length(b: bytes) -> None:
    if len(b) != BYTES_PER_BLOB:
        raise ValueError(
            f"Invalid blob: Invalid byte length. Expected {BYTES_PER_BLOB} got {len(b)}"
        )


def _affine_to_bytes(aff: dg1.G1Aff) -> List[bytes]:
    return native.g1_compress_batch(dg1.affine_to_ints(aff))


def hash_to_bls_field(b32: bytes) -> int:
    return int.from_bytes(b32, "big") % R


def compute_challenge(blob_bytes: bytes, commitment_bytes: bytes) -> int:
    """Fiat-Shamir challenge over the raw wire bytes."""
    h = hashlib.sha256()
    h.update(
        FIAT_SHAMIR_PROTOCOL_DOMAIN
        + (0).to_bytes(8, "big")
        + FIELD_ELEMENTS_PER_BLOB.to_bytes(8, "big")
    )
    h.update(blob_bytes)
    h.update(commitment_bytes)
    return hash_to_bls_field(h.digest())


def compute_powers(base: int, n: int) -> List[int]:
    """[1, base, base^2, ...] mod r, n of them."""
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * base % R
    return out


def _batch_challenge_r(commitments_b, zs, ys, proofs_b) -> int:
    """The Fiat-Shamir challenge r of batch verification, over the raw
    commitment and proof bytes and the 32-byte big-endian z and y."""
    n = len(commitments_b)
    data = bytearray()
    data += RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
    data += FIELD_ELEMENTS_PER_BLOB.to_bytes(8, "big")
    data += n.to_bytes(8, "big")
    for i in range(n):
        data += commitments_b[i]
        data += zs[i].to_bytes(32, "big")
        data += ys[i].to_bytes(32, "big")
        data += proofs_b[i]
    return hash_to_bls_field(hashlib.sha256(bytes(data)).digest())


def _blob_tensor(blobs: Sequence[bytes], device) -> torch.Tensor:
    """Blobs of checked length -> (B, 4096, 32) uint8 on `device`."""
    raw = np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(len(blobs), FIELD_ELEMENTS_PER_BLOB, 32)
    return fl.to_device(raw.copy(), device)


def _blob_axis(mesh) -> int:
    """The size of the mesh's "blobs" axis; 1 without a mesh."""
    return 1 if mesh is None else axis_size(mesh, "blobs")


def _padded(items: list, d: int, fill) -> list:
    """`items` padded with `fill` to a multiple of d."""
    return items + [fill] * ((-len(items)) % d)


# ---------------------------------------------------------------------------
# Public API (raw bytes, c-kzg-4844 semantics)
# ---------------------------------------------------------------------------


def blob_to_kzg_commitment_batch(blobs: Sequence[bytes], s: TorchKZGSettings, mesh=None) -> List[bytes]:
    """Commit to many blobs, one fixed-base MSM family per chunk of
    BATCH_CHUNK blobs. With a mesh, each chunk holds BATCH_CHUNK blobs a
    rank of the "blobs" axis, padded with blobs[0] to a multiple of the
    axis's size, and every rank returns every commitment."""
    blobs = list(blobs)
    for b in blobs:
        _check_blob_length(b)
    d = _blob_axis(mesh)
    table = s.lagrange_table
    out = []
    for lo in range(0, len(blobs), BATCH_CHUNK * d):
        chunk = blobs[lo : lo + BATCH_CHUNK * d]
        raw = _blob_tensor(_padded(chunk, d, blobs[0]), s.device)
        aff = _commit_body(raw, table) if mesh is None else _commit_sharded(raw, table, mesh)
        out.extend(_affine_to_bytes(aff)[: len(chunk)])
    return out


def blob_to_kzg_commitment(blob_bytes: bytes, s: TorchKZGSettings) -> bytes:
    _check_blob_length(blob_bytes)
    return blob_to_kzg_commitment_batch([blob_bytes], s)[0]


def compute_blob_kzg_proof_batch(
    blobs: Sequence[bytes], commitments: Sequence[bytes], s: TorchKZGSettings
) -> List[bytes]:
    """Blob proofs: challenges on the host, one device pass per chunk."""
    blobs = list(blobs)
    if any(len(c) != 48 for c in commitments):
        raise ValueError("Invalid commitment length")
    if len(commitments) != len(blobs):
        raise ValueError("blobs and commitments differ in number")
    native.g1_decompress_batch(b"".join(commitments))  # validate (raises)
    zs = [compute_challenge(b, c) for b, c in zip(blobs, commitments)]
    table = s.lagrange_table
    out = []
    for lo in range(0, len(blobs), BATCH_CHUNK):
        chunk = blobs[lo : lo + BATCH_CHUNK]
        poly = fl.to_device(bs.blobs_to_scalars(chunk), s.device)
        z = fl.to_device(fl.ints_to_limbs(zs[lo : lo + BATCH_CHUNK], FR.n_limbs)[:, :, None], s.device)
        out.extend(_affine_to_bytes(_prove_body(poly, z, s.roots_brp_mont, table)[0]))
    return out


def compute_blob_kzg_proof(
    blob_bytes: bytes, commitment_bytes: bytes, s: TorchKZGSettings
) -> bytes:
    if len(commitment_bytes) != 48:
        raise ValueError("Invalid commitment length")
    _check_blob_length(blob_bytes)
    return compute_blob_kzg_proof_batch([blob_bytes], [commitment_bytes], s)[0]


def _check_proof_single(s: TorchKZGSettings, commitment, proof, z: int, y: int) -> bool:
    """e(C - [y]_1, H) == e(proof, [s - z]_2), rearranged as
    e(C - [y]_1 + z proof, H) == e(proof, [s]_2) so that the variable
    scalar lands on the G1 side (the JAX package's _check_proof_single)."""
    y_g1 = native.g1_mul(G1_GENERATOR, y)
    neg_y = None if y_g1 is None else (y_g1[0], (P_MOD - y_g1[1]) % P_MOD)
    lhs = native.g1_add(native.g1_add(commitment, neg_y), native.g1_mul(proof, z))
    return native.pairings_verify(lhs, G2_GENERATOR, proof, s.g2_monomial[1])


def compute_kzg_proof(blob_bytes: bytes, z: bytes, s: TorchKZGSettings) -> Tuple[bytes, bytes]:
    """The proof of the blob's polynomial at z (32 bytes, big-endian), and
    y = p(z) (32 bytes, big-endian): the prove body at an arbitrary z."""
    _check_blob_length(blob_bytes)
    z_host = bs.fr_from_bytes(z)  # (16, 1); raises on length and canonicality
    poly = fl.to_device(bs.blobs_to_scalars([blob_bytes]), s.device)
    z_limbs = fl.to_device(z_host[:, :, None], s.device)
    aff, y_m = _prove_body(poly, z_limbs, s.roots_brp_mont, s.lagrange_table)
    y = fl.to_host(fl.to_canonical(FR, y_m)[:, :, 0]).numpy()
    return _affine_to_bytes(aff)[0], bs.frs_to_bytes(y)


def verify_kzg_proof(
    commitment_bytes: bytes, z: bytes, y: bytes, proof_bytes: bytes, s: TorchKZGSettings
) -> bool:
    """One opening (z and y 32 bytes each, big-endian), checked on the
    host: decompress, then one pairing."""
    if len(commitment_bytes) != 48 or len(proof_bytes) != 48:
        raise ValueError("Invalid commitment/proof length")
    if len(z) != 32 or len(y) != 32:
        raise ValueError("Invalid field element length")
    commitment, proof = native.g1_decompress_batch(commitment_bytes + proof_bytes)
    bs.fr_from_bytes(z)  # canonicality (raises)
    bs.fr_from_bytes(y)
    return _check_proof_single(s, commitment, proof, int.from_bytes(z, "big"), int.from_bytes(y, "big"))


def _lincomb_inputs(blobs, commitments_bytes, proofs_bytes, s: TorchKZGSettings, mesh=None):
    """The points [commitments | proofs | G] (24, 2n + 1) on the device and
    the scalars (16, 2, 2n + 1) of the two lincombs of batch verification:
    the challenges z_i, the evaluations y_i = p_i(z_i) on the device (one
    pass per chunk of BATCH_CHUNK blobs, a rank's with a mesh, the blobs
    padded with blobs[0] to a multiple of its "blobs" axis; raises if a
    blob scalar is not canonical), the points decompressed (raises on an
    invalid one), and the powers r_i of the batch challenge."""
    n = len(blobs)
    zs = [compute_challenge(b, c) for b, c in zip(blobs, commitments_bytes)]
    d = _blob_axis(mesh)
    ys = []
    for lo in range(0, n, BATCH_CHUNK * d):
        chunk = blobs[lo : lo + BATCH_CHUNK * d]
        raw = _blob_tensor(_padded(chunk, d, blobs[0]), s.device)
        z = fl.ints_to_limbs(_padded(zs[lo : lo + len(chunk)], d, zs[0]), FR.n_limbs)
        z = fl.to_device(z[:, :, None], s.device)
        y = _eval_body(raw, z, s.roots_brp_mont) if mesh is None else _eval_sharded(raw, z, s.roots_brp_mont, mesh)
        ys += fl.limbs_to_ints(y)[: len(chunk)]
    commitments = native.g1_decompress_batch(b"".join(commitments_bytes))
    proofs = native.g1_decompress_batch(b"".join(proofs_bytes))
    r_powers = compute_powers(_batch_challenge_r(commitments_bytes, zs, ys, proofs_bytes), n)
    rz = [r * z % R for r, z in zip(r_powers, zs)]
    ry = sum(r * y % R for r, y in zip(r_powers, ys)) % R
    scalars = np.stack(
        [
            fl.ints_to_limbs([0] * n + r_powers + [0], FR.n_limbs),
            fl.ints_to_limbs(r_powers + rz + [(R - ry) % R], FR.n_limbs),
        ],
        axis=1,
    )
    points = dg1.affine_from_ints(commitments + proofs + [G1_GENERATOR], s.device)
    return points, fl.to_device(scalars, s.device)


def verify_blob_kzg_proof_batch(
    blobs: Sequence[bytes],
    commitments_bytes: Sequence[bytes],
    proofs_bytes: Sequence[bytes],
    s: TorchKZGSettings,
    mesh=None,
) -> bool:
    """Batch verification of blob proofs. On the device: the evaluations
    y_i = p_i(z_i) (one pass per chunk of BATCH_CHUNK blobs), and the
    r-weighted lincombs as one batch-2 variable-base MSM over the 2n + 1
    points [commitments | proofs | G]:
        proof_lincomb = sum_i r_i P_i                  (scalars 0 | r_i | 0)
        rhs = sum_i r_i C_i + sum_i r_i z_i P_i - (sum_i r_i y_i) G
                                                       (r_i | r_i z_i | -sum)
    On the host: the challenges and one pairing check,
    e(proof_lincomb, [s]_2) == e(rhs, H).

    A mesh is used when the batch, padded to a power of two, divides over
    its "blobs" axis (as the JAX package decides): the evaluations and the
    lincomb's points are then cut over that axis, and every rank computes
    the challenge and the pairing check from the gathered values."""
    blobs, commitments_bytes, proofs_bytes = list(blobs), list(commitments_bytes), list(proofs_bytes)
    if not (len(blobs) == len(commitments_bytes) == len(proofs_bytes)):
        raise ValueError("Invalid amount of arguments")
    if not blobs:
        return True
    if any(len(c) != 48 for c in commitments_bytes) or any(len(p) != 48 for p in proofs_bytes):
        raise ValueError("Invalid commitment/proof length")
    for b in blobs:
        _check_blob_length(b)
    npad = 1 << (len(blobs) - 1).bit_length()
    if mesh is not None and npad % _blob_axis(mesh) == 0:
        points, scalars = _lincomb_inputs(blobs, commitments_bytes, proofs_bytes, s, mesh)
        lincombs = _lincomb_sharded(dg1.repeat_batch(points, 2), scalars, mesh)
    else:
        lincombs = _lincomb_body(*_lincomb_inputs(blobs, commitments_bytes, proofs_bytes, s))
    proof_lincomb, rhs = dg1.affine_to_ints(lincombs)
    return native.pairings_verify(proof_lincomb, s.g2_monomial[1], rhs, G2_GENERATOR)


def verify_blob_kzg_proof(
    blob_bytes: bytes, commitment_bytes: bytes, proof_bytes: bytes, s: TorchKZGSettings
) -> bool:
    return verify_blob_kzg_proof_batch([blob_bytes], [commitment_bytes], [proof_bytes], s)
