"""KZG settings on a torch device: the fixed-base MSM tables of the
bit-reversed Lagrange setup, of the monomial setup and of its first 64
points, the FK20 column points and tables, and the legacy FK20 settings'
files at any (n2, chunk_len) (each built on the device, cached on disk);
the bit-reversed roots of unity, the cell verifier's inverse coset-shift
powers and erasure recovery's coset powers in Montgomery form; beside the
host-side setup points (G2 points for the pairing checks) and the roots
of unity of the setup's FFT domain (max_width) as Python ints, in the
three orders of the C ABI's settings arrays.

Entry points run on the card unless the caller names another device: with
no device given and no card present, `resolve_device` raises. Spans
(tracing.py): kzg.settings.load, and kzg.table.<name>.load or .build
wherever a table or constant is read from the cache or built.
"""

import hashlib
import os
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Tuple

import numpy as np
import torch

from .constants import (
    CELLS_PER_EXT_BLOB,
    FIELD_ELEMENTS_PER_BLOB,
    FIELD_ELEMENTS_PER_CELL,
    FIELD_ELEMENTS_PER_EXT_BLOB,
    R_MOD,
    RECOVERY_SHIFT_FACTOR,
    root_of_unity,
)
from .ops import g1 as dg1
from .ops import g1fft
from .ops import msm as dmsm
from .ops.field import FR
from .tracing import span
from .trusted_setup import TrustedSetup, brp_roots_of_unity, load_trusted_setup_file, reverse_bit_order

_TABLE_FORMAT_VERSION = 1
COLUMN_WINDOW = 8  # the FK20 column tables' window, as the JAX package's
# cell index -> its coset's position in the bit-reversed extended domain
CELL_INDICES_RBL = reverse_bit_order(list(range(CELLS_PER_EXT_BLOB)))


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card, and raises when
    there is none (nothing carries on on the CPU unless asked to)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


def cache_dir() -> str:
    """The table cache directory: $KZG_TPU_TORCH_CACHE_DIR, else
    ~/.cache/kzg_tpu_torch (this package's own, never the JAX package's)."""
    return os.environ.get("KZG_TPU_TORCH_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "kzg_tpu_torch"
    )


def _points_hash(points) -> str:
    h = hashlib.sha256()
    for p in points:
        if p is None:
            h.update(b"\x00" * 96)
        else:
            h.update(p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big"))
    return h.hexdigest()[:32]


def table_cache_path(points, tag: str, c: int) -> str:
    """Cache file of a table (or other arrays) built from `points`, named
    by `tag` and the window c (0 where there is none)."""
    return os.path.join(
        cache_dir(),
        f"kzg-tpu-torch.table.v{_TABLE_FORMAT_VERSION}.{tag}.{c}.{_points_hash(points)}.npz",
    )


def _xyinf_cached(name: str, path: str, build, device: torch.device):
    """(x, y, inf) tensors of the table `name` from the disk cache file
    `path`, or from build() (on `device`), then written there. The file is
    written whole (temporary name, then rename), so concurrent processes
    never read a partial one."""
    if os.path.exists(path):
        with span(f"kzg.table.{name}.load"), np.load(path) as data:
            return tuple(torch.from_numpy(data[k]).to(device) for k in ("x", "y", "inf"))
    with span(f"kzg.table.{name}.build"):
        x, y, inf = build()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            np.savez(tmp, x=x.cpu().numpy(), y=y.cpu().numpy(), inf=inf.cpu().numpy())
            os.replace(tmp, path)
        except OSError:
            pass  # a cache that cannot be written only costs the next process a rebuild
    return x, y, inf


def build_table_cached(points, tag: str, device: torch.device, c: Optional[int] = None):
    """Fixed-base table for a list of affine points, built on `device`, or
    loaded from the disk cache."""
    if c is None:
        c = dmsm.default_window(len(points), fixed_base=True)

    def build():
        return dmsm.build_fixed_base_table(dg1.affine_from_ints(points, device), c=c)[:3]

    return dmsm.FixedBaseTable(*_xyinf_cached(tag, table_cache_path(points, tag, c), build, device), c)


def build_x_ext_fft_columns(g1_monomial, n2: int, chunk_len: int, device: torch.device) -> dg1.G1Aff:
    """FK20's toeplitz_part_1 files for polynomials of n = n2 / 2
    coefficients in chunks of chunk_len (k = n / chunk_len chunks): for
    each offset < chunk_len, the G1 FFT of length 2k of [g1[n - chunk_len -
    1 - offset - i chunk_len] for i < k - 1] followed by k + 1 infinities;
    column i holds entry i of every offset's FFT. All offsets go through
    one batched fft_g1 on `device`. Returns affine points (24, 2k,
    chunk_len). The cells call's columns are the case n2 = 2 * (setup
    points), chunk_len = cell size."""
    n = n2 // 2
    k = n // chunk_len
    pts = []
    for offset in range(chunk_len):
        start = n - chunk_len - 1 - offset
        pts += [g1_monomial[start - i * chunk_len] for i in range(k - 1)] + [None] * (k + 1)
    aff = dg1.affine_from_ints(pts, device)
    rows = dg1.from_affine(dg1.G1Aff(*(t.reshape(t.shape[:-1] + (chunk_len, 2 * k)) for t in aff)))
    ext = g1fft.fft_g1(rows)  # (24, chunk_len, 2k)
    return dg1.to_affine(dg1.map_coords(lambda t: t.transpose(-1, -2).contiguous(), ext))


@dataclass
class TorchKZGSettings:
    """Trusted setup on one torch device: the EIP-4844 tables and the
    EIP-7594 (FK20) column tables, each built on first use. max_width is
    the width of the setup's FFT domain: 8192 on the mainnet setup, 2^scale
    on a test setup made from a secret."""

    setup: TrustedSetup
    device: torch.device
    max_width: int = FIELD_ELEMENTS_PER_EXT_BLOB

    @property
    def cell_size(self) -> int:
        """Field elements per cell: 64 on the mainnet setup, and n / 64 on
        any n-point setup (as the JAX package's test setups), so that an
        extended blob always has 128 cells."""
        return max(1, len(self.setup.g1_monomial) // (CELLS_PER_EXT_BLOB // 2))

    @cached_property
    def lagrange_table(self) -> dmsm.FixedBaseTable:
        """Fixed-base table over the bit-reversed Lagrange setup: the base
        of every blob commitment and proof MSM (c = 13, 20 windows)."""
        return build_table_cached(self.setup.g1_lagrange_brp, "lagrange_brp", self.device)

    @cached_property
    def x_ext_fft_columns(self) -> dg1.G1Aff:
        """The FK20 column points, affine (24, 2n / cell, cell): (24, 128,
        64) on the mainnet setup. Built on the device, cached on disk."""
        g1m = self.setup.g1_monomial

        def build():
            return build_x_ext_fft_columns(g1m, 2 * len(g1m), self.cell_size, self.device)

        path = table_cache_path(g1m, "x_ext_fft_columns", 0)
        return dg1.G1Aff(*_xyinf_cached("x_ext_fft_columns", path, build, self.device))

    def fk20_columns(self, n2: int, chunk_len: int) -> dg1.G1Aff:
        """The legacy FK20 files at (n2, chunk_len), affine (24, n2 /
        chunk_len, chunk_len), built on the device and cached on disk per
        (n2, chunk_len). At the cells call's case (n2 twice the setup's
        points, chunk_len the cell size) they are x_ext_fft_columns, and
        that tensor is returned."""
        g1m = self.setup.g1_monomial
        if (n2, chunk_len) == (2 * len(g1m), self.cell_size):
            return self.x_ext_fft_columns

        def build():
            return build_x_ext_fft_columns(g1m, n2, chunk_len, self.device)

        path = table_cache_path(g1m, f"fk20_columns.{n2}", chunk_len)
        return dg1.G1Aff(*_xyinf_cached(f"fk20_columns.{n2}.{chunk_len}", path, build, self.device))

    @cached_property
    def column_tables(self) -> dmsm.FixedBaseTable:
        """Fixed-base tables over the FK20 columns, c = 8 (32 windows), with
        the columns as the table's batch dim: (24, 32, 128, 64) on the
        mainnet setup. Built on the device, cached on disk."""
        def build():
            return dmsm.build_fixed_base_table(self.x_ext_fft_columns, c=COLUMN_WINDOW)[:3]

        path = table_cache_path(self.setup.g1_monomial, "x_ext_columns", COLUMN_WINDOW)
        return dmsm.FixedBaseTable(*_xyinf_cached("x_ext_columns", path, build, self.device), COLUMN_WINDOW)

    @cached_property
    def roots_of_unity(self) -> List[int]:
        """w^0 .. w^max_width for w the primitive max_width-th root of
        unity: max_width + 1 values, natural order, the last one 1."""
        w = root_of_unity(self.max_width.bit_length() - 1)
        roots = [1]
        for _ in range(self.max_width):
            roots.append(roots[-1] * w % R_MOD)
        return roots

    @cached_property
    def brp_roots_of_unity(self) -> List[int]:
        """The first max_width roots_of_unity in bit-reversed order."""
        return reverse_bit_order(self.roots_of_unity[:-1])

    @cached_property
    def reverse_roots_of_unity(self) -> List[int]:
        """roots_of_unity in reverse order (max_width + 1 values)."""
        return self.roots_of_unity[::-1]

    @cached_property
    @span("kzg.table.roots_brp_mont.build")
    def roots_brp_mont(self) -> torch.Tensor:
        """Bit-reversed 4096 roots of unity, Montgomery form, (16, 4096)."""
        return FR.encode(brp_roots_of_unity(FIELD_ELEMENTS_PER_BLOB), self.device)

    @cached_property
    @span("kzg.table.inv_coset_shift_pows.build")
    def inv_coset_shift_pows(self) -> torch.Tensor:
        """The cell verifier's inverse coset-shift powers, Montgomery form
        (16, 128, 64): column col holds h^-k for k < 64, h^-1 = w^(8192 -
        CELL_INDICES_RBL[col]) with w the 8192nd root of unity (the JAX
        package's eip7594._interp_consts)."""
        n_ext = FIELD_ELEMENTS_PER_EXT_BLOB
        w = root_of_unity(n_ext.bit_length() - 1)
        vals = []
        for col in range(CELLS_PER_EXT_BLOB):
            inv_factor = pow(w, (n_ext - CELL_INDICES_RBL[col]) % n_ext, R_MOD)
            acc = 1
            for _ in range(FIELD_ELEMENTS_PER_CELL):
                vals.append(acc)
                acc = acc * inv_factor % R_MOD
        shape = (FR.n_limbs, CELLS_PER_EXT_BLOB, FIELD_ELEMENTS_PER_CELL)
        return torch.from_numpy(FR.encode_host(vals).reshape(shape)).to(self.device)

    @cached_property
    @span("kzg.table.recovery_shift_pows.build")
    def recovery_shift_pows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Erasure recovery's coset powers, Montgomery form, (16, 8192)
        each: k^i and k^-i for i < 8192, k = RECOVERY_SHIFT_FACTOR."""
        n_ext = FIELD_ELEMENTS_PER_EXT_BLOB
        k = RECOVERY_SHIFT_FACTOR
        k_inv = pow(k, R_MOD - 2, R_MOD)
        return tuple(FR.encode([pow(f, i, R_MOD) for i in range(n_ext)], self.device) for f in (k, k_inv))

    @cached_property
    def monomial_table(self) -> dmsm.FixedBaseTable:
        """Fixed-base table over the whole monomial setup, the base of
        monomial-form commitments (multiproofs): c = 13, 20 x 4096 on the
        mainnet setup. Built on the device, cached on disk."""
        return build_table_cached(self.setup.g1_monomial, "monomial", self.device)

    @cached_property
    def monomial64_table(self) -> dmsm.FixedBaseTable:
        """Fixed-base table over the first 64 monomial setup points, the
        base of the cell verifier's interpolation commitment, at the window
        of a table over the whole monomial setup (c = 13): its rows equal
        the first 64 columns of that table, as the JAX package slices them
        out of its monomial_table."""
        g1m = self.setup.g1_monomial
        c = dmsm.default_window(len(g1m), fixed_base=True)
        return build_table_cached(g1m[:FIELD_ELEMENTS_PER_CELL], "monomial64", self.device, c=c)

    @property
    def g2_monomial(self) -> list:
        return self.setup.g2_monomial


# the repo's copy of the mainnet setup, beside this package
_REPO_SETUP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "trusted_setup.txt")


def trusted_setup_path() -> str:
    """The trusted setup file to load when the caller names none, looked up
    as the JAX package looks it up: $KZG_TPU_TRUSTED_SETUP if that file
    exists, else the repo's tests/trusted_setup.txt. Raises
    FileNotFoundError when neither exists."""
    for p in (os.environ.get("KZG_TPU_TRUSTED_SETUP", ""), _REPO_SETUP):
        if p and os.path.isfile(p):
            return p
    raise FileNotFoundError("trusted_setup.txt not found: set KZG_TPU_TRUSTED_SETUP or pass a path")


@span("kzg.settings.load")
def load_settings(path: Optional[str] = None, device=None) -> TorchKZGSettings:
    """Settings from a trusted setup file (`trusted_setup_path()` when
    `path` is None) on `device` (the card when None)."""
    dev = resolve_device(device)
    return TorchKZGSettings(load_trusted_setup_file(path or trusted_setup_path()), dev)
