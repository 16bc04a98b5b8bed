"""MSMs sharded over a device mesh: the counterpart of the JAX package's
parallel/sharded_msm.py.

  - mesh axis "blobs": the independent MSMs of a batch, split over ranks;
    each rank runs its MSMs whole, and the results are gathered.
  - mesh axis "points": each rank runs the bucket method on its block of
    the points; the partial sums (one point an MSM) are gathered and added
    up on every rank by a halving tree. Point addition is no ring sum, and
    the payload is one point, so one small all_gather does.

Every rank calls with the same full inputs and gets back the whole result.
The results are XYZZ points whose coordinates depend on the order of the
additions: compare them in affine form.
"""

from typing import Optional

import torch

from ..ops import g1
from ..ops import msm as m
from ..ops.g1 import G1Aff, G1XYZZ
from .distributed import all_gather, axis_size, gather_shards, shard


def _combine_gathered(part: G1XYZZ, mesh, axis: str) -> G1XYZZ:
    """Every rank's partial sums (..., ) along `axis`, added up: (...)."""
    gathered = g1.map_coords(lambda c: all_gather(c, mesh, axis), part)  # (..., d)
    return g1.map_coords(lambda c: c[..., 0], g1.tree_reduce(gathered))


def msm_fixed_sharded(table: m.FixedBaseTable, scalars: torch.Tensor, mesh) -> G1XYZZ:
    """Fixed-base MSMs with the batch cut over the mesh's "blobs" axis and
    the table's points over its "points" axis.

    table: x/y (24, w, n), inf (w, n); scalars: canonical Fr limbs (16, B,
    n), B a multiple of the blob axis's size and n of the point axis's.
    Returns the B sums, XYZZ (24, B), on every rank."""
    if scalars.dim() != 3:
        raise ValueError(f"scalars: shape {tuple(scalars.shape)}, expected (16, B, n)")
    local = m.FixedBaseTable(*(shard(t, mesh, "points", -1) for t in table[:3]), table.c)
    sc = shard(shard(scalars, mesh, "blobs", 1), mesh, "points", 2)
    part = m.msm_fixed(local, sc)  # (24, B / blobs)
    return g1.map_coords(lambda c: gather_shards(c, mesh, "blobs", 1), _combine_gathered(part, mesh, "points"))


def msm_sharded(
    points: G1Aff,
    scalars: torch.Tensor,
    mesh,
    point_axis: str = "points",
    c: Optional[int] = None,
) -> G1XYZZ:
    """Variable-base MSM with the points cut over `point_axis`.

    points: affine (24, *batch, n); scalars: canonical Fr limbs (16,
    *batch, n); n a multiple of the axis's size. The window c defaults to
    the one for a shard's n / d points. Returns XYZZ sums (24, *batch) on
    every rank."""
    n = points.x.shape[-1]
    if c is None:
        c = m.default_window(max(1, n // axis_size(mesh, point_axis)), fixed_base=False)
    local = G1Aff(*(shard(t, mesh, point_axis, -1) for t in points))
    part = m.msm_core(local, shard(scalars, mesh, point_axis, -1), c)
    return _combine_gathered(part, mesh, point_axis)
