"""Wrapper of the row-gather CUDA kernel, beside its plain PyTorch version.
The counterpart of the pallas_dg variant of the JAX package's gather probe
(benches/gather_micro.py).

  gather_rows  kernel B6 (csrc/gather_kernels.cu), replaces
               benches/gather_micro.py:182 (pdg)

out[e, :] = table[idx[e], :]: E int32 indices into a table of R rows of
`width` 32-bit words, kept as int32 bit patterns. The plain version,
`gather_rows_ref`, is one library call, `Tensor.index_select`: it is both
the reference of the tests and the yardstick of the library column in
chip_smoke.py and the benches.

The wrapper runs the plain version for tensors on the CPU. For a CUDA
tensor it launches the kernel, or raises: nothing falls back. It checks
device, dtype, shape and contiguity, and counts its launches in the
tracing registry (tracing.py). An index outside [0, R) raises IndexError: the
kernel writes that row as zeros and sets a flag on the card, which the
wrapper reads, so a call waits for the card. A caller that queues many
launches (the benches) passes its own `flag` instead: the call then returns
without waiting and `raise_if_flagged(flag)` reads it once, later.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import tracing
from . import launch

MAX_WIDTH = 4096  # words per row the kernel takes (its reciprocal stays exact)


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: the library's row gather."""
    return table.index_select(0, idx)


def new_flag(device) -> torch.Tensor:
    """A cleared out-of-range flag for `gather_rows(..., flag=...)`."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def raise_if_flagged(flag: torch.Tensor) -> None:
    """Raise IndexError if a launch that shared `flag` met an index outside
    its table (reads the flag: waits for the card)."""
    if int(flag.item()):
        raise IndexError("gather_rows: index out of range of the table")


@launch.counted("gather_rows")
def gather_rows(table: torch.Tensor, idx: torch.Tensor, flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of `table` (R, width) int32 at `idx` (E,) int32: (E, width)
    int32. Without `flag`, an index outside [0, R) raises IndexError. With
    `flag` ((1,) int32 on the table's device) the call only sets flag[0] to
    1 for such an index, writes that row as zeros, and returns at once."""
    dev = table.device
    if table.dim() != 2:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected (rows, width)")
    R, width = table.shape
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"table: width {width}, expected 1 .. {MAX_WIDTH}")
    if idx.dim() != 1:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected (E,)")
    E = idx.shape[0]
    launch.check(table, "table", torch.int32, (R, width), dev)
    launch.check(idx, "idx", torch.int32, (E,), dev)
    if flag is not None:
        launch.check(flag, "flag", torch.int32, (1,), dev)
    if dev.type == "cpu":
        bad = (idx < 0) | (idx >= R)
        if not bool(bad.any()):
            return gather_rows_ref(table, idx)
        if flag is None:
            raise IndexError("gather_rows: index out of range of the table")
        flag.fill_(1)
        return gather_rows_ref(table, idx.masked_fill(bad, 0)).masked_fill(bad[:, None], 0)
    launch.require_cuda(dev)
    out = torch.empty((E, width), dtype=torch.int32, device=dev)
    if E == 0:
        return out
    own = flag is None
    if own:
        flag = new_flag(dev)
    rc = launch.kernels().kzg_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), flag.data_ptr(), R, E, width, launch.stream()
    )
    tracing.count("launch.gather_rows")
    launch.check_launch(rc, "gather_rows")
    if own:
        raise_if_flagged(flag)
    return out
