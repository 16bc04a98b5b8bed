"""What the kernel wrappers (ops/cuda_msm.py, ops/cuda_fft.py,
ops/cuda_gather.py, ops/field.py inv, ops/g1fft.py ladder) share: their input checks, the
launch check, the current stream and the kernel library.

The launch counts live in the package's tracing registry (tracing.py), as
counters `launch.<kernel>`; `counted`, `launches` and `reset_launches` are
its names for them here.
"""

from __future__ import annotations

import torch

from ..tracing import counted, launches, reset_launches  # noqa: F401


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def require_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: the kernels run on CUDA, the plain versions on the CPU")


def kernels():
    from .. import kernels as k

    return k.load()
