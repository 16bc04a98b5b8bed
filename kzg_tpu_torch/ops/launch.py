"""What the kernel wrappers (ops/cuda_msm.py, ops/cuda_fft.py) share: their
input checks, the launch check, the current stream, the kernel library,
and one registry of launch counts over every kernel.

Each wrapper is registered under its kernel's name and carries a plain
integer `.launches` that it increments where it launches its kernel, and
nowhere else; `reset_launches()` zeroes them all and `launches()` reads
them, so a run can show which kernels it went through.
"""

from __future__ import annotations

import torch

WRAPPERS = {}


def counted(name: str):
    """Register a kernel wrapper under `name`, with its count at 0."""

    def register(fn):
        fn.launches = 0
        WRAPPERS[name] = fn
        return fn

    return register


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


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
