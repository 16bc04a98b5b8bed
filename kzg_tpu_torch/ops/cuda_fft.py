"""Wrappers of the Fr NTT's two CUDA kernels, each beside its plain PyTorch
version. The counterpart of the JAX package's ops/pallas_fft.py.

  ntt_tile   kernel B4 (csrc/fft_kernels.cu), replaces
             pallas_fft.py:_kernel_ab: the bit-reversal gather, the
             inverse's 1/n scale and the first min(log n, 11) stages
  ntt_stage  kernel B5 (csrc/fft_kernels.cu), replaces
             pallas_fft.py:_kernel_c_stage: one stage above the tile

Values are (16, B, n) int32 tensors of 16-bit limbs in Montgomery form: B
transforms of length n, a power of two. The transform is radix-2
decimation in time on bit-reversed input; stage s pairs positions a and
a + 2^s with the twiddle w_{2^(s+1)}^(a mod 2^s), the inverse uses the
inverse roots, so ntt_tile followed by ntt_stage for every stage above the
tile is the JAX package's fft_body.

A wrapper runs its plain version (`*_ref`) for tensors on the CPU. For a
CUDA tensor it launches the kernel, or raises: nothing falls back. Each
wrapper checks device, dtype, shape and contiguity, and counts its launches
in the tracing registry (tracing.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..constants import R_MOD as R, root_of_unity
from . import field as fl
from .. import tracing
from . import launch
from .field import FR

L = FR.n_limbs
MAX_LOG_TILE = 11  # B4's tile: 2^11 Fr values, a cluster of 8 blocks of 2^8 (csrc/fft_kernels.cu)


def brp_indices(n: int) -> np.ndarray:
    """Bit-reversal permutation indices of length n (a power of two)."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def bit_reverse(x: torch.Tensor) -> torch.Tensor:
    """The bit-reversal permutation along the last axis (a power of two)."""
    return x[..., fl.to_device(brp_indices(x.shape[-1]), x.device)]


def tile_stages(log_n: int) -> int:
    """Stages B4 runs; B5 runs the rest, one launch each."""
    return min(log_n, MAX_LOG_TILE)


@lru_cache(maxsize=None)
def _twiddles_host(log_n: int, inverse: bool) -> np.ndarray:
    """(16, n/2) Montgomery limbs of w_n^k, k < n/2 (w_n^-k for the
    inverse): stage s reads entry j << (log_n - s - 1) for w_{2^(s+1)}^j."""
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, R - 2, R)
    vals = [1]
    for _ in range((1 << log_n) // 2 - 1):
        vals.append(vals[-1] * w % R)
    return FR.encode_host(vals)


@lru_cache(maxsize=None)
def twiddles(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    return torch.from_numpy(_twiddles_host(log_n, inverse)).to(device)


def _words(limbs: np.ndarray) -> np.ndarray:
    """(16, ...) 16-bit limbs -> (8, ...) 32-bit words as int32 bit patterns."""
    w = limbs[0::2].astype(np.int64) | (limbs[1::2].astype(np.int64) << 16)
    return (w - ((w >> 31) << 32)).astype(np.int32)


@lru_cache(maxsize=None)
def _twiddle_words(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_words(_twiddles_host(log_n, inverse)))).to(device)


@lru_cache(maxsize=None)
def _n_inv(log_n: int, device: str, words: bool) -> torch.Tensor:
    limbs = FR.encode_host(pow(1 << log_n, R - 2, R))  # (16, 1)
    return torch.from_numpy(_words(limbs) if words else limbs).to(device)


def _log2(n: int) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"transform length {n}: expected a power of two >= 2")
    return n.bit_length() - 1


def _check_values(x: torch.Tensor) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (16, B, n)")
    B, n = x.shape[1:]
    launch.check(x, "x", torch.int32, (L, B, n), x.device)
    return B, n, _log2(n)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def ntt_stage_ref(x: torch.Tensor, s: int, inverse: bool) -> torch.Tensor:
    """Plain version of B5: one butterfly stage s."""
    _, B, n = x.shape
    log_n = n.bit_length() - 1
    h = 1 << s
    y = x.reshape(L, B, n >> (s + 1), 2, h)
    a, b = y[..., 0, :], y[..., 1, :]
    if s > 0:  # stage 0's twiddle is one
        pick = torch.arange(h, device=x.device) << (log_n - s - 1)
        tw = twiddles(log_n, inverse, str(x.device))[:, pick]
        b = fl.mont_mul(FR, b, tw.reshape(L, 1, 1, h))
    return torch.stack([fl.add(FR, a, b), fl.sub(FR, a, b)], dim=-2).reshape(L, B, n)


def ntt_tile_ref(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Plain version of B4: bit-reversal gather, 1/n scale for the inverse,
    stages 0 .. min(log n, 11) - 1."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    y = bit_reverse(x)
    if inverse:
        y = fl.mont_mul(FR, y, _n_inv(log_n, str(x.device), False).reshape(L, 1, 1))
    for s in range(tile_stages(log_n)):
        y = ntt_stage_ref(y, s, inverse)
    return y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@launch.counted("ntt_tile")
def ntt_tile(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """B4 on x (16, B, n) int32, natural order in, stages 0 .. min(log n,
    11) - 1 done out (the whole transform for n <= 2^11)."""
    B, n, log_n = _check_values(x)
    dev = x.device
    if dev.type == "cpu":
        return ntt_tile_ref(x, inverse)
    launch.require_cuda(dev)
    out = torch.empty_like(x)
    if B == 0:
        return out
    scale = _n_inv(log_n, str(dev), True) if inverse else None
    rc = launch.kernels().kzg_ntt_tile(
        x.data_ptr(), out.data_ptr(), _twiddle_words(log_n, inverse, str(dev)).data_ptr(),
        None if scale is None else scale.data_ptr(), log_n, B * n, launch.stream(),
    )
    tracing.count("launch.ntt_tile")
    launch.check_launch(rc, "ntt_tile")
    return out


@launch.counted("ntt_stage")
def ntt_stage(x: torch.Tensor, s: int, inverse: bool = False) -> torch.Tensor:
    """B5 on x (16, B, n) int32: butterfly stage s (0 <= s < log n) over
    device memory, out of place."""
    B, n, log_n = _check_values(x)
    if not 0 <= s < log_n:
        raise ValueError(f"stage {s} of a transform of length {n}")
    dev = x.device
    if dev.type == "cpu":
        return ntt_stage_ref(x, s, inverse)
    launch.require_cuda(dev)
    out = torch.empty_like(x)
    if B == 0:
        return out
    rc = launch.kernels().kzg_ntt_stage(
        x.data_ptr(), out.data_ptr(), _twiddle_words(log_n, inverse, str(dev)).data_ptr(),
        log_n, s, B * n, launch.stream(),
    )
    tracing.count("launch.ntt_stage")
    launch.check_launch(rc, "ntt_stage")
    return out
