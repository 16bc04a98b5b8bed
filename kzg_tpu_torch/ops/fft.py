"""Radix-2 FFT (NTT) over Fr in PyTorch. The counterpart of the JAX
package's ops/fft.py, with the semantics of its fft_body: natural-order
input, bit-reversal permutation, decimation-in-time stages with the roots
w_{2^(s+1)}, and for the inverse the inverse roots and a 1/n scale.

Values are (16, *batch, n) int32 limb tensors in Montgomery form; the batch
dims are independent transforms along the last axis. Every transform runs
through the two kernel wrappers of ops/cuda_fft.py: B4 does the gather,
the scale and the first min(log n, 11) stages, B5 one stage above that per
launch. On the card those are the CUDA kernels; on the CPU their plain
PyTorch versions.
"""

import torch

from .. import tracing
from . import cuda_fft
from .cuda_fft import bit_reverse, brp_indices  # noqa: F401  (re-exported)


@tracing.span("kzg.ntt")
def fft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """FFT along the last axis (n a power of two) of Montgomery-form Fr
    limbs (16, *batch, n); the inverse includes the 1/n scale."""
    n = x.shape[-1]
    if n & (n - 1) or n == 0:
        raise ValueError(f"fft: length {n} is not a power of two")
    if n == 1:
        return x.clone()
    shape = x.shape
    log_n = n.bit_length() - 1
    y = cuda_fft.ntt_tile(x.reshape(shape[0], -1, n).contiguous(), inverse)
    for s in range(cuda_fft.tile_stages(log_n), log_n):
        y = cuda_fft.ntt_stage(y, s, inverse)
    return y.reshape(shape)


def ifft(x: torch.Tensor) -> torch.Tensor:
    return fft(x, inverse=True)


def das_extension(evens: torch.Tensor) -> torch.Tensor:
    """The erasure-coding extension: given the values (16, *batch, n) of a
    polynomial of degree < n on the n-domain (the even points of the
    2n-domain), its values on the odd points of the 2n-domain."""
    coeffs = ifft(evens)
    full = fft(torch.cat([coeffs, torch.zeros_like(coeffs)], dim=-1))
    return full[..., 1::2]
