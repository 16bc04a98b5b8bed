"""Seeded blobs: 4096 field elements each, drawn uniformly below the
scalar field's modulus r (255-bit draws, the ones >= r drawn again), as
big-endian 32-byte words. The same (seed, stream, index) gives the same
blobs on every machine."""

import numpy as np

from .reference.fields import R

FIELD_ELEMENTS = 4096
_M64 = (1 << 64) - 1
_R_WORDS = np.array([(R >> s) & _M64 for s in (192, 128, 64, 0)], dtype=np.uint64)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's draws: any whole seed, negative
    or above 2^63 too, is taken mod 2^64."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def _below_r(words: np.ndarray) -> np.ndarray:
    """Rows of four big-endian uint64 words whose value is below r."""
    lt = np.zeros(len(words), dtype=bool)
    eq = np.ones(len(words), dtype=bool)
    for i in range(4):
        lt |= eq & (words[:, i] < _R_WORDS[i])
        eq &= words[:, i] == _R_WORDS[i]
    return lt


def canonical_blobs(rng: np.random.Generator, count: int) -> list:
    """`count` blobs of canonical field elements, uniform below r."""
    n = count * FIELD_ELEMENTS
    words = np.empty((n, 4), dtype=np.uint64)
    todo = np.arange(n)
    while todo.size:
        draw = rng.integers(0, _M64, (todo.size, 4), dtype=np.uint64, endpoint=True)
        draw[:, 0] >>= np.uint64(1)  # below 2^255
        ok = _below_r(draw)
        words[todo[ok]] = draw[ok]
        todo = todo[~ok]
    raw = words.astype(">u8").tobytes()
    size = 32 * FIELD_ELEMENTS
    return [raw[i * size : (i + 1) * size] for i in range(count)]
