"""The general generator: what every kind of call shares. A traffic file
(traffic/<name>.json) names its kind under "call", and the kind is the
class `Kind` of calls/<call>.py, found by name. The kind makes a call's
inputs from the seed, runs one call through the program's public API and
has the reference judge what one call returned.

The traffic file gives the numbers (blobs a call, the share of invalid
inputs, the pool, how many calls are made ready, warmed, judged and
traced), so a new traffic of an existing kind is a data file alone, and a
new kind is a new file under calls/.
"""

import hashlib
import os
import random

import numpy as np

from . import byname
from .blobs import canonical_blobs, rng_for
from .reference import kzg as ref
from .reference import pool as ref_pool

# draw streams of a run's seed
STREAM_INPUTS, STREAM_CHECK = 1, 3
WARM_BASE = 1 << 20  # call indices of warm-up inputs


def kind(traffic: dict, root: str) -> "CallKind":
    """The call kind that `traffic` names, made for that traffic."""
    return byname.load("calls", traffic["call"]).Kind(traffic, root)


class CallKind:
    """One kind of call. `setup` does the work the inputs need once,
    `prepare` makes call `index`'s inputs (the same seed and index give the
    same inputs), `run` makes the call and returns its outputs on the host,
    `check` returns the reference's counts of wrong outputs (each compared
    with the limit 0)."""

    checks: tuple = ()

    def __init__(self, traffic: dict, root: str):
        self.traffic = traffic
        self.root = root

    def setup(self, seed: int) -> None:
        """Work the inputs need once (the pool), before any prepare."""

    def prepare(self, seed: int, index: int):
        raise NotImplementedError

    def run(self, api, s, inputs):
        raise NotImplementedError

    def check(self, setup, inputs, outputs, rng: random.Random) -> dict:
        raise NotImplementedError


class FreshBlobs(CallKind):
    """A producer call of `blobs` fresh seeded blobs of canonical elements,
    uniform below r."""

    def prepare(self, seed, index):
        return canonical_blobs(rng_for(seed, STREAM_INPUTS, index), self.traffic["blobs"])


class PoolCall(CallKind):
    """A verification of inputs drawn from a pool of the reference's
    (pools/<pool>.json): `blobs` distinct pool blobs a call. A share
    `invalid_share` of the calls, at positions drawn from the seed, has
    one proof replaced by another pool blob's, so it must be refused.
    `prepare` returns (the call's arguments, whether they are valid);
    `verify` is the reference's answer for the arguments."""

    checks = ("answers_wrong",)

    def setup(self, seed):
        path = os.path.join(self.root, "kzgbench", "pools", self.traffic["pool"] + ".json")
        self.pool = ref_pool.load(path)
        n = self.traffic["prepared_calls"]
        k = round(self.traffic["invalid_share"] * n)
        rng = rng_for(seed, STREAM_INPUTS, 1 << 30)
        self.invalid = set(rng.choice(n, size=k, replace=False).tolist())

    def draw(self, seed, index):
        """(the call's generator, the pool blobs picked, and for an invalid
        call (the position replaced, the pool blob whose proof replaces it))."""
        rng = rng_for(seed, STREAM_INPUTS, index)
        size = len(self.pool["entries"])
        picked = rng.choice(size, size=self.traffic["blobs"], replace=False).tolist()
        invalid = index in self.invalid
        bad_at = int(rng.integers(len(picked)))
        other = int(rng.choice([b for b in range(size) if b not in picked]))
        return rng, picked, (bad_at, other) if invalid else None

    def verify(self, setup, args, rng) -> bool:
        raise NotImplementedError

    def check(self, setup, inputs, outputs, rng):
        args, expected = inputs
        answer = self.verify(setup, args, rng)
        if answer != expected:
            raise RuntimeError(f"the reference's answer {answer} differs from the input's construction ({expected})")
        return {"answers_wrong": int(not (isinstance(outputs, bool) and outputs == answer))}


def pool_cells(root: str, name: str, pool: dict) -> np.ndarray:
    """Every cell of every pool blob as bytes, (blobs, 128, 2048) uint8,
    computed by the reference once and kept in the checkout's build
    directory under the pool's digest."""
    digest = hashlib.sha256("".join(e["blob_sha256"] for e in pool["entries"]).encode()).hexdigest()[:16]
    path = os.path.join(root, "build", "kzgbench", "pools", f"{name}.{digest}.cells.npy")
    if os.path.exists(path):
        return np.load(path)
    out = np.empty((len(pool["blobs"]), ref.CELLS, 32 * ref.CELL), dtype=np.uint8)
    for b, blob in enumerate(pool["blobs"]):
        cells = ref.cells_from_coeffs(ref.evals_to_coeffs(ref.blob_to_evals(blob)))
        for k, vals in enumerate(cells):
            out[b, k] = np.frombuffer(ref.cell_to_bytes(vals), dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, out)
    os.replace(tmp, path)
    return out
