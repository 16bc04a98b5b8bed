"""The pools of valid inputs that the verify traffic draws from, made by the
reference alone (the program makes none of its own inputs): seeded blobs
with their commitments, blob proofs and all 128 cell proofs each, written
once to a data file under kzgbench/pools/ and checked in.

    python3 -m kzgbench.reference.pool kzgbench/pools/<name>.json --seed S --blobs 16 [--workers 6]

A run regenerates the blobs from the file's seed and checks them against
the file's digests before it uses the file.
"""

import argparse
import hashlib
import json
import multiprocessing
import os

from ..blobs import canonical_blobs, rng_for
from . import kzg
from .curve import g1_to_bytes
from .setup import load as load_setup

POOL_STREAM = 7594  # the draw stream of pool blobs
_SETUP = {}


def pool_blobs(seed: int, count: int) -> list:
    return canonical_blobs(rng_for(seed, POOL_STREAM), count)


def _entry(args):
    setup_path, blob = args
    if "s" not in _SETUP:
        _SETUP["s"] = load_setup(setup_path, n_monomial=kzg.N)
    s = _SETUP["s"]
    evals = kzg.blob_to_evals(blob)
    coeffs = kzg.evals_to_coeffs(evals)
    commitment = g1_to_bytes(kzg.commitment(evals, s))
    z = kzg.challenge(blob, commitment)
    return {
        "blob_sha256": hashlib.sha256(blob).hexdigest(),
        "commitment": commitment.hex(),
        "blob_proof": g1_to_bytes(kzg.blob_proof(coeffs, z, s)).hex(),
        "cell_proofs": [g1_to_bytes(p).hex() for p in kzg.cell_proofs(coeffs, s)],
    }


def build(setup_path: str, seed: int, count: int, workers: int) -> dict:
    blobs = pool_blobs(seed, count)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        entries = pool.map(_entry, [(setup_path, b) for b in blobs])
    return {"seed": seed, "stream": POOL_STREAM, "setup": setup_path, "entries": entries}


def load(path: str) -> dict:
    """The pool in `path` with its blobs regenerated: raises ValueError if
    a blob's digest differs from the file's."""
    with open(path) as f:
        pool = json.load(f)
    blobs = pool_blobs(pool["seed"], len(pool["entries"]))
    for i, (blob, e) in enumerate(zip(blobs, pool["entries"])):
        if hashlib.sha256(blob).hexdigest() != e["blob_sha256"]:
            raise ValueError(f"{path}: blob {i} does not match its digest")
    pool["blobs"] = blobs
    return pool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--blobs", type=int, default=16)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--setup", default="tests/trusted_setup.txt")
    args = ap.parse_args(argv)
    pool = build(args.setup, args.seed, args.blobs, args.workers)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(pool, f, indent=0)
        f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
