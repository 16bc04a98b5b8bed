"""The multi-process dry run: spawn ranks of one gloo process group, put
them on one blobs x points mesh, run every sharded program at small shapes
and hold each result against the port's single-process function on the
same inputs. The counterpart of the JAX package's dryrun_multichip.

    python3 -m kzg_tpu_torch.parallel.dryrun [N_PROCS [DEVICE]]

N_PROCS defaults to 4 and DEVICE to the card (cuda:0, every rank on it;
"cpu" runs the ranks on the CPU). Each rank prints one OK line; the parent
raises if a rank fails, disagrees or outlives the time limit.

`launch` is the launcher (also for chip_smoke.py and the scaling bench):
the parent builds the native core and, for a card, the kernels before it
spawns, so that ranks only load them; ranks start with the `spawn` method
(CUDA does not survive `fork`), each on a free localhost port, write their
results as JSON, and are all stopped before `launch` returns.
"""

import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 600.0  # seconds for a whole launch
EXIT_GRACE = 30.0  # seconds a rank that wrote its result may take to exit before it is killed
SECRET = 1927409816240961209460912649124  # the toy setup's (insecure, test-only) secret
WINDOW = 4  # the toy MSMs' window: 2^3 + 1 buckets a window


def mesh_shape(n_procs: int, blob_axis_size=None) -> tuple:
    """(blobs, points) for n_procs ranks. By default the points axis takes
    the largest power of two up to 4 that divides n_procs, as the JAX
    package's dry run factors its devices."""
    if blob_axis_size is None:
        d_pts = 1
        while d_pts * 2 <= n_procs and n_procs % (d_pts * 2) == 0 and d_pts < 4:
            d_pts *= 2
        return n_procs // d_pts, d_pts
    if n_procs % blob_axis_size:
        raise ValueError(f"{n_procs} ranks not divisible by blob axis {blob_axis_size}")
    return blob_axis_size, n_procs // blob_axis_size


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n_procs: int, port: int, program, args: tuple, out_dir: str) -> None:
    from .distributed import initialize

    torch.set_num_threads(1)  # ranks share the host's cores
    code = 1
    try:
        initialize(f"127.0.0.1:{port}", n_procs, rank, backend="gloo")
        result = program(*args)
        path = os.path.join(out_dir, f"rank{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(path + ".tmp", path)
        code = 0
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(code)  # the result is on disk: skip the interpreter's teardown of torch and CUDA


def launch(program, n_procs: int, device: str, args: tuple = (), out_dir=None, timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run program(device, *args) in n_procs spawned ranks of one gloo
    process group (every rank on `device`) and return each rank's result,
    a JSON value, in rank order. program is a module-level function.
    Raises RuntimeError when a rank fails or the ranks outlive `timeout`
    seconds; every rank is stopped before this returns. out_dir keeps the
    results (rank<r>.json) and a failed rank's traceback (rank<r>.err)."""
    from .. import kernels, native

    native.build()
    if torch.device(device).type == "cuda":
        kernels.build()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = out_dir or tmp
        port = _free_port()
        procs = [ctx.Process(target=_rank_main, args=(r, n_procs, port, program, (device, *args), out))
                 for r in range(n_procs)]
        for p in procs:
            p.start()
        try:
            deadline, t_results = time.monotonic() + timeout, None
            while True:
                # checked after every wait, so that a rank which fails as the last ones exit is seen too
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"ranks {failed} failed:\n" + _errors(out, n_procs))
                running = [p for p in procs if p.exitcode is None]
                if not running:
                    break
                now = time.monotonic()
                if t_results is None and all(os.path.exists(os.path.join(out, f"rank{r}.json")) for r in range(n_procs)):
                    t_results, deadline = now, min(deadline, now + EXIT_GRACE)
                if now >= deadline:
                    late = [r for r, p in enumerate(procs) if p.exitcode is None]
                    if t_results is not None:  # every result is written: stop the stragglers below
                        print(f"launch: ranks {late} had not exited {EXIT_GRACE:.0f} s after the last result; "
                              f"stopping them", file=sys.stderr, flush=True)
                        break
                    raise RuntimeError(f"ranks {late} still running after {timeout:.0f} s:\n" + _errors(out, n_procs))
                ready = wait([p.sentinel for p in running], timeout=deadline - now)
                if ready and all(p.exitcode is None for p in running if p.sentinel in ready):
                    time.sleep(0.05)  # a rank's pipe closed as it exits: wait to reap it, without spinning
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(n_procs):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                results.append(json.load(f))
        return results


def _errors(out_dir: str, n_procs: int) -> str:
    text = ""
    for r in range(n_procs):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                text += f"--- rank {r}\n{f.read()}"
    return text


# ---------------------------------------------------------------------------
# The dry run's programs at small shapes
# ---------------------------------------------------------------------------


def toy_inputs(d_blobs: int, d_pts: int) -> dict:
    """The dry run's inputs, as Python ints, from fixed seeds: n = 8 d_pts
    points s^i G of a toy setup; b = 2 d_blobs rows of n scalars for the
    blobs x points MSMs; one row of scalars a rank (d_blobs d_pts of them)
    for the commitments; for the evaluations the same number of
    polynomials on m = 16 points 7^i and a z each; three rows of n scalars
    for the lincomb; 64 Fr values for the FFT."""
    from ..constants import G1_GENERATOR_X, G1_GENERATOR_Y, R_MOD as R
    from ..native import g1_mul

    n, b, nb, m = 8 * d_pts, 2 * d_blobs, d_blobs * d_pts, 16
    rng = np.random.default_rng(3)

    def rows(k, width):
        return [[int.from_bytes(rng.bytes(32), "big") % R for _ in range(width)] for _ in range(k)]

    return {
        "points": [g1_mul((G1_GENERATOR_X, G1_GENERATOR_Y), pow(SECRET, i, R)) for i in range(n)],
        "scalars": rows(b, n),
        "commit_scalars": rows(nb, n),
        "roots": [pow(7, i, R) for i in range(m)],
        "polys": [[(i * 1315423911 + j * 2654435761 + 1) % R for j in range(m)] for i in range(nb)],
        "zs": rows(1, nb)[0],
        "lincomb_scalars": rows(3, n),
        "fft_values": rows(1, 64)[0],
    }


def _fr_bytes(rows, device) -> torch.Tensor:
    """Rows of Fr ints -> (B, n, 32) uint8 big-endian, as blob bytes."""
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for row in rows for v in row), dtype=np.uint8)
    return torch.from_numpy(raw.reshape(len(rows), -1, 32).copy()).to(device)


def toy_checks(device: str, mesh, bmesh, references: bool = True) -> dict:
    """Every sharded program at the dry run's shapes, on `mesh` (blobs x
    points) and `bmesh` (blobs). Then, with `references`, each result is
    held against the single-process function on the same inputs (affine
    points, or Fr values; AssertionError on a difference), each by one
    rank: rank r takes the checks r, r + world, ... (A caller that holds
    the results against a reference of its own, as the CPU tests do,
    passes references=False.) Returns the results as Python ints:
    affine points [x, y] (None for the identity), Fr values in Montgomery
    form (the evaluations canonical)."""
    from .. import eip4844 as e4
    from ..ops import fft as fft_ops, g1, msm
    from ..ops.field import FR, ints_to_limbs
    from .distributed import axis_size
    from .sharded_fft import fft_sharded, ifft_sharded
    from .sharded_msm import msm_fixed_sharded, msm_sharded

    dev = torch.device(device)
    inp = toy_inputs(axis_size(mesh, "blobs"), axis_size(mesh, "points"))

    def limbs(rows):
        return torch.from_numpy(np.stack([ints_to_limbs(r, 16) for r in rows], axis=1)).to(dev)

    checks = []

    def same(name, got, want):
        """got; held against want() after the last collective, so that no
        rank waits for another's references."""
        checks.append((name, got, want))
        return got

    aff = g1.affine_from_ints(inp["points"], dev)
    table = msm.build_fixed_base_table(aff, c=WINDOW)
    sc = limbs(inp["scalars"])  # (16, b, n)
    out = {}
    out["msm_fixed_sharded"] = same("msm_fixed_sharded", g1.xyzz_to_ints(msm_fixed_sharded(table, sc, mesh)),
                                    lambda: g1.xyzz_to_ints(msm.msm_fixed(table, sc)))
    out["msm_sharded"] = same("msm_sharded", g1.xyzz_to_ints(msm_sharded(aff, sc[:, 0], mesh, c=WINDOW)),
                              lambda: g1.xyzz_to_ints(msm.msm_core(aff, sc[:, 0], WINDOW)))
    blobs = _fr_bytes(inp["commit_scalars"], dev)
    out["commit"] = same("commit", g1.affine_to_ints(e4._commit_sharded(blobs, table, bmesh)),
                         lambda: g1.affine_to_ints(e4._commit_body(blobs, table)))
    raw = _fr_bytes(inp["polys"], dev)
    zl = torch.from_numpy(ints_to_limbs(inp["zs"], 16))[:, :, None].to(dev)
    roots = FR.encode(inp["roots"], dev)
    y = e4._eval_sharded(raw, zl, roots, bmesh)
    out["eval"] = same("eval", _ints(y), lambda: _ints(e4._eval_body(raw, zl, roots)))
    pts3 = g1.repeat_batch(aff, 3)
    sc3 = limbs(inp["lincomb_scalars"])
    out["lincomb"] = same("lincomb", g1.affine_to_ints(e4._lincomb_sharded(pts3, sc3, bmesh, c=WINDOW)),
                          lambda: g1.xyzz_to_ints(msm.msm_core(pts3, sc3, WINDOW)))
    x = FR.encode(inp["fft_values"], dev)
    fwd = fft_sharded(x, mesh)
    out["fft"] = same("fft_sharded", _ints(fwd), lambda: _ints(fft_ops.fft(x)))
    out["ifft"] = same("ifft_sharded", _ints(ifft_sharded(x, mesh)), lambda: _ints(fft_ops.ifft(x)))
    same("ifft_sharded(fft_sharded(x))", _ints(ifft_sharded(fwd, mesh)), lambda: _ints(x))
    for name, got, want in checks[dist.get_rank() :: dist.get_world_size()] if references else ():
        if got != want():
            raise AssertionError(f"{name}: the sharded program differs from the single-process one")
    return out


def _ints(t: torch.Tensor) -> list:
    from ..ops.field import limbs_to_ints

    return limbs_to_ints(t)


def dryrun_program(device: str, blob_axis_size: int, references: bool) -> dict:
    """One rank of the dry run: the mesh, the programs and (with
    `references`) its share of the checks, one OK line. `run` holds every
    rank's results against rank 0's."""
    from ..ops import launch
    from .distributed import blobs_mesh, global_mesh

    t0 = time.perf_counter()
    mesh, bmesh = global_mesh(blob_axis_size), blobs_mesh()
    rank = dist.get_rank()
    launch.reset_launches()
    out = toy_checks(device, mesh, bmesh, references)
    out["launches"] = launch.launches()
    out["seconds"] = time.perf_counter() - t0
    checked = "its share of the sharded programs equal their single-process functions" if references else "ran"
    print(f"dryrun rank {rank} of {dist.get_world_size()} on {device} (mesh {tuple(mesh.shape)}): OK, {checked}; "
          f"{out['seconds']:.1f} s; launches {out['launches']}", flush=True)
    return out


def run(n_procs: int, device=None, blob_axis_size=None, out_dir=None, timeout: float = DEFAULT_TIMEOUT,
        references: bool = True) -> list:
    """The dry run on n_procs ranks on `device` (the card when None). The
    mesh is mesh_shape(n_procs, blob_axis_size). Returns each rank's
    results; raises if a rank fails or the ranks disagree. references=False
    skips the single-process references (see toy_checks)."""
    from ..settings import resolve_device

    dev = str(resolve_device(device))
    d_blobs, d_pts = mesh_shape(n_procs, blob_axis_size)
    t0 = time.perf_counter()
    results = launch(dryrun_program, n_procs, dev, (d_blobs, references), out_dir, timeout)
    keys = [k for k in results[0] if k not in ("launches", "seconds")]
    for r, res in enumerate(results):
        if any(res[k] != results[0][k] for k in keys):
            raise RuntimeError(f"dry run: rank {r}'s results differ from rank 0's")
    checked = "equal their single-process functions" if references else "agree on every rank"
    print(f"dryrun OK on {n_procs} ranks (mesh {d_blobs} x {d_pts}, gloo, {dev}): msm_fixed_sharded, msm_sharded, "
          f"the sharded commit, eval and lincomb, fft_sharded and ifft_sharded {checked}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 4, sys.argv[2] if len(sys.argv) > 2 else None)
