"""Gather probe: ways to gather the MSM's point rows on one card. The
counterpart of the JAX package's benches/gather_micro.py.

    python3 -m kzg_tpu_torch.benches.gather_micro [variant ...]

Probe shape (as the JAX script's): a seeded random table of ROWS = 81,920
rows of 24 32-bit words (96 bytes: 20 windows x 4096 points), E = 655,360
indices (8 blobs x 20 windows x 4096).

  row_raw   Tensor.index_select of whole rows: the library call
  row       the same gather, then the transpose to (24, E) and the unpack
            into 16-bit limbs, (48, E)
  pad32     rows padded to 32 words (128 bytes)
  pad128    rows padded to 128 words (512 bytes)
  lane      the gather along the minor axis of the (24, ROWS) transpose
  one       one word per row: the cost per row on its own
  onehot    per window block of 4096 elements, a one-hot (4096 x 4096)
            product with the byte view of the window's 4096-row slice, as
            an fp16 torch.matmul on the tensor cores. Exact: every byte is
            at most 255 and each output sums one term. A variant of the
            probe, not a kernel of the port
  dg        kernel B6 at the probe's shape: rows of one 4096-row slice
            (index mod 4096), what the TPU's pallas_dg computed
  dg_msm    kernel B6 at the MSM's own shape: the port's 25-word rows
            [x | y | inf] (163,840 rows, 16.4 MB) at the sorted row
            indices that phase1_inputs gives at batch 8 (loads the mainnet
            setup and builds its table)
  row_raw_msm  index_select at that shape

Each variant's output is checked against index_select once. Times are
device ms from CUDA events over 20 launches after a warm one; GB/s counts
the useful bytes (96 per element; 4 for `one`, 100 at the MSM's shape).
Kernel B6's bound is its bytes over the card's 3.35 TB/s: each output word
written once, each index read once, each row the indices touch read once.
Prints the card's name and power limit and a JSON line. Without a card it
exits non-zero.
"""

import json
import sys

import numpy as np
import torch

from ..ops import cuda_gather
from . import common

ROWS = 81920  # 20 windows x 4096 points
E = 655360  # 8 blobs x 20 windows x 4096
N = 4096  # one window's slice
WORDS = 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
REPS = 20
VARIANTS = ("row_raw", "row", "pad32", "pad128", "lane", "one", "onehot", "dg", "dg_msm", "row_raw_msm")


def make_probe(device, seed: int = 0) -> dict:
    """The probe's seeded inputs on `device`: the table (int32 bit patterns
    of random u32 words), random row indices, and the per-window-block
    indices of the one-hot variant."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 2**32, (ROWS, WORDS), dtype=np.uint32).view(np.int32)
    src = rng.integers(0, ROWS, E, dtype=np.int32)
    srcb = rng.integers(0, N, (E // N, N), dtype=np.int32)
    t = {k: torch.from_numpy(v).to(device) for k, v in (("tab", tab), ("src", src), ("srcb", srcb))}
    t["slice"], t["src_mod"] = t["tab"][:N], t["src"] % N
    return t


def msm_probe(table, batch: int = 8, seed: int = 42) -> dict:
    """B6's inputs at the MSM's shape: the packed 25-word rows of the
    fixed-base table and the sorted row indices of one batch's scan (as
    kernel B1 reads them, step-major)."""
    from ..ops import msm as dmsm

    rng = np.random.default_rng(seed)
    n = table.n
    sc = torch.from_numpy(common.random_scalars(rng, batch * n).reshape(16, batch, n)).to(table.x.device)
    rows, idx, _ = dmsm.phase1_inputs(table, sc)
    return {"rows": rows, "idx": idx.reshape(-1)}


def bound_ms(width: int, idx: torch.Tensor) -> float:
    """B6's bound in ms: the output written once, the indices read once and
    every row the indices touch read once, over 3.35 TB/s."""
    rows = torch.unique(idx).numel()
    nbytes = idx.numel() * width * 4 + idx.numel() * 4 + rows * width * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def dg(p: dict, flag=None) -> torch.Tensor:
    """Kernel B6 at the probe's shape (one launch)."""
    return cuda_gather.gather_rows(p["slice"], p["src_mod"], flag)


def _unpack16(g: torch.Tensor) -> torch.Tensor:
    """(E, 24) words -> (48, E) 16-bit limbs, low half first."""
    g = g.T
    return torch.stack([g & 0xFFFF, (g >> 16) & 0xFFFF], dim=1).reshape(2 * g.shape[0], g.shape[1])


def onehot(p: dict) -> torch.Tensor:
    """The one-hot product, 20 window blocks at a time (671 MB of one-hot
    matrices per group): block b gathers from window b mod 20."""
    tab, srcb = p["tab"], p["srcb"]
    wins = ROWS // N
    tb = tab.reshape(wins, N, WORDS).contiguous().view(torch.uint8).reshape(wins, N, 4 * WORDS).half()
    cols = torch.arange(N, dtype=torch.int32, device=tab.device)
    out = []
    for g0 in range(0, srcb.shape[0], wins):
        oh = (srcb[g0 : g0 + wins, :, None] == cols).half()  # (20, N, N)
        out.append(torch.matmul(oh, tb).to(torch.uint8).view(torch.int32).reshape(-1, WORDS))
    return torch.cat(out)


def _variants(p: dict, flag) -> dict:
    """name -> (launch, expected output, useful bytes)."""
    tab, src = p["tab"], p["src"]
    ref = tab.index_select(0, src)
    pad32 = torch.nn.functional.pad(tab, (0, 32 - WORDS))
    pad128 = torch.nn.functional.pad(tab, (0, 128 - WORDS))
    tab_t = tab.T.contiguous()
    first = tab[:, 0].contiguous()
    wins = ROWS // N
    blocks = torch.arange(p["srcb"].shape[0], device=tab.device)[:, None] % wins
    ref_onehot = tab.index_select(0, (blocks * N + p["srcb"]).reshape(-1))
    out = {
        "row_raw": (lambda: tab.index_select(0, src), ref, E * 96),
        "row": (lambda: _unpack16(tab.index_select(0, src)), _unpack16(ref), E * 96),
        "pad32": (lambda: pad32.index_select(0, src), torch.nn.functional.pad(ref, (0, 8)), E * 96),
        "pad128": (lambda: pad128.index_select(0, src), torch.nn.functional.pad(ref, (0, 104)), E * 96),
        "lane": (lambda: tab_t.index_select(1, src), ref.T, E * 96),
        "one": (lambda: first.index_select(0, src), ref[:, 0], E * 4),
        "onehot": (lambda: onehot(p), ref_onehot, E * 96),
        "dg": (lambda: dg(p, flag), p["slice"].index_select(0, p["src_mod"]), E * 96),
    }
    if "rows" in p:
        rows, idx = p["rows"], p["idx"]
        ref_m = rows.index_select(0, idx)
        out["dg_msm"] = (lambda: cuda_gather.gather_rows(rows, idx, flag), ref_m, idx.numel() * 100)
        out["row_raw_msm"] = (lambda: rows.index_select(0, idx), ref_m, idx.numel() * 100)
    return out


def run(p: dict, names=VARIANTS) -> dict:
    """Check and time the named variants on the probe `p`. Returns name ->
    {"ms", "gb_per_s"}, and B6's bounds."""
    flag = cuda_gather.new_flag(p["tab"].device)
    variants = _variants(p, flag)
    results = {}
    for name in names:
        if name not in variants:
            continue
        fn, want, useful = variants[name]
        got = fn()
        if not torch.equal(got, want):
            raise RuntimeError(f"gather probe: variant {name} differs from index_select")
        ms = common.device_ms(fn, REPS)
        results[name] = {"ms": ms, "gb_per_s": useful / ms / 1e6}
        print(f"{name:12s}: {ms:8.4f} ms  ({useful / ms / 1e6:7.1f} GB/s)", flush=True)
    cuda_gather.raise_if_flagged(flag)
    results["dg_bound_ms"] = bound_ms(WORDS, p["src_mod"])
    if "idx" in p:
        results["dg_msm_bound_ms"] = bound_ms(25, p["idx"])
    return results


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not common.require_card("gather_micro"):
        return 2
    card = common.card_line()
    print(f"card: {card}")
    p = make_probe(torch.device("cuda"))
    if {"dg_msm", "row_raw_msm"} & set(names):
        from .. import api

        s = api.load_trusted_setup_file()
        p.update(msm_probe(s.lagrange_table))
    res = run(p, names)
    print(f"B6 bound: probe {res['dg_bound_ms']:.4f} ms" +
          (f", MSM shape {res['dg_msm_bound_ms']:.4f} ms" if "dg_msm_bound_ms" in res else "") + f" [{card}]")
    print(json.dumps({"card": card, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
