"""Compile-time choices of kernels B1 and B4, measured on one card.

    python3 -m kzg_tpu_torch.benches.kernel_variants

Each variant is the package's CUDA source with one or two constants set
otherwise, built with the package's nvcc flags into build/kernels/variants/
(its registers and spills printed from ptxas), checked limb for limb
against the package's own build on the same inputs, and timed (device ms
from CUDA events, after a warm launch):

  B1  scan::GROUP (warps on a block's 32 chunk lanes) and
      scan::BLOCKS_PER_SM (the occupancy __launch_bounds__ asks for, which
      caps the registers), at the 64-blob scan of the main path (K = 160,
      32,768 lanes; loads the mainnet setup and builds its table)
  B4  LOG_SUB (values a block holds; a tile of 2^11 is a cluster of
      2^(11 - LOG_SUB) blocks; 2^9 needs more than the 48 KB of static
      shared memory a block may have, 2^7 a cluster of 16, which is not
      portable), at the three launches of one 16-blob cells call: the
      inverse 4096 and forward 8192 of 16 transforms, the forward 128 of
      1,024

Then, timing only, each kernel with one part taken out (results wrong, so
not checked), to show where its time goes: B4 with the gather in natural
order, without pass A's products, without pass B, without pass B's
products; B1 without its stores and without
its selects, and with rounds 2 and 3 taking no products.

Prints the card's name and power limit and a JSON line per variant.
Without a card it exits non-zero.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import kernels
from ..ops import cuda_fft, cuda_msm, launch, msm
from . import common

# (kernel, source, {constant: value}); the first of each kernel is the package's own
VARIANTS = [
    ("B1", "msm_kernels.cu", {"GROUP": 3, "BLOCKS_PER_SM": 8}),
    ("B1", "msm_kernels.cu", {"GROUP": 2, "BLOCKS_PER_SM": 8}),
    ("B1", "msm_kernels.cu", {"GROUP": 4, "BLOCKS_PER_SM": 6}),
    ("B1", "msm_kernels.cu", {"GROUP": 3, "BLOCKS_PER_SM": 6}),
    ("B4", "fft_kernels.cu", {"LOG_SUB": 8}),
]
# (kernel, source, what is taken out, [(text, replacement)]): timing only
PARTS_OUT = [
    ("B4", "fft_kernels.cu", "bit reversal of the small transforms' and the tile's gathers", [
        ("const unsigned src = __brev(p0 + (unsigned)i) >> (32 - log_n);", "const unsigned src = p0 + (unsigned)i;"),
        ("const unsigned k = __brev(((unsigned)rank << log_sub) + i) >> (32 - log_tile);",
         "const unsigned k = ((unsigned)rank << log_sub) + i;")]),
    ("B4", "fft_kernels.cu", "pass A's products", [
        ("if (s > 0) y = rmul(y, load_words(tws, SUB / 2, j << (log_sub - 1 - s)));", "")]),
    ("B4", "fft_kernels.cu", "pass B", [("    if (log_c == 0) {\n        for (int i = tid; i < sub;", "    if (true) {\n        for (int i = tid; i < sub;")]),
    ("B4", "fft_kernels.cu", "pass B's products", [
        ("Fr y = rmul(load_words(vb, SUB, iu), twb[s2]);", "Fr y = load_words(vb, SUB, iu);")]),
    ("B1", "msm_kernels.cu", "the stores", [("if (t > 0 && live)\n", "if (false)\n"), ("    if (live)\n        for (int c = warp;", "    if (false)\n        for (int c = warp;")]),
    ("B1", "msm_kernels.cu", "the selects", [
        ("                sst(S, SX + k, lane, select(S, k, q, lane));\n                zz1 = select(S, SZZ + k, q, lane);",
         "                zz1 = sld(S, SZZ + k, lane);")]),
    ("B1", "msm_kernels.cu", "the products of rounds 2 and 3", [
        ("lane, fmul(a, sld(S, PP, lane)));", "lane, fsub(a, sld(S, PP, lane)));"),
        ("sst(S, k == 0 ? Y3A : k == 1 ? SP : W3, lane, fmul(a, c));", "sst(S, k == 0 ? Y3A : k == 1 ? SP : W3, lane, fsub(a, c));")]),
]
ENTRY = {"B1": "seg_scan_phase1_kernel", "B4": "ntt_tile_kernel"}
LAUNCHER = {"B1": "kzg_seg_scan_phase1", "B4": "kzg_ntt_tile"}


def build_variant(source: str, consts: dict, edits=(), tag=None):
    """(ctypes library, ptxas report) of `source` with the constants set
    and each (text, replacement) of `edits` made."""
    with open(os.path.join(kernels._CSRC, source)) as f:
        text = f.read()
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{source}: constant {name} found {n} times")
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{source}: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    tag = tag or "_".join(f"{k}{v}" for k, v in consts.items())
    out_dir = os.path.join(kernels.BUILD_DIR, "variants", f"{source.rsplit('.', 1)[0]}_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, source)
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, "lib.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels._CSRC, "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib), proc.stdout + proc.stderr


def ptxas_lines(report: str, entry: str) -> str:
    """The registers and spills ptxas reports for the entry function."""
    lines, on = [], False
    for line in report.splitlines():
        if "Compiling entry" in line:
            on = entry in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines)


def b1_inputs(dev):
    from .. import api
    from ..bench import make_inputs

    table = api.load_trusted_setup_file().lagrange_table
    scalars = make_inputs(4096, 64, 1, dev, seed=4844)[0]
    return msm.phase1_inputs(table, scalars)


def b4_inputs(dev):
    rng = np.random.default_rng(4844)
    cases = []
    for B, n, inverse in ((16, 4096, True), (16, 8192, False), (1024, 128, False)):
        x = torch.from_numpy(common.random_scalars(rng, B * n).reshape(16, B, n)).to(dev)
        cases.append((f"{'ifft' if inverse else 'fft'} {n} x {B}", x, inverse))
    return cases


def _launcher(lib, kernel):
    fn = getattr(lib, LAUNCHER[kernel])
    fn.argtypes, fn.restype = kernels.SIGNATURES[LAUNCHER[kernel]][0], ctypes.c_int
    return fn


def run_b1(fn, inputs):
    rows, idx, first = inputs
    K, m = idx.shape
    want = cuda_msm.seg_scan_phase1_mem(rows, idx, first)
    out = [torch.empty_like(want.x) for _ in range(4)]

    def call():
        rc = fn(rows.data_ptr(), idx.data_ptr(), first.data_ptr(), *(o.data_ptr() for o in out), K, m, launch.stream())
        launch.check_launch(rc, "seg_scan_phase1 variant")

    call()
    exact = all(torch.equal(a, b) for a, b in zip(out, want))
    return {"exact": exact, "ms": common.device_ms(call, 10)}


def run_b4(fn, cases):
    res = {"exact": True}
    for label, x, inverse in cases:
        B, n = x.shape[1:]
        log_n = n.bit_length() - 1
        dev = str(x.device)
        want = cuda_fft.ntt_tile(x, inverse)
        out = torch.empty_like(x)
        tw = cuda_fft._twiddle_words(log_n, inverse, dev)
        scale = cuda_fft._n_inv(log_n, dev, True) if inverse else None

        def call():
            rc = fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(), None if scale is None else scale.data_ptr(),
                    log_n, B * n, launch.stream())
            launch.check_launch(rc, "ntt_tile variant")

        call()
        res["exact"] &= torch.equal(out, want)
        res[label] = common.device_ms(call, 20, queue_ahead=True)
    res["ms"] = sum(v for k, v in res.items() if k not in ("exact",))
    return res


def main() -> int:
    if not common.require_card("kernel_variants"):
        return 2
    card = common.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    kernels.build()
    inputs = {"B1": b1_inputs(dev), "B4": b4_inputs(dev)}
    ok = True
    for kernel, source, consts in VARIANTS:
        lib, report = build_variant(source, consts)
        res = (run_b1 if kernel == "B1" else run_b4)(_launcher(lib, kernel), inputs[kernel])
        res.update(kernel=kernel, variant=consts, ptxas=ptxas_lines(report, ENTRY[kernel]), card=card)
        ok &= res["exact"]
        print(json.dumps(res), flush=True)
    for i, (kernel, source, label, edits) in enumerate(PARTS_OUT):
        lib, _ = build_variant(source, {}, edits, tag=f"{kernel}_out{i}")
        res = (run_b1 if kernel == "B1" else run_b4)(_launcher(lib, kernel), inputs[kernel])
        del res["exact"]  # a part is missing: the result is wrong by design
        res.update(kernel=kernel, without=label, card=card)
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
