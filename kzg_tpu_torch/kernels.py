"""Build and load the package's CUDA kernels (csrc/*.cu) for sm_90a.

The kernels have a plain C interface and are bound with ctypes: pointers
come from `Tensor.data_ptr()`, the stream from
`torch.cuda.current_stream().cuda_stream`. Each source is its own shared
library, and `nvcc` compiles them all at once (one process per source) at
first use into `build/kernels/` beside the package (ignored by git), each
under a name that carries a hash of its source, the headers and the flags,
so an edited source is built anew. A build goes to a temporary name and is
moved into place, so processes that build at the same time do not see a
partial library.

Nothing here runs at import: the CPU tests import every module of the
package on machines without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from types import SimpleNamespace
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("msm_kernels.cu", "fft_kernels.cu", "gather_kernels.cu")
HEADERS = ("field.cuh", "g1.cuh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every launcher: (argument types, source)
SIGNATURES = {
    "kzg_seg_scan_phase1": ([_p] * 7 + [_i, _i, _p], "msm_kernels.cu"),
    "kzg_add_unified": ([_p] * 12 + [_i, _p], "msm_kernels.cu"),
    "kzg_horner": ([_p] * 8 + [_i, _i, _i, _p], "msm_kernels.cu"),
    "kzg_ntt_tile": ([_p] * 4 + [_i, _ll, _p], "fft_kernels.cu"),
    "kzg_ntt_stage": ([_p] * 3 + [_i, _i, _ll, _p], "fft_kernels.cu"),
    "kzg_gather_rows": ([_p] * 4 + [_ll, _ll, _i, _p], "gather_kernels.cu"),
}

_lock = threading.Lock()
_lib: Optional[SimpleNamespace] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def library_path(source: str) -> str:
    stem = source.rsplit(".", 1)[0]
    return os.path.join(BUILD_DIR, f"libkzg_{stem}.{_digest(source)}.so")


def build() -> str:
    """Compile every source not built yet in this version, one nvcc process
    per source, all started together. Returns the compiler's reports
    (`-Xptxas -v`: registers, spills), empty when everything was built
    already. Raises RuntimeError if nvcc fails."""
    todo = [s for s in SOURCES if not os.path.exists(library_path(s))]
    if not todo:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = f"{library_path(src)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
        procs.append((src, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(src))
        with open(library_path(src) + ".ptxas.txt", "w") as f:
            f.write(out)
        reports.append(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(reports)


def load() -> SimpleNamespace:
    """The kernel launchers, built on first use, with their C signatures:
    one attribute per launcher, whichever library holds it."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            libs = {s: ctypes.CDLL(library_path(s)) for s in SOURCES}
            fns = {}
            for name, (argtypes, src) in SIGNATURES.items():
                fn = getattr(libs[src], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = SimpleNamespace(**fns)
        return _lib
