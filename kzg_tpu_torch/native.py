"""ctypes binding to the repository's host C++ core (native/kzg_native.cpp):
point codecs with subgroup checks, the pairing check and small G1 ops.

The library is built from the committed source and header with the flags of
native/build.sh, into `build/native/` beside the package (ignored by git),
at first use, under a name that carries a hash of the sources, the flags
and the host CPU.
The committed prebuilt binary is never loaded: it was compiled with
-march=native on another host. Processes that build at once serialise on a lock file
and the library is moved into place whole. A failed build raises; there is
no fallback. Each function that calls into the library is the span
`kzg.native.<function>` (tracing.py).
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

from .tracing import span

Affine = Optional[Tuple[int, int]]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_REPO, "native")
_SOURCES = ("kzg_native.cpp", "constants.h")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_VERSION = 5

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags: -march=native code built on
    one CPU may not run on another, so the build is keyed on them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(l for l in f if l.startswith((b"model name", b"flags")))
    except OSError:
        return b""


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_cpu())
    for name in _SOURCES:
        with open(os.path.join(_NATIVE, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libkzg_native.{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the host core if this version is not built yet; returns the
    library's path. Raises RuntimeError if the compiler fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return path
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler found to build native/kzg_native.cpp")
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-I", _NATIVE, "-o", tmp, os.path.join(_NATIVE, "kzg_native.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native core failed:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.kzgn_version.restype = ctypes.c_int
            if lib.kzgn_version() != _VERSION:
                raise RuntimeError(f"native core version {lib.kzgn_version()}, expected {_VERSION}")
            c, i, sz = ctypes.c_char_p, ctypes.c_int, ctypes.c_size_t
            lib.kzgn_g1_decompress_batch.argtypes = [c, sz, i, c, c]
            lib.kzgn_g1_decompress_batch.restype = ctypes.c_long
            lib.kzgn_g2_decompress_batch.argtypes = [c, sz, i, c, c]
            lib.kzgn_g2_decompress_batch.restype = ctypes.c_long
            lib.kzgn_g1_compress_batch.argtypes = [c, c, sz, c]
            lib.kzgn_g1_compress_batch.restype = ctypes.c_long
            lib.kzgn_pairings_verify.argtypes = [c, i, c, i, c, i, c, i]
            lib.kzgn_pairings_verify.restype = i
            lib.kzgn_g1_mul.argtypes = [c, i, c, c]
            lib.kzgn_g1_mul.restype = i
            lib.kzgn_g1_add.argtypes = [c, i, c, i, c]
            lib.kzgn_g1_add.restype = i
            _lib = lib
        return _lib


def _xy_to_point(xy: bytes, inf: int) -> Affine:
    if inf:
        return None
    return (int.from_bytes(xy[:48], "big"), int.from_bytes(xy[48:96], "big"))


def _point_to_xy(pt: Affine) -> Tuple[bytes, int]:
    if pt is None:
        return bytes(96), 1
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big"), 0


def _g2_to_bytes_raw(pt) -> Tuple[bytes, int]:
    if pt is None:
        return bytes(192), 1
    x, y = pt
    return x[0].to_bytes(48, "big") + x[1].to_bytes(48, "big") + y[0].to_bytes(48, "big") + y[1].to_bytes(48, "big"), 0


@span("kzg.native.g1_decompress_batch")
def g1_decompress_batch(compressed: bytes, subgroup_check: bool = True) -> List[Affine]:
    """48n bytes -> affine points (None = infinity). Raises ValueError
    naming the first invalid point."""
    n = len(compressed) // 48
    if len(compressed) != 48 * n:
        raise ValueError("g1: expected 48-byte compressed points")
    out = ctypes.create_string_buffer(96 * n)
    infs = ctypes.create_string_buffer(n)
    rc = _load().kzgn_g1_decompress_batch(compressed, n, int(subgroup_check), out, infs)
    if rc:
        raise ValueError(f"g1: invalid point at index {rc - 1}")
    raw = out.raw
    return [_xy_to_point(raw[96 * i : 96 * (i + 1)], infs.raw[i]) for i in range(n)]


@span("kzg.native.g2_decompress_batch")
def g2_decompress_batch(compressed: bytes, subgroup_check: bool = True) -> list:
    n = len(compressed) // 96
    if len(compressed) != 96 * n:
        raise ValueError("g2: expected 96-byte compressed points")
    out = ctypes.create_string_buffer(192 * n)
    infs = ctypes.create_string_buffer(n)
    rc = _load().kzgn_g2_decompress_batch(compressed, n, int(subgroup_check), out, infs)
    if rc:
        raise ValueError(f"g2: invalid point at index {rc - 1}")
    pts = []
    for i in range(n):
        if infs.raw[i]:
            pts.append(None)
            continue
        b = out.raw[192 * i : 192 * (i + 1)]
        x = (int.from_bytes(b[:48], "big"), int.from_bytes(b[48:96], "big"))
        y = (int.from_bytes(b[96:144], "big"), int.from_bytes(b[144:192], "big"))
        pts.append((x, y))
    return pts


@span("kzg.native.g1_compress_batch")
def g1_compress_batch(points: List[Affine]) -> List[bytes]:
    n = len(points)
    xy = bytearray(96 * n)
    infs = bytearray(n)
    for i, p in enumerate(points):
        b, inf = _point_to_xy(p)
        xy[96 * i : 96 * (i + 1)] = b
        infs[i] = inf
    out = ctypes.create_string_buffer(48 * n)
    rc = _load().kzgn_g1_compress_batch(bytes(xy), bytes(infs), n, out)
    if rc:
        raise ValueError(f"g1: invalid affine coordinates at index {rc - 1}")
    return [out.raw[48 * i : 48 * (i + 1)] for i in range(n)]


@span("kzg.native.pairings_verify")
def pairings_verify(a1: Affine, a2, b1: Affine, b2) -> bool:
    """e(a1, a2) == e(b1, b2)."""
    a1b, a1i = _point_to_xy(a1)
    b1b, b1i = _point_to_xy(b1)
    a2b, a2i = _g2_to_bytes_raw(a2)
    b2b, b2i = _g2_to_bytes_raw(b2)
    rc = _load().kzgn_pairings_verify(a1b, a1i, a2b, a2i, b1b, b1i, b2b, b2i)
    if rc < 0:
        raise ValueError("pairings_verify: malformed input")
    return rc == 1


@span("kzg.native.g1_mul")
def g1_mul(pt: Affine, scalar: int) -> Affine:
    b, inf = _point_to_xy(pt)
    out = ctypes.create_string_buffer(96)
    rc = _load().kzgn_g1_mul(b, inf, (scalar % (1 << 256)).to_bytes(32, "big"), out)
    if rc < 0:
        raise ValueError("g1_mul: malformed input")
    return None if rc == 1 else _xy_to_point(out.raw, 0)


@span("kzg.native.g1_add")
def g1_add(p: Affine, q: Affine) -> Affine:
    pb, pi = _point_to_xy(p)
    qb, qi = _point_to_xy(q)
    out = ctypes.create_string_buffer(96)
    rc = _load().kzgn_g1_add(pb, pi, qb, qi, out)
    if rc < 0:
        raise ValueError("g1_add: malformed input")
    return None if rc == 1 else _xy_to_point(out.raw, 0)
