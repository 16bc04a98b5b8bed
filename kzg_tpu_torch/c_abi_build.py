"""Build and run the port's c-kzg-4844 C ABI.

The shim (csrc/c_abi_shim.cpp) embeds CPython and calls
kzg_tpu_torch.c_abi_host; g++ builds it into libckzg_tpu.so against the
interpreter that runs the build (its headers and its shared libpython),
with the repo root compiled in. The repository's C test program
(native/test_c_abi.c, unmodified) is then built with gcc and linked
against that library with an rpath to it. Both go into
build/abi/<key>/, the key a hash of the sources, the flags, the repo
root and the interpreter, so a stale or foreign build is never used; the
build happens at first use, serialised by a lock file, and the directory
is moved into place whole.

    python3 -m kzg_tpu_torch.c_abi_build   # build, then run the C program on the mainnet setup

The program runs on the card, or where $KZG_TPU_TORCH_DEVICE names
another device (`cpu`: exact, but slow).
"""

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from typing import Optional, Tuple

from . import settings

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_REPO, "native")
_SHIM = os.path.join(_REPO, "kzg_tpu_torch", "csrc", "c_abi_shim.cpp")
_SOURCES = (_SHIM, os.path.join(_NATIVE, "ckzg_tpu.h"), os.path.join(_NATIVE, "test_c_abi.c"))
BUILD_DIR = os.path.join(_REPO, "build", "abi")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
CC_FLAGS = ["-O2", "-std=c11"]
LIBRARY, PROGRAM = "libckzg_tpu.so", "test_c_abi"


def _python() -> Tuple[str, str, str]:
    """(include directory, library directory, library name) of the running
    interpreter. Raises RuntimeError when it cannot be embedded in a
    shared library: no Python.h, or no shared libpython."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    if not os.path.isfile(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"{sys.executable} has no Python.h under {inc}: the C ABI shim cannot be built")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError(f"{sys.executable} was built without a shared libpython: the C ABI shim cannot embed it")
    return inc, libdir, "python" + sysconfig.get_config_var("LDVERSION")


def build_dir() -> str:
    """build/abi/<key>: the directory this interpreter's build lives in."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + CC_FLAGS + [_REPO, sys.executable, sys.version]).encode())
    h.update(repr(_python()).encode())
    for path in _SOURCES:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16])


def build() -> Tuple[str, str]:
    """Build the library and the C program if this version is not built
    yet; returns their paths. Raises RuntimeError if a compiler fails or
    the interpreter cannot be embedded."""
    out = build_dir()
    paths = os.path.join(out, LIBRARY), os.path.join(out, PROGRAM)
    if os.path.isdir(out):
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isdir(out):  # another process built it meanwhile
            return paths
        cxx, cc = shutil.which("g++"), shutil.which("gcc")
        if cxx is None or cc is None:
            raise RuntimeError("g++ and gcc are needed to build the C ABI")
        inc, libdir, lib = _python()
        tmp = f"{out}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        steps = [
            [cxx, *CXX_FLAGS, "-I", inc, "-I", _NATIVE, f'-DKZG_TPU_DEFAULT_ROOT="{_REPO}"',
             "-o", os.path.join(tmp, LIBRARY), _SHIM, "-L", libdir, f"-Wl,-rpath,{libdir}", f"-l{lib}"],
            # the program finds the library where the directory will be
            [cc, *CC_FLAGS, "-I", _NATIVE, "-o", os.path.join(tmp, PROGRAM), os.path.join(_NATIVE, "test_c_abi.c"),
             "-L", tmp, f"-Wl,-rpath,{out}", "-lckzg_tpu"],
        ]
        for cmd in steps:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(f"building the C ABI failed: {' '.join(cmd)}\n{proc.stderr}")
        os.rename(tmp, out)
    return paths


def program_env() -> dict:
    """The environment for a process that loads the library: its embedded
    interpreter gets this interpreter's home and module path (so it imports
    the same torch and numpy) and this process's table cache directory (so
    it reads the tables built here instead of building them again)."""
    env = dict(os.environ)
    home = sys.base_prefix if sys.base_exec_prefix == sys.base_prefix else f"{sys.base_prefix}:{sys.base_exec_prefix}"
    env["PYTHONHOME"] = home
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    env["KZG_TPU_PYROOT"] = _REPO
    env["KZG_TPU_TORCH_CACHE_DIR"] = settings.cache_dir()
    return env


def run_test_program(setup_path: Optional[str] = None, timeout: Optional[float] = None) -> subprocess.CompletedProcess:
    """Build if needed, then run the C test program on a trusted setup file
    (the mainnet setup when None); returns the finished process, its
    output captured. The program prints ALL C ABI TESTS PASSED and exits
    0 when every check passes."""
    _, program = build()
    return subprocess.run(
        [program, setup_path or settings.trusted_setup_path()],
        capture_output=True, text=True, env=program_env(), timeout=timeout,
    )


def main() -> int:
    proc = run_test_program()
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
