"""kzg_tpu_torch's c-kzg-4844 C ABI on the CPU: the ctypes structs and
return codes against the JAX package's c_abi.py; the byte-level host
module against the JAX package's c_abi_host.py (the CKZGSettings payloads
on a small setup, with both registries filled directly, and the batch
challenge's bytes); its length and input checks; the device rule of a C
caller (the card, or $KZG_TPU_TORCH_DEVICE); the shim against the JAX
package's source, and the shim and the C test program built and run with
no device (every load returns ERROR). On the card (marked `gpu`) the C
program runs to its end.

The small setup is 16 points s^i G with 4 field elements a cell (8
columns of 4), over a max_width of 32: the oracle instance's cell_size
is set to the port's, so that the column payloads can agree."""

import ctypes
import os
import struct
import subprocess

import numpy as np
import pytest
import torch

from kzg_tpu import c_abi as jc
from kzg_tpu import c_abi_host as jh
from kzg_tpu.oracle.curve import G2, G2_GENERATOR
from kzg_tpu.oracle.kzg import FFTSettingsOracle, KZGSettingsOracle
from kzg_tpu.settings import DeviceKZGSettings
from kzg_tpu_torch import c_abi as tc
from kzg_tpu_torch import c_abi_build, c_abi_host as th, native, settings
from kzg_tpu_torch.constants import BYTES_PER_BLOB, BYTES_PER_CELL, G1_GENERATOR_X, G1_GENERATOR_Y, R_MOD as R
from kzg_tpu_torch.trusted_setup import TrustedSetup

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP = os.path.join(REPO, "tests", "trusted_setup.txt")
SECRET = 1927409816240961209460912649124
HANDLE = 10**6  # a handle neither registry hands out in this process
G1_GEN = (G1_GENERATOR_X, G1_GENERATOR_Y)


def _points(n, seed):
    return [native.g1_mul(G1_GEN, seed * 1000003 + i) for i in range(n)]


class FourPointCells(settings.TorchKZGSettings):
    cell_size = 4


@pytest.fixture(scope="module")
def handle(tmp_path_factory):
    """HANDLE in both registries: the port's settings on the CPU and the
    JAX package's over the same points (16 monomial points, Lagrange
    points with an infinity, 3 G2 points with an infinity)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path_factory.mktemp("kzg_tpu_torch_cache")))
    g1m = [native.g1_mul(G1_GEN, pow(SECRET, i, R)) for i in range(16)]
    g1l = _points(15, 7) + [None]
    g2m = [G2.mul_scalar(G2_GENERATOR, pow(SECRET, i, R)) for i in range(2)] + [None]
    th._REGISTRY[HANDLE] = FourPointCells(TrustedSetup(g1m, g1l, g2m), torch.device("cpu"), 32)
    jh._REGISTRY[HANDLE] = DeviceKZGSettings(KZGSettingsOracle(FFTSettingsOracle.new(5), g1m, g1l, g2m, cell_size=4))
    yield HANDLE
    th._REGISTRY.pop(HANDLE)
    jh._REGISTRY.pop(HANDLE)
    mp.undo()


# ---- structs and codes --------------------------------------------------


@pytest.mark.parametrize("name", ["Bytes32", "Bytes48", "Blob", "Cell", "KZGCommitment", "KZGProof"])
def test_struct_matches_the_jax_package(name):
    mine, theirs = getattr(tc, name), getattr(jc, name)
    assert ctypes.sizeof(mine) == ctypes.sizeof(theirs)
    assert [(f, ctypes.sizeof(t)) for f, t in mine._fields_] == [(f, ctypes.sizeof(t)) for f, t in theirs._fields_]


@pytest.mark.parametrize("code", ["OK", "BADARGS", "ERROR", "MALLOC"])
def test_return_code_matches_the_jax_package(code):
    assert tc.CKzgRet[code] == jc.CKzgRet[code] == getattr(th, code) == getattr(jh, code)


@pytest.mark.parametrize("exc, want", [(None, tc.CKzgRet.OK), (ValueError, tc.CKzgRet.BADARGS),
                                       (RuntimeError, tc.CKzgRet.ERROR)])
def test_wrap_maps_exceptions_to_codes(exc, want):
    def fn(x):
        if exc is not None:
            raise exc("no")
        return x + 1

    assert tc._wrap(fn)(1) == (want, 2 if exc is None else None)


def test_ctypes_entry_point_maps_an_undecodable_commitment_to_badargs(handle):
    ret, proof = tc.compute_blob_kzg_proof(tc.Blob(), tc.Bytes48(), th._REGISTRY[handle])
    assert (ret, proof) == (tc.CKzgRet.BADARGS, None)


# ---- the host module against the JAX package's --------------------------


def test_settings_arrays_match_the_jax_package(handle):
    ret, arrays = th.settings_arrays(handle)
    jret, jarrays = jh.settings_arrays(handle)
    assert ret == jret == th.OK
    assert [len(a) for a in arrays] == [33 * 32, 32 * 32, 33 * 32, 16 * 144, 16 * 144, 3 * 288, 8 * 4 * 144]
    for mine, theirs in zip(arrays, jarrays):
        assert mine == theirs
    assert th.x_ext_fft_dims(handle) == jh.x_ext_fft_dims(handle) == (8, 4)


def test_unknown_handle():
    assert th.settings_arrays(HANDLE + 1) == jh.settings_arrays(HANDLE + 1) == (th.ERROR, None)
    with pytest.raises(ValueError, match="unknown settings handle"):
        th.x_ext_fft_dims(HANDLE + 1)


def _challenge_inputs(num_commitments, cells_of):
    """Byte inputs of compute_verify_cell_kzg_proof_batch_challenge: the
    commitment index and cell index of each cell."""
    rng = np.random.default_rng(len(cells_of))
    commitments = native.g1_compress_batch(_points(num_commitments, 3))
    proofs = native.g1_compress_batch(_points(len(cells_of), 5))
    cells = b"".join((int.from_bytes(rng.bytes(32), "big") % R).to_bytes(32, "big") for _ in range(64 * len(cells_of)))
    pack = lambda xs: struct.pack(f"<{len(xs)}Q", *xs)
    return (b"".join(commitments), num_commitments, pack([c for c, _ in cells_of]), pack([i for _, i in cells_of]),
            cells, b"".join(proofs), len(cells_of))


@pytest.mark.parametrize("num_commitments, cells_of", [(2, [(0, 5), (1, 77), (0, 127)]), (1, [(0, 0)]), (0, [])],
                         ids=["3 cells", "1 cell", "none"])
def test_batch_challenge_matches_the_jax_package(num_commitments, cells_of):
    args = _challenge_inputs(num_commitments, cells_of)
    ret, r = th.compute_verify_cell_kzg_proof_batch_challenge(*args)
    assert ret == th.OK and len(r) == 32
    assert (ret, r) == jh.compute_verify_cell_kzg_proof_batch_challenge(*args)
    if cells_of:  # another cell index, another challenge
        other = list(args)
        other[3] = struct.pack("<Q", cells_of[0][1] ^ 1) + args[3][8:]
        assert th.compute_verify_cell_kzg_proof_batch_challenge(*other)[1] != r


# ---- input checks -------------------------------------------------------

_CELL, _G = bytes(BYTES_PER_CELL), b"\xc0" + bytes(47)


@pytest.mark.parametrize("call", [
    lambda h: th.verify_blob_kzg_proof_batch(bytes(BYTES_PER_BLOB), _G, _G[:47], 1, h),
    lambda h: th.verify_blob_kzg_proof_batch(None, None, None, 1, h),
    lambda h: th.recover_cells_and_kzg_proofs(bytes(8), _CELL[:-1], 1, h),
    lambda h: th.recover_cells_and_kzg_proofs(bytes(7), _CELL, 1, h),
    lambda h: th.compute_verify_cell_kzg_proof_batch_challenge(_G, 2, bytes(8), bytes(8), _CELL, _G, 1),
    lambda h: th.compute_verify_cell_kzg_proof_batch_challenge(_G, 1, bytes(8), bytes(8), _CELL, _G + _G, 1),
    lambda h: th.verify_cell_kzg_proof_batch(_G, bytes(16), _CELL, _G, 1, h),
    lambda h: th.verify_cell_kzg_proof_batch(_G, bytes(8), _CELL + b"\x00", _G, 1, h),
], ids=["blob batch: proofs", "blob batch: none", "recover: cells", "recover: indices", "challenge: commitments",
        "challenge: proofs", "verify cells: indices", "verify cells: cells"])
def test_length_checks_return_badargs(handle, call):
    assert call(handle)[0] == th.BADARGS


@pytest.mark.parametrize("call", [
    lambda h: th.compute_blob_kzg_proof(bytes(BYTES_PER_BLOB), b"\xff" * 48, h),
    lambda h: th.verify_kzg_proof(b"\xff" * 48, bytes(32), bytes(32), _G, h),
    lambda h: th.verify_kzg_proof(_G, b"\xff" * 32, bytes(32), _G, h),
    lambda h: th.blob_to_kzg_commitment(bytes(BYTES_PER_BLOB - 1), h),
    lambda h: th.compute_kzg_proof(bytes(BYTES_PER_BLOB), b"\xff" * 32, h),
], ids=["undecodable commitment", "undecodable commitment (verify)", "non-canonical z", "short blob",
        "non-canonical z (prove)"])
def test_bad_inputs_return_badargs(handle, call):
    assert call(handle)[0] == th.BADARGS


@pytest.mark.parametrize("contents", [b"4096 65\ndeadbeef not-a-point\n", b"\xff\xfe"], ids=["malformed", "not ascii"])
def test_malformed_setup_contents_return_badargs(contents):
    assert th.load_trusted_setup_contents(contents) == (th.BADARGS, 0)


def test_load_without_a_card_returns_error(monkeypatch):
    """No card and no $KZG_TPU_TORCH_DEVICE: ERROR, and nothing is
    registered (nothing runs on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KZG_TPU_TORCH_DEVICE", raising=False)
    before = dict(th._REGISTRY)
    assert th.load_trusted_setup_file(SETUP) == (th.ERROR, 0)
    assert th._REGISTRY == before


def test_load_on_the_named_device(monkeypatch):
    """$KZG_TPU_TORCH_DEVICE=cpu puts the settings on the CPU; freeing
    the handle drops them."""
    monkeypatch.setenv("KZG_TPU_TORCH_DEVICE", "cpu")
    ret, h = th.load_trusted_setup_file(SETUP)
    assert ret == th.OK and h > 0
    s = th._REGISTRY[h]
    assert s.device == torch.device("cpu") and s.max_width == 8192 and len(s.setup.g1_monomial) == 4096
    th.free_trusted_setup(h)
    assert h not in th._REGISTRY


# ---- the shim and the C program -----------------------------------------


def _code_lines(path, module):
    """The source's lines without comments or blank lines, the imported
    module's name replaced by a placeholder."""
    with open(path) as f:
        text = f.read()
    assert text.count(f'PyImport_ImportModule("{module}")') == 1
    lines = (line.split("//")[0].rstrip() for line in text.replace(f'"{module}"', '"MODULE"').splitlines())
    return [line for line in lines if line]


def test_shim_is_the_jax_packages_apart_from_the_module():
    port = _code_lines(os.path.join(REPO, "kzg_tpu_torch", "csrc", "c_abi_shim.cpp"), "kzg_tpu_torch.c_abi_host")
    assert port == _code_lines(os.path.join(REPO, "native", "c_abi_shim.cpp"), "kzg_tpu.c_abi_host")


def test_c_program_embeds_the_port_and_refuses_the_cpu():
    """The shim and the unmodified C program build against this
    interpreter; run with no card visible and no device named, the
    embedded port answers a NULL argument with BADARGS and refuses every
    load (ERROR), so the program stops after its first real load."""
    lib, program = c_abi_build.build()
    assert os.path.dirname(lib) == os.path.dirname(program) == c_abi_build.build_dir()
    env = c_abi_build.program_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("KZG_TPU_TORCH_DEVICE", None)
    out = subprocess.run([program, SETUP], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "ok: load_trusted_setup(NULL) -> BADARGS" in out.stdout
    assert "ok: malformed setup file -> BADARGS" in out.stdout
    assert out.stdout.rstrip().endswith("FAIL: load_trusted_setup(bytes)")


@pytest.mark.gpu
def test_c_program_passes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = c_abi_build.run_test_program(timeout=1800)
    assert out.returncode == 0 and "ALL C ABI TESTS PASSED" in out.stdout, out.stdout[-4000:] + out.stderr[-4000:]
