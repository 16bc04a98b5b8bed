"""Package-level properties of kzg_tpu_torch: it imports nothing of JAX or
of the JAX package, its entry points refuse to run on the CPU unless asked
to, its kernel wrappers check their inputs and never fall back, its caches
round-trip; and the kernels against their plain versions on a card
(marked `gpu`, skipped without one)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kzg_tpu_torch import api, convert, kernels, settings
from kzg_tpu_torch.ops import cuda_fft, cuda_gather, cuda_msm, g1, launch, msm
from kzg_tpu_torch.ops.field import FR
from kzg_tpu_torch.ops.field import ints_to_limbs

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP = os.path.join(REPO, "tests", "trusted_setup.txt")

_GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None       # any import of jax raises ImportError
sys.modules["kzg_tpu"] = None   # and so does any import of the JAX package
sys.path.insert(0, sys.argv[1])
import kzg_tpu_torch
for m in pkgutil.walk_packages(kzg_tpu_torch.__path__, "kzg_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [k for k, v in sys.modules.items() if v is not None and (k == "jax" or k.startswith(("jax.", "kzg_tpu.")))]
assert not bad, bad
print("ok")
"""


def test_imports_nothing_of_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _GUARD, REPO], capture_output=True, text=True, timeout=120, cwd=REPO
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_a_card(monkeypatch):
    """No device given and no card: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_trusted_setup_file(SETUP)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        settings.resolve_device(None)
    with pytest.raises(RuntimeError):
        settings.resolve_device("cuda")
    assert settings.resolve_device("cpu") == torch.device("cpu")


def _points(n):
    from kzg_tpu_torch import native
    from kzg_tpu_torch.constants import G1_GENERATOR_X, G1_GENERATOR_Y

    gen = (G1_GENERATOR_X, G1_GENERATOR_Y)
    return [native.g1_mul(gen, 1000003 * (i + 1)) for i in range(n)]


def test_add_points_checks_inputs_and_has_no_fallback():
    p = g1.from_affine(g1.affine_from_ints(_points(4), "cpu"))
    with pytest.raises(ValueError, match="dtype"):
        cuda_msm.add_points(g1.map_coords(lambda c: c.long(), p), p)
    with pytest.raises(ValueError, match="shape"):
        cuda_msm.add_points(g1.map_coords(lambda c: c[:, :2].contiguous(), p), p)
    with pytest.raises(ValueError, match="contiguous"):
        q = g1.map_coords(lambda c: torch.cat([c, c], 1)[:, ::2], p)
        cuda_msm.add_points(q, q)
    meta = g1.map_coords(lambda c: c.to("meta"), p)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_msm.add_points(meta, meta)
    assert launch.launches() == {"seg_scan_phase1": 0, "add_unified": 0, "horner": 0, "ntt_tile": 0, "ntt_stage": 0, "gather_rows": 0}


def _fr_values(B, n, seed=1):
    rng = np.random.default_rng(seed)
    vals = [0, 1, FR.modulus - 1] + [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(B * n - 3)]
    return torch.from_numpy(FR.encode_host(vals).reshape(16, B, n))


def test_ntt_wrappers_check_inputs_and_have_no_fallback():
    x = _fr_values(2, 16)
    with pytest.raises(ValueError, match="dtype"):
        cuda_fft.ntt_tile(x.long())
    with pytest.raises(ValueError, match="shape"):
        cuda_fft.ntt_tile(x[:8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fft.ntt_tile(x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="power of two"):
        cuda_fft.ntt_stage(x[..., :12].contiguous(), 2)
    with pytest.raises(ValueError, match="stage 4"):
        cuda_fft.ntt_stage(x, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_fft.ntt_tile(x.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_fft.ntt_stage(x.to("meta"), 1)
    assert launch.launches() == {"seg_scan_phase1": 0, "add_unified": 0, "horner": 0, "ntt_tile": 0, "ntt_stage": 0, "gather_rows": 0}


def test_every_launcher_has_a_signature():
    """Each extern "C" launcher in csrc/ is bound, from the source that
    defines it, and every source is built."""
    import re

    found = {}
    for src in os.listdir(os.path.join(REPO, "kzg_tpu_torch", "csrc")):
        if src.endswith(".cu"):
            with open(os.path.join(REPO, "kzg_tpu_torch", "csrc", src)) as f:
                for name in re.findall(r'extern "C" int (\w+)\(', f.read()):
                    found[name] = src
    assert found == {name: src for name, (_, src) in kernels.SIGNATURES.items()}
    assert set(found.values()) == set(kernels.SOURCES)


def test_kernel_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def test_table_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path))
    pts = _points(4) + [None]
    built = settings.build_table_cached(pts, "test", torch.device("cpu"), c=13)
    path = settings.table_cache_path(pts, "test", 13)
    assert os.path.exists(path) and path.startswith(str(tmp_path))
    loaded = settings.build_table_cached(pts, "test", torch.device("cpu"), c=13)
    for a, b in zip(built[:3], loaded[:3]):
        assert torch.equal(a, b)
    assert g1.affine_to_ints(g1.G1Aff(built.x[:, 0], built.y[:, 0], built.inf[0])) == pts


def test_cache_dir_is_the_packages_own(monkeypatch):
    monkeypatch.delenv("KZG_TPU_TORCH_CACHE_DIR", raising=False)
    assert settings.cache_dir().endswith(os.path.join(".cache", "kzg_tpu_torch"))


def test_convert_rejects_non_limb_arrays():
    with pytest.raises(ValueError):
        convert.limbs_from_jax(np.array([[1 << 16]], dtype=np.uint32))
    t = convert.limbs_from_jax(np.array([[65535, 0]], dtype=np.uint32))
    assert t.dtype == torch.int32 and t.tolist() == [[65535, 0]]


def test_bytes_codecs_match_the_jax_package():
    from kzg_tpu import bytes as jb
    from kzg_tpu_torch import bytes as tb
    from kzg_tpu_torch.constants import R_MOD

    rng = np.random.default_rng(2)
    vals = [0, 1, R_MOD - 1, R_MOD, (1 << 256) - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(11)]
    data = b"".join(v.to_bytes(32, "big") for v in vals)
    limbs, ok = tb.frs_from_bytes(data)
    jlimbs, jok = jb.frs_from_bytes(data)
    np.testing.assert_array_equal(limbs, jlimbs.astype(np.int32))
    assert ok.tolist() == jok.tolist() == [v < R_MOD for v in vals]
    assert tb.frs_to_bytes(limbs) == data
    assert tb.fr_from_bytes(vals[2].to_bytes(32, "big")).tolist() == limbs[:, 2:3].tolist()
    with pytest.raises(ValueError, match="Invalid scalar: not canonical"):
        tb.fr_from_bytes(vals[3].to_bytes(32, "big"))
    with pytest.raises(ValueError, match="Invalid field element length"):
        tb.fr_from_bytes(bytes(31))
    blob = bytes(131072)
    assert tb.blob_to_scalars(blob).shape == (16, 4096)
    assert tb.blobs_to_scalars([blob, blob]).shape == (16, 2, 4096)
    with pytest.raises(ValueError, match="Invalid blob: Invalid byte length. Expected 131072 got 131071"):
        tb.blob_to_scalars(blob[:-1])
    with pytest.raises(ValueError, match="Invalid blob: scalar is not canonical"):
        tb.blobs_to_scalars([blob, vals[3].to_bytes(32, "big") * 4096])


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, without a card
    and when it stands alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=120, cwd=cwd)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_add_points_kernel_matches_plain(cuda_device):
    p = g1.dbl(g1.from_affine(g1.affine_from_ints(_points(300), cuda_device)))
    p = g1.map_coords(lambda c: c.contiguous(), p)  # the wrapper takes contiguous batches only
    q = g1.map_coords(lambda c: torch.roll(c, 7, dims=-1).contiguous(), p)
    for k in range(4):
        q[k][:, :20] = p[k][:, :20]  # P == Q
    q.zz[:, 20:40] = 0  # identity on the right
    q.zzz[:, 20:40] = 0
    got = cuda_msm.add_points(p, q)
    ref = cuda_msm.add_points_ref(*(g1.map_coords(lambda c: c.cpu(), x) for x in (p, q)))
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_seg_scan_kernel_matches_plain(cuda_device):
    aff = g1.affine_from_ints(_points(32) + [None], cuda_device)
    rows, r0 = msm._pack_point_rows(aff.x, aff.y, aff.inf)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 2 * r0, (6, 300)).astype(np.int32)
    idx[1] = idx[0]
    first = rng.random((6, 300)) < 0.3
    idx_t, first_t = torch.from_numpy(idx), torch.from_numpy(first)
    got = cuda_msm.seg_scan_phase1_mem(rows, idx_t.to(cuda_device), first_t.to(cuda_device))
    ref = cuda_msm.seg_scan_phase1_mem(rows.cpu(), idx_t, first_t)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("B, n, inverse", [(5, 128, False), (3, 4096, True), (2, 8192, False)])
def test_ntt_kernels_match_plain(cuda_device, B, n, inverse):
    x = _fr_values(B, n, seed=n)
    got = cuda_fft.ntt_tile(x.to(cuda_device), inverse)
    ref = cuda_fft.ntt_tile_ref(x, inverse)
    assert torch.equal(got.cpu(), ref)
    for s in range(cuda_fft.tile_stages(n.bit_length() - 1), n.bit_length() - 1):
        got, ref = cuda_fft.ntt_stage(ref.to(cuda_device), s, inverse), cuda_fft.ntt_stage_ref(ref, s, inverse)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
def test_msm_on_the_card_matches_the_cpu(cuda_device):
    aff = g1.affine_from_ints(_points(64), "cpu")
    table = msm.build_fixed_base_table(aff, c=9)
    rng = np.random.default_rng(8)
    sc = torch.from_numpy(ints_to_limbs([int.from_bytes(rng.bytes(31), "big") for _ in range(64)], 16))
    table_d = msm.FixedBaseTable(*(t.to(cuda_device) for t in table[:3]), table.c)
    got = g1.xyzz_to_ints(msm.msm_fixed(table_d, sc.to(cuda_device)))
    assert got == g1.xyzz_to_ints(msm.msm_fixed(table, sc))


def _horner_windows(device, nb, w, c):
    """XYZZ windows (24, nb, w): doubled points (zz not one), with lane 0
    all identity, lane 1 the identity at the start, lane 2 with W_{w-2} =
    2^c W_{w-1} (P == Q at the first addition), lane 3 with its negative
    (P == -Q)."""
    pts = _points(nb * w)
    win = g1.dbl(g1.from_affine(g1.affine_from_ints(pts, device)))
    win = g1.map_coords(lambda t: t.reshape(24, nb, w).contiguous(), win)
    lead = g1.map_coords(lambda t: t[:, 2:4, w - 1], win)
    for _ in range(c):
        lead = g1.dbl(lead)
    for k in range(4):
        win[k][:, 2, w - 2] = lead[k][:, 0]
        win[k][:, 3, w - 2] = g1.neg(lead)[k][:, 1]
    for t in (win.zz, win.zzz):
        t[:, 0] = 0
        t[:, 1, w - 1] = 0
    return win


@pytest.mark.gpu
@pytest.mark.parametrize("nb, w, c", [(2, 20, 13), (4, 20, 13), (300, 6, 3)])
def test_horner_kernel_matches_plain(cuda_device, nb, w, c):
    win = g1.map_coords(lambda t: t[:, :nb].contiguous(), _horner_windows(cuda_device, max(nb, 4), w, c))
    got = cuda_msm.horner_windows(win, c)
    ref = cuda_msm.horner_windows_ref(g1.map_coords(lambda t: t.cpu(), win), c)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_variable_base_msm_on_the_card_matches_the_cpu(cuda_device):
    aff = g1.affine_from_ints(_points(40) + [None], "cpu")
    rng = np.random.default_rng(9)
    sc = torch.from_numpy(
        np.stack([ints_to_limbs([int.from_bytes(rng.bytes(31), "big") for _ in range(41)], 16) for _ in range(2)], 1)
    )
    aff2 = g1.repeat_batch(aff, 2)
    on_card = g1.G1Aff(*(t.to(cuda_device) for t in aff2))
    launch.reset_launches()
    got = g1.xyzz_to_ints(msm.msm(on_card, sc.to(cuda_device)))
    assert launch.launches()["horner"] == 1
    assert got == g1.xyzz_to_ints(msm.msm(aff2, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("width, rows, count", [(24, 4096, 655360), (25, 1000, 777), (24, 300, 1)])
def test_gather_kernel_matches_plain(cuda_device, width, rows, count):
    """B6 word for word against index_select, with the first and last rows
    and repeated indices, on an aligned table and on one that starts one
    word into its storage (the kernel's unvectorised path)."""
    rng = np.random.default_rng(width + count)
    tab = torch.from_numpy(rng.integers(-(2**31), 2**31, (rows, width), dtype=np.int64).astype(np.int32))
    idx = np.concatenate([[0, rows - 1, rows - 1, 0], rng.integers(0, rows, count)])[:count].astype(np.int32)
    idx = torch.from_numpy(idx)
    want = cuda_gather.gather_rows_ref(tab, idx)
    unaligned = torch.empty(rows * width + 1, dtype=torch.int32, device=cuda_device)[1:].view(rows, width)
    unaligned.copy_(tab)
    for t in (tab.to(cuda_device), unaligned):
        assert torch.equal(cuda_gather.gather_rows(t, idx.to(cuda_device)).cpu(), want)


@pytest.mark.gpu
def test_gather_rows_launches_or_raises_on_a_card(cuda_device):
    tab = torch.arange(40, dtype=torch.int32, device=cuda_device).reshape(8, 5)
    launch.reset_launches()
    out = cuda_gather.gather_rows(tab, torch.tensor([7, 0], dtype=torch.int32, device=cuda_device))
    assert out.cpu().tolist() == [list(range(35, 40)), list(range(5))]
    assert launch.launches()["gather_rows"] == 1
    with pytest.raises(IndexError, match="out of range"):
        cuda_gather.gather_rows(tab, torch.tensor([8], dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="on cpu"):
        cuda_gather.gather_rows(tab, torch.tensor([1], dtype=torch.int32))
