"""Package-level properties of kzg_tpu_torch: it imports nothing of JAX or
of the JAX package, its entry points refuse to run on the CPU unless asked
to, its kernel wrappers check their inputs and never fall back, its caches
round-trip; and the kernels against their plain versions on a card
(marked `gpu`, skipped without one)."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kzg_tpu_torch import api, c_abi_host, convert, fk20, kernels, settings, tracing
from kzg_tpu_torch.ops import cuda_fft, cuda_gather, cuda_msm, g1, launch, msm
from kzg_tpu_torch.ops import field as fl
from kzg_tpu_torch.ops.field import FP, FR
from kzg_tpu_torch.ops.field import ints_to_limbs
from kzg_tpu_torch.trusted_setup import TrustedSetup
from kzgbench.reference import pool as reference_pool
from kzgbench.reference.curve import msm as reference_msm

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
for m in ("kzg_tpu_torch.ops.poly", "kzg_tpu_torch.multiproof", "kzg_tpu_torch.fk20", "kzg_tpu_torch.c_abi",
          "kzg_tpu_torch.c_abi_host", "kzg_tpu_torch.parallel.dryrun", "kzg_tpu_torch.benches.scaling_2proc"):
    assert m in sys.modules, m
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
    on_card = settings.TorchKZGSettings(TrustedSetup([None] * 4, [], []), torch.device("cuda"), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fk20.FK20SingleSettings(on_card, 8)
    monkeypatch.delenv("KZG_TPU_TORCH_DEVICE", raising=False)
    assert c_abi_host.load_trusted_setup_file(SETUP) == (c_abi_host.ERROR, 0)


def _parameters(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


# the names both api.py modules define; test_api_shares_these_names keeps the list whole
SHARED_API = [
    "blob_to_kzg_commitment", "blob_to_kzg_commitment_batch", "compute_blob_kzg_proof",
    "compute_blob_kzg_proof_batch", "compute_cells", "compute_cells_and_kzg_proofs", "compute_kzg_proof",
    "compute_verify_cell_kzg_proof_batch_challenge", "load_trusted_setup", "load_trusted_setup_file",
    "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch", "verify_cell_kzg_proof_batch", "verify_kzg_proof",
    "recover_cells_and_kzg_proofs", "recover_cells_and_kzg_proofs_batch", "compute_kzg_proof_multi",
    "verify_kzg_proof_multi",
]


def test_api_shares_these_names():
    from kzg_tpu import api as japi

    shared = {
        name for name, fn in vars(api).items()
        if inspect.isfunction(fn) and fn.__module__ == api.__name__ and callable(getattr(japi, name, None))
    }
    assert shared == set(SHARED_API)


def test_api_has_every_public_name_of_the_jax_package():
    """Every public function the JAX package's api.py offers, defined there
    or imported into it, the port's api.py offers too."""
    from kzg_tpu import api as japi

    public = {
        name for name, fn in vars(japi).items()
        if not name.startswith("_") and inspect.isfunction(fn)
    }
    assert public - set(vars(api)) == set()
    with open(SETUP) as f:
        contents = f.read()
    assert api.parse_trusted_setup_string(contents) == japi.parse_trusted_setup_string(contents)


@pytest.mark.parametrize("name", SHARED_API)
def test_api_signature_matches_the_jax_package(name):
    """The function takes the JAX package's parameters, in the same order,
    with the same defaults: a keyword call that works on one package works
    on the other. The port alone adds a trailing `device`; the `mesh` of
    the two batch EIP-4844 calls is compared like every other parameter."""
    from kzg_tpu import api as japi

    port, ref = _parameters(getattr(api, name)), _parameters(getattr(japi, name))
    if port[-1:] == [("device", None)]:
        port = port[:-1]
    assert port == ref


def test_setup_is_found_without_a_path(tmp_path, monkeypatch):
    """load_trusted_setup_file() with no path loads the repo's mainnet
    setup, through the port's own lookup."""
    monkeypatch.delenv("KZG_TPU_TRUSTED_SETUP", raising=False)
    s = api.load_trusted_setup_file(device="cpu")
    assert s.device == torch.device("cpu")
    assert len(s.setup.g1_lagrange_brp) == 4096 and len(s.setup.g1_monomial) == 4096
    with open(SETUP) as f:
        first_lagrange = bytes.fromhex(f.read().split()[2])
    from kzg_tpu_torch import native

    assert native.g1_compress_batch([s.setup.g1_lagrange_brp[0]]) == [first_lagrange]


@pytest.mark.parametrize("env", ["a file", "a missing file", "a missing file, no repo setup"])
def test_setup_lookup_order(tmp_path, monkeypatch, env):
    """$KZG_TPU_TRUSTED_SETUP is taken when it names a file and passed over
    when it does not, for the repo's tests/trusted_setup.txt; with neither,
    loading raises FileNotFoundError."""
    named = tmp_path / "setup.txt"
    if env == "a file":
        named.write_text("")
    monkeypatch.setenv("KZG_TPU_TRUSTED_SETUP", str(named))
    if env == "a file":
        assert settings.trusted_setup_path() == str(named)
    elif env == "a missing file":
        assert os.path.samefile(settings.trusted_setup_path(), SETUP)
    else:
        monkeypatch.setattr(settings, "_REPO_SETUP", str(tmp_path / "absent.txt"))
        with pytest.raises(FileNotFoundError, match="trusted_setup.txt not found"):
            api.load_trusted_setup_file(device="cpu")


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
    assert launch.launches() == {"seg_scan_phase1": 0, "add_unified": 0, "horner": 0, "integrate": 0, "ntt_tile": 0, "ntt_stage": 0, "gather_rows": 0, "field_inv": 0, "g1_ladder": 0}


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
    assert launch.launches() == {"seg_scan_phase1": 0, "add_unified": 0, "horner": 0, "integrate": 0, "ntt_tile": 0, "ntt_stage": 0, "gather_rows": 0, "field_inv": 0, "g1_ladder": 0}


def test_field_inv_has_no_fallback():
    x = FP.encode([0, 1, 5], "cpu")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fl.inv(FP, x.to("meta"))
    assert launch.launches()["field_inv"] == 0


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


def test_thread_group_is_the_kernels_own():
    """The threads per point that ops/cuda_msm.py reports are the
    compile-time GROUP of B2's and B3's kernels, and SCAN_GROUP B1's;
    INTEGRATE_UNITS is B9's units a block, half its 32 lanes."""
    import re

    with open(os.path.join(REPO, "kzg_tpu_torch", "csrc", "g1.cuh")) as f:
        text = f.read()
    assert re.findall(r"constexpr int GROUP = (\d+);", text) == [str(cuda_msm.GROUP)]
    assert re.findall(r"constexpr int GPTS = (\d+);", text) == [str(2 * cuda_msm.INTEGRATE_UNITS)]
    with open(os.path.join(REPO, "kzg_tpu_torch", "csrc", "msm_kernels.cu")) as f:
        text = f.read()
    assert re.findall(r"constexpr int GROUP = (\d+);", text) == [str(cuda_msm.SCAN_GROUP)]
    assert "constexpr int UNITS = GPTS / 2;" in text


def test_kernel_variants_edit_the_sources_as_they_are():
    """benches/kernel_variants.py rewrites the kernels' sources: each
    constant it sets and each text it replaces is there exactly once."""
    import re

    from kzg_tpu_torch.benches import kernel_variants as kv

    def text(source):
        with open(os.path.join(REPO, "kzg_tpu_torch", "csrc", source)) as f:
            return f.read()

    for _, source, consts in kv.VARIANTS:
        for name in consts:
            assert len(re.findall(rf"constexpr int {name} = \d+;", text(source))) == 1, (source, name)
    for _, source, label, edits in kv.PARTS_OUT:
        for old, new in edits:
            assert text(source).count(old) == 1 and old != new, (source, label)


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


def _edge_pairs(M, device):
    """XYZZ batches p, q of M lanes (doubled points, so zz is not one):
    P == Q in lane 5 alone of the first 32-lane block and in every lane of
    the second (lane 0 when M < 6), P == -Q in lane 6, the identity on the
    right in lane 7, on the left in lane 8, on both sides in lane 9."""
    p = g1.dbl(g1.from_affine(g1.affine_from_ints(_points(M), device)))
    p = g1.map_coords(lambda c: c.contiguous(), p)
    q = g1.map_coords(lambda c: torch.roll(c, 1, dims=-1).contiguous(), p)
    neg_p = g1.neg(p)
    same = [0] if M < 6 else [5] + list(range(32, min(M, 64)))
    for k in range(4):
        q[k][:, same] = p[k][:, same]
        q[k][:, 6:7] = neg_p[k][:, 6:7]
    for pt, lanes in ((q, slice(7, 8)), (p, slice(8, 9)), (p, slice(9, 10)), (q, slice(9, 10))):
        pt.zz[:, lanes] = 0
        pt.zzz[:, lanes] = 0
    return p, q


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 7, 33, 100, 240, 1000, 2048, 32768, 133120])
def test_add_points_kernel_edge_cases(cuda_device, M):
    """B2 at lane counts that are not multiples of the block's 32 points or
    of the group, at the fixed-base MSM's 32,768 chunk sums of 64 blobs and
    at the 133,120 lanes of 16 blobs' FK20 half convolutions, with a block
    where one lane doubles and one where every lane does, identity operands
    on either side and P == -Q."""
    p, q = _edge_pairs(M, cuda_device)
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


def _scan_case(K, m, seed, dbl=None):
    """B1's inputs on 32 points and the identity (row 32): seeded rows and
    segment starts, a restart on the identity row (an identity sum) and
    identity rows when K > 5, and where `dbl` names lanes, those lanes add
    step 0's row to itself at step 1 (P == Q) while the other lanes add
    another row."""
    aff = g1.affine_from_ints(_points(32) + [None], "cpu")
    rows, r0 = msm._pack_point_rows(aff.x, aff.y, aff.inf)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2 * r0, (K, m))
    first = rng.random((K, m)) < 0.25
    if K > 5:
        idx[4, 1::5] = 32
        first[4, 1::5] = True
        idx[5, ::3] = 32
    if dbl is not None:
        idx[0, dbl] = np.where(idx[0, dbl] % r0 == 32, 7, idx[0, dbl])
        idx[1] = (idx[0] + 1) % (2 * r0)
        idx[1, dbl] = idx[0, dbl]
        first[0, dbl] = True
        first[1, dbl] = False
    return rows, torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(first)


@pytest.mark.gpu
@pytest.mark.parametrize("K, m, dbl", [(6, 300, None), (7, 1, None), (1, 77, None), (2, 33, None),
                                       (6, 96, [37]), (6, 96, list(range(32, 64))),
                                       (160, 32768, None), (128, 32768, None)])
def test_seg_scan_kernel_edge_cases(cuda_device, K, m, dbl):
    """B1 at m not a multiple of its 32-lane blocks, one lane, one step;
    one lane alone of its block with P == Q, a block where every lane has
    it; identity rows, an identity sum after a restart, P == -Q (the
    negated rows); and at the (K, m) of the 64-blob commitment's scan (K
    = 160) and of 16 blobs' FK20 column MSM (K = 128), on this file's
    33-row table, not on the mainnet tables (chip_smoke.py's B1 row runs
    both on those). The plain version runs on the card."""
    rows, idx, first = (t.to(cuda_device) for t in _scan_case(K, m, K * 1000 + m, dbl))
    got = cuda_msm.seg_scan_phase1_mem(rows, idx, first)
    ref = cuda_msm.seg_scan_phase1_mem_ref(rows, idx, first)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# (B, n, inverse): odd batches, and every transform the recovery, multiproof,
# das_extension and legacy FK20 calls give B4 and B5: one blob's at n = 4 to
# 8192, the vanishing polynomial's trees of one blob and of 9 (batch x n =
# 32 x 4 ... 1 x 128, times 9), the 9 blobs' division, their 64 x 128 FK20
# transforms (a batch of 576), the legacy chunk files' 64 x 128 and 16 x 512
NTT_CASES = sorted(
    {(5, 128, False), (3, 4096, True), (2, 8192, False), (7, 2, False), (5, 512, True), (3, 1024, False),
     (5, 2048, True), (5, 2048, False), (3, 8192, True), (9, 8192, False), (9, 8192, True), (64, 128, False),
     (576, 128, False), (16, 512, False)}
    | {(1, 1 << k, inverse) for k in range(2, 14) for inverse in (False, True)}
    | {(b * (32 >> lv), 4 << lv, inverse) for b in (1, 9) for lv in range(6) for inverse in (False, True)}
)


@pytest.mark.gpu
@pytest.mark.parametrize("B, n, inverse", NTT_CASES)
def test_ntt_kernels_match_plain(cuda_device, B, n, inverse):
    x = _fr_values(B, n, seed=n)
    got = cuda_fft.ntt_tile(x.to(cuda_device), inverse)
    ref = cuda_fft.ntt_tile_ref(x, inverse)
    assert torch.equal(got.cpu(), ref)
    for s in range(cuda_fft.tile_stages(n.bit_length() - 1), n.bit_length() - 1):
        got, ref = cuda_fft.ntt_stage(ref.to(cuda_device), s, inverse), cuda_fft.ntt_stage_ref(ref, s, inverse)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B, n, inverse", [(16, 4096, True), (16, 8192, False), (1024, 128, False)])
def test_ntt_kernels_at_the_cells_call_shapes(cuda_device, B, n, inverse):
    """B4 and B5 at the three transforms of one 16-blob cells call, the
    plain version on the card."""
    x = _fr_values(B, n, seed=B + n).to(cuda_device)
    got, ref = cuda_fft.ntt_tile(x, inverse), cuda_fft.ntt_tile_ref(x, inverse)
    assert torch.equal(got, ref)
    for s in range(cuda_fft.tile_stages(n.bit_length() - 1), n.bit_length() - 1):
        got, ref = cuda_fft.ntt_stage(ref, s, inverse), cuda_fft.ntt_stage_ref(ref, s, inverse)
        assert torch.equal(got, ref)


@pytest.mark.gpu
def test_msm_on_the_card_matches_the_cpu(cuda_device):
    aff = g1.affine_from_ints(_points(64), "cpu")
    table = msm.build_fixed_base_table(aff, c=9)
    rng = np.random.default_rng(8)
    sc = torch.from_numpy(ints_to_limbs([int.from_bytes(rng.bytes(31), "big") for _ in range(64)], 16))
    table_d = msm.FixedBaseTable(*(t.to(cuda_device) for t in table[:3]), table.c)
    launch.reset_launches()
    got = g1.xyzz_to_ints(msm.msm_fixed(table_d, sc.to(cuda_device)))
    assert launch.launches()["integrate"] == 1
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
@pytest.mark.parametrize("nb, w, c", [(1, 20, 13), (2, 20, 13), (1, 32, 8), (1024, 4, 2), (3, 1, 13), (5, 6, 1),
                                     (1, 1, 13), (2, 20, 1), (1024, 20, 13)])
def test_horner_kernel_edge_shapes(cuda_device, nb, w, c):
    """B3 at one, two and 1024 MSMs, one window, c = 1 and the verify
    paths' shapes (the proof MSM: 2 MSMs, c = 13, 20 windows; the
    commitment MSM: 1, c = 8, 32 windows), and 1024 MSMs of 20 windows."""
    win = g1.map_coords(lambda t: t[:, :nb].contiguous(), _horner_windows(cuda_device, max(nb, 4), w, c))
    got = cuda_msm.horner_windows(win, c)
    ref = cuda_msm.horner_windows_ref(g1.map_coords(lambda t: t.cpu(), win), c)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def _buckets(rows, B, device, seed):
    """XYZZ bucket sums (24, rows, B): 2 P + Q of seeded points of a pool,
    P negated at random (zz neither one nor shared), a tenth the identity;
    where rows >= 6, rows 0-5 are the edge cases: all identities, one point
    in every bucket (P == Q in the running sums), one point with
    alternating signs, adjacent pairs S, -S, one point at bucket B - 1
    alone, one point at bucket 0 alone (weight 0)."""
    pool = g1.from_affine(g1.affine_from_ints(_points(64), device))
    rng = np.random.default_rng(seed)
    n = rows * B

    def pick():
        idx = torch.from_numpy(rng.integers(0, 64, n)).to(device)
        return g1.map_coords(lambda c: c[:, idx], pool)

    p = pick()
    p = g1.select_point(torch.from_numpy(rng.random(n) < 0.5).to(device), g1.neg(p), p)
    s = g1.add_unified(g1.dbl(p), pick())
    s = g1.select_point(torch.from_numpy(rng.random(n) < 0.1).to(device), g1.infinity((n,), device), s)
    s = g1.map_coords(lambda c: c.reshape(24, rows, B).contiguous(), s)
    if rows >= 6:
        one = g1.dbl(g1.map_coords(lambda c: c[:, :1], pool))  # (24, 1)
        neg_one = g1.neg(one)
        pairs = g1.neg(g1.map_coords(lambda c: c[:, 3, 0::2], s))
        for k in range(4):
            c = s[k]
            c[:, [0, 4, 5]] = 0
            c[:, 1] = one[k]
            c[:, 2, 0::2], c[:, 2, 1::2] = one[k], neg_one[k]
            c[:, 3, 1::2] = pairs[k][:, : B // 2]
            c[:, 4, B - 1] = one[k][:, 0]
            c[:, 5, 0] = one[k][:, 0]
    return s


def _integrate_matches_plain(b):
    """B9 and its plain version (on the card) give the same affine points."""
    got = g1.to_affine(cuda_msm.integrate_buckets(b))
    ref = g1.to_affine(g1.map_coords(lambda c: c[..., 0], cuda_msm.integrate_buckets_ref(b)))
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    return got


# (rows, B): the MSMs' shapes (the verify lincombs at c = 7 and 8, the
# interpolation MSM, the commitment MSM, the FK20 column MSM of 9 and of 18
# blobs, c = 4's nine buckets), then one of each grid B9 takes: a row over
# 16 and over 4 blocks, 8, 1 and 2 units a row, one bucket
INTEGRATE_SHAPES = [(74, 65), (37, 65), (1, 257), (64, 129), (6, 4097), (1152, 129), (2304, 129), (3, 9),
                    (1, 4097), (2, 300), (5, 33), (7, 5), (6, 9), (1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows, B", INTEGRATE_SHAPES)
def test_integrate_kernel_matches_plain(cuda_device, rows, B):
    """B9 against its plain version as affine points (XYZZ is not
    unique), the edge rows of _buckets among the rows from 6 rows on."""
    got = _integrate_matches_plain(_buckets(rows, B, cuda_device, seed=rows * 10007 + B))
    if rows >= 6:
        assert bool(got.inf[0]) and bool(got.inf[5]) and not bool(got.inf[1:5].any())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [9, 65, 257, 4097])
def test_integrate_kernel_edge_rows_alone(cuda_device, B):
    """Each edge row of _buckets as a call of its own row, so that every
    grid a row of B buckets takes meets it (a row over several blocks from
    257 on), and all six together."""
    b = _buckets(6, B, cuda_device, seed=B)
    for r in range(6):
        _integrate_matches_plain(g1.map_coords(lambda c: c[:, r : r + 1].contiguous(), b))
    _integrate_matches_plain(b)


@pytest.mark.gpu
def test_integration_is_one_launch_on_a_card(cuda_device):
    """msm.integrate_buckets of a verify lincomb's (batch, window) rows
    and of a commitment's: one launch of B9, no other kernel (no B2, no
    plain doubling); the row counts stay at zero for the next call; no
    rows, no launch."""
    for shape in ((2, 37, 65), (6, 4097)):
        b = g1.map_coords(lambda c: c.reshape((24,) + shape), _buckets(int(np.prod(shape[:-1])), shape[-1], cuda_device, 1))
        msm.integrate_buckets(b)  # the row counts are allocated at the first call of a shape that needs them
        torch.cuda.synchronize()
        launch.reset_launches()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = msm.integrate_buckets(b)
            torch.cuda.synchronize()
        assert tuple(out.x.shape) == (24,) + shape[:-1] + (1,)
        assert launch.launches() == {**{k: 0 for k in launch.launches()}, "integrate": 1}
        on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(on_card) == 1 and "integrate" in on_card[0], on_card
    assert cuda_msm._row_counts and not any(bool(c.any()) for c in cuda_msm._row_counts.values())
    launch.reset_launches()
    assert tuple(cuda_msm.integrate_buckets(g1.map_coords(lambda c: c[:, :0].contiguous(), b)).x.shape) == (24, 0)
    assert launch.launches()["integrate"] == 0


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
    assert launch.launches()["horner"] == 1 and launch.launches()["integrate"] == 1
    assert got == g1.xyzz_to_ints(msm.msm(aff2, sc))


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("n", range(1, 8))
def test_small_msm_on_the_card_matches_the_reference(cuda_device, n, nb, monkeypatch):
    """Below 8 points, with no batch axis (nb = 1) and with one: one launch
    each of B1, B9 and B3, no per-lane ladder, one msm.small a row; the
    sums equal the reference's Python-integer MSM as affine points, with
    0, 1, 2 and r - 1 among the scalars (turned by the row) and an identity
    point among the points (n >= 3)."""
    monkeypatch.setattr(g1, "scalar_mul", None)  # the ladder's step: any call raises
    pts = _points(n)
    if n >= 3:
        pts[2] = None
    rng = np.random.default_rng(100 + n)
    edge = (0, 1, 2, FR.modulus - 1)
    rows = [[edge[(i + b) % 4] if i < 4 else int.from_bytes(rng.bytes(32), "little") % FR.modulus for i in range(n)]
            for b in range(nb)]
    sc = torch.from_numpy(np.stack([ints_to_limbs(r, 16) for r in rows], 1)).to(cuda_device)
    aff = g1.G1Aff(*(t.to(cuda_device) for t in g1.affine_from_ints(pts, "cpu")))
    before = tracing.counters().get("msm.small", 0)
    launch.reset_launches()
    if nb == 1:
        got = g1.xyzz_to_ints(g1.map_coords(lambda t: t[:, None], msm.msm(aff, sc[:, 0])))
    else:
        got = g1.xyzz_to_ints(msm.msm(g1.repeat_batch(aff, nb), sc))
    counts = launch.launches()
    assert (counts["seg_scan_phase1"], counts["integrate"], counts["horner"]) == (1, 1, 1), counts
    assert tracing.counters()["msm.small"] - before == nb
    assert got == [reference_msm(pts, r) for r in rows]


@pytest.mark.gpu
def test_six_blob_column_verifies_on_the_card(cuda_device, tmp_path, monkeypatch):
    """One column of a 6-blob block (EIP-7691's target) on the card: the
    reference's commitments and cell proofs (kzgbench's pool of 16), the
    cells from the port's compute_cells. True, with both variable-base
    MSMs on the bucket path (3 rows of msm.small; B1 and B9 once an MSM
    with the fixed 64-point one, B3 once a variable-base MSM) and no
    ladder; False with one proof replaced by a seventh blob's."""
    monkeypatch.setenv("KZG_TPU_TORCH_CACHE_DIR", str(tmp_path))
    pool = reference_pool.load(os.path.join(REPO, "kzgbench", "pools", "mainnet-16.json"))
    s = api.load_trusted_setup_file(SETUP, device=cuda_device)
    col, e = 77, pool["entries"]
    cells = [c[col] for c in api.compute_cells_and_kzg_proofs_batch(pool["blobs"][:6], s, with_proofs=False)[0]]
    commitments = [bytes.fromhex(x["commitment"]) for x in e[:6]]
    proofs = [bytes.fromhex(x["cell_proofs"][col]) for x in e[:7]]
    monkeypatch.setattr(g1, "scalar_mul", None)
    before = tracing.counters().get("msm.small", 0)
    launch.reset_launches()
    assert api.verify_cell_kzg_proof_batch(commitments, [col] * 6, cells, proofs[:6], s) is True
    counts = launch.launches()
    assert (counts["seg_scan_phase1"], counts["integrate"], counts["horner"]) == (3, 3, 2), counts
    assert tracing.counters()["msm.small"] - before == 3
    assert api.verify_cell_kzg_proof_batch(commitments, [col] * 6, cells, proofs[:5] + proofs[6:], s) is False


@pytest.mark.gpu
@pytest.mark.parametrize("width, rows, count", [(24, 4096, 655360), (25, 1000, 777), (24, 300, 1), (25, 1000, 1),
                                                (25, 2 * 20 * 4096, 655360)])
def test_gather_kernel_matches_plain(cuda_device, width, rows, count):
    """B6 word for word against index_select, with the first and last rows
    and repeated indices, on an aligned table and on one that starts one
    word into its storage (the kernel's unvectorised path); at the gather
    probe's shape and at the fixed-base MSM's (the 25-word rows of the
    mainnet table and their negations, a batch of 8)."""
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
    for bad in (8, -1):
        with pytest.raises(IndexError, match="out of range"):
            cuda_gather.gather_rows(tab, torch.tensor([3, bad], dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="on cpu"):
        cuda_gather.gather_rows(tab, torch.tensor([1], dtype=torch.int32))


def _field_values(spec, n, seed):
    """n seeded values of the field, with 0, 1 and m - 1 among them from
    n = 4 on, in Montgomery form on the CPU."""
    rng = np.random.default_rng(seed)
    m = spec.modulus
    vals = [int.from_bytes(rng.bytes(spec.n_limbs * 2), "little") % m for _ in range(n)]
    if n >= 4:
        vals[0], vals[n // 2], vals[-1] = 0, 1, m - 1
    return vals, spec.encode(vals, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (9,), (64, 1), (128,), (1152,), (4097,)], ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("spec", [FP, FR], ids=["Fp", "Fr"])
def test_field_inv_kernel_matches_plain(cuda_device, spec, shape):
    """B7 limb for limb against pow_fixed on the card, 0 -> 0; at the
    main paths' inversions (to_affine's one lane and 1152 lanes, the cell
    verifier's 64 x 1) among others."""
    n = int(np.prod(shape))
    vals, x = _field_values(spec, n, n)
    x = x.to(cuda_device).reshape((spec.n_limbs,) + shape)
    got = fl.inv(spec, x)
    assert torch.equal(got.cpu(), fl.pow_fixed(spec, x, spec.modulus - 2).cpu())
    m = spec.modulus
    assert spec.decode(got) == [pow(v, m - 2, m) for v in vals]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [FP, FR], ids=["Fp", "Fr"])
def test_field_inv_kernel_on_broadcast_and_strided_inputs(cuda_device, spec):
    L = spec.n_limbs
    _, x = _field_values(spec, 15, 3)
    x = x.to(cuda_device)
    broadcast = x[:, :5].reshape(L, 1, 5).expand(L, 3, 5)
    strided = x.reshape(L, 3, 5).transpose(1, 2)
    for a in (broadcast, strided, x[:, ::2]):
        got = fl.inv(spec, a)
        assert got.shape == a.shape
        assert torch.equal(got.cpu(), fl.pow_fixed(spec, a, spec.modulus - 2).cpu())


@pytest.mark.gpu
def test_field_inv_launches_once_on_a_card(cuda_device):
    _, x = _field_values(FP, 9, 5)
    before = tracing.counters().get("field.inversions", 0)
    launch.reset_launches()
    fl.inv(FP, x.to(cuda_device))
    assert launch.launches()["field_inv"] == 1
    assert tracing.counters()["field.inversions"] == before + 1


@pytest.mark.gpu
def test_field_inv_checks_its_input(cuda_device):
    _, x = _field_values(FP, 9, 6)
    x = x.to(cuda_device)
    launch.reset_launches()
    with pytest.raises(ValueError, match="expected \\(24, ...\\) limbs"):
        fl.inv(FP, x[:16])
    with pytest.raises(ValueError, match="dtype"):
        fl.inv(FP, x.to(torch.int64))
    assert launch.launches()["field_inv"] == 0


@pytest.mark.gpu
def test_to_affine_on_the_card_matches_the_cpu(cuda_device):
    """to_affine of 1152 points (a 9-blob cells call's proofs), one of them
    the identity: byte-equal to the plain route on a CPU copy."""
    p = g1.dbl(g1.from_affine(g1.affine_from_ints(_points(1152), cuda_device)))
    lane = torch.arange(1152, device=cuda_device) == 700
    p = g1.select_point(lane, g1.infinity((1152,), cuda_device), p)
    launch.reset_launches()
    on_card = g1.to_affine(p)
    assert launch.launches()["field_inv"] == 1
    on_cpu = g1.to_affine(g1.map_coords(lambda t: t.cpu(), p))
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    assert bool(on_card.inf[700]) and int(on_card.inf.sum()) == 1
