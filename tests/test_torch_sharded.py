"""kzg_tpu_torch.parallel in one process: the sharded FFT's twiddles and
its 1/n against the JAX package's parallel/sharded_fft.py, the mesh layout
and its ValueErrors, the padding of a batch that does not divide, and the
collectives and the sharded FFT in a process group of one (gloo, a
FileStore in the test's directory, torn down at the end); and, in its one
spawn, the launcher when one of two ranks fails while the other waits in a
collective. Tolerance: exact (Montgomery limbs)."""

import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from kzg_tpu_torch import api, eip4844
from kzg_tpu_torch.constants import R_MOD as R
from kzg_tpu_torch.ops import cuda_fft, fft as tfft
from kzg_tpu_torch.ops.field import FR
from kzg_tpu_torch.parallel import distributed as D
from kzg_tpu_torch.parallel import dryrun, sharded_fft

torch.set_num_threads(1)  # one core per test worker: the suite runs several at once


@pytest.mark.parametrize("n1, n2, inverse", [(4, 4, False), (8, 16, True), (64, 128, False)])
def test_twiddles_and_the_inverse_scale_match_the_jax_package(n1, n2, inverse):
    from kzg_tpu.parallel import sharded_fft as jsf  # here, not at the top: the spawned ranks import this file

    np.testing.assert_array_equal(sharded_fft._outer_twiddles(n1, n2, inverse).astype(np.int64),
                                  jsf._outer_twiddles(n1, n2, inverse).astype(np.int64))
    # the inverse's 1/n is step 1's 1/n2 times step 4's 1/n1
    half_scales = [FR.decode(cuda_fft._n_inv(k.bit_length() - 1, "cpu", False))[0] for k in (n1, n2)]
    want = FR.decode(jsf._n_inv_mont(n1 * n2).astype(np.int32).reshape(16, 1))[0]
    assert half_scales[0] * half_scales[1] % R == want


def test_fft_split_follows_the_jax_package():
    assert sharded_fft.split(8192, 2) == (64, 128)
    assert sharded_fft.split(64, 4) == (8, 8)
    assert sharded_fft.split(16, 8) == (8, 2)  # n1 grows to the axis's size
    with pytest.raises(ValueError, match="does not split"):
        sharded_fft.split(64, 3)
    with pytest.raises(ValueError, match="does not split"):
        sharded_fft.split(48, 2)


def test_dry_run_mesh_layout():
    """By default the points axis takes the largest power of two up to 4
    that divides the ranks, as the JAX package's dry run factors them."""
    want = {1: (1, 1), 2: (1, 2), 3: (3, 1), 4: (1, 4), 6: (3, 2), 8: (2, 4), 12: (3, 4)}
    assert {n: dryrun.mesh_shape(n) for n in want} == want
    assert dryrun.mesh_shape(4, 2) == (2, 2)
    with pytest.raises(ValueError, match="not divisible by blob axis 3"):
        dryrun.mesh_shape(4, 3)


def test_a_batch_that_does_not_divide_is_padded_with_the_first_blob():
    blobs = [bytes([i]) * 4 for i in range(5)]
    assert eip4844._padded(blobs, 4, blobs[0]) == blobs + [blobs[0]] * 3
    assert eip4844._padded(blobs, 5, blobs[0]) == blobs
    assert len(eip4844._padded((blobs * 13)[:63], 2, blobs[0])) == 64


def test_default_backend(monkeypatch):
    """NCCL only when every rank of the node has a card of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert D.default_backend(1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.default_backend(2) == "nccl"
    assert D.default_backend(4) == "gloo"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A gloo process group of one rank, torn down after the file's tests."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("store") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_errors(group):
    D.initialize("127.0.0.1:1", 1, 0)  # joined already: returns at once
    with pytest.raises(ValueError, match="1 ranks not divisible by blob axis 2"):
        D.global_mesh(2)
    mesh = D.global_mesh()
    assert mesh.mesh_dim_names == ("blobs", "points") and tuple(mesh.shape) == (1, 1)
    points_only = init_device_mesh("cpu", (1,), mesh_dim_names=("points",))
    with pytest.raises(ValueError, match="mesh must have a 'blobs' axis"):
        D.axis_size(points_only, "blobs")
    # the entry points check the mesh before they read the settings
    blob = bytes(131072)
    with pytest.raises(ValueError, match="'blobs' axis"):
        api.blob_to_kzg_commitment_batch([blob], None, mesh=points_only)
    with pytest.raises(ValueError, match="'blobs' axis"):
        api.verify_blob_kzg_proof_batch([blob] * 2, [bytes(48)] * 2, [bytes(48)] * 2, None, mesh=points_only)


def test_collectives_in_a_group_of_one(group):
    mesh = D.blobs_mesh()
    t = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    assert torch.equal(D.all_gather(t, mesh, "blobs"), t[..., None])
    assert torch.equal(D.all_to_all(t, mesh, "blobs", split_dim=2, concat_dim=1), t)
    assert torch.equal(D.gather_shards(D.shard(t, mesh, "blobs", 1), mesh, "blobs", 1), t)
    assert D.axis_index(mesh, "blobs") == 0
    # gloo moves a tensor that is not in host memory through it; a host tensor stays
    assert D._through_host(torch.empty(1, device="meta"), mesh.get_group("blobs"))
    assert not D._through_host(t, mesh.get_group("blobs"))


@pytest.mark.parametrize("n", [2, 64, 4096])
def test_fft_sharded_in_a_group_of_one(group, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(FR.encode_host([int.from_bytes(rng.bytes(32), "big") % R for _ in range(n)]))
    mesh = D.global_mesh()
    got = sharded_fft.fft_sharded(x, mesh)
    assert torch.equal(got, tfft.fft(x))
    assert torch.equal(sharded_fft.ifft_sharded(got, mesh), x)


def _rank_1_fails(device):
    """A rank program: rank 1 raises while rank 0 waits in a collective
    that rank 1 never joins."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def test_a_failing_rank_fails_the_launch(tmp_path):
    """This file's one spawn: rank 1 raises and rank 0 waits for it in a
    barrier; the parent raises with rank 1's traceback at once, not at the
    time limit, and every rank has ended. (Whether rank 0's barrier fails
    too, as gloo sees rank 1 go, and which exit the parent sees first, is
    a race: either rank may be the one named.)"""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[[01, ]+\] failed(.|\n)*rank 1 fails on purpose"):
        dryrun.launch(_rank_1_fails, 2, "cpu", out_dir=str(tmp_path), timeout=60)
    assert time.monotonic() - t0 < 50
    assert (tmp_path / "rank1.err").exists()
    assert not multiprocessing.active_children()
