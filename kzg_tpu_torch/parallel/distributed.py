"""The process group and the device mesh of the sharded programs, and the
two collectives they use.

The JAX package runs one controller over a global mesh. The port runs SPMD
processes on torch.distributed: every rank calls the same function with
the same full inputs, takes its shard by its coordinates in the mesh,
computes it on its own device, and gets back the whole result.

    torchrun --nproc-per-node=N prog.py     # one card a rank: NCCL
    initialize(); mesh = global_mesh()      # in every rank

The mesh is a torch DeviceMesh with dimension names ("blobs", "points")
or ("blobs",). Under gloo (several ranks on one card, or ranks on the
CPU) the collectives copy card tensors through host memory, because gloo
does not move CUDA tensors in all_gather and all_to_all; under NCCL they
stay on the card.
"""

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# a rank that waits longer than this in a collective fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def default_backend(local_world_size: int) -> str:
    """NCCL when every rank of this node has a card of its own, gloo
    otherwise (NCCL refuses two ranks on one card)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent). With no arguments, read
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE); otherwise coordinator_address is
    "host:port" of rank 0. backend None takes default_backend(); under
    NCCL the rank's card is cuda:LOCAL_RANK (the process id where torchrun
    set none) and becomes the current device."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    if backend is None:
        backend = default_backend(int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=TIMEOUT)


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(blob_axis_size: Optional[int] = None) -> DeviceMesh:
    """A 2-D mesh over every rank. The first axis ("blobs": independent
    MSMs, which exchange only their results) spans the nodes, the second
    ("points": partial sums of one MSM) stays within a node.
    blob_axis_size defaults to the number of nodes, world size over
    LOCAL_WORLD_SIZE (one node where that is not set)."""
    world = dist.get_world_size()
    if blob_axis_size is None:
        blob_axis_size = max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if world % blob_axis_size != 0:
        raise ValueError(f"{world} ranks not divisible by blob axis {blob_axis_size}")
    return init_device_mesh(
        _mesh_device_type(), (blob_axis_size, world // blob_axis_size), mesh_dim_names=("blobs", "points")
    )


def blobs_mesh() -> DeviceMesh:
    """A 1-D mesh over every rank with the one axis "blobs" (the layout the
    batch entry points take through mesh=...)."""
    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),), mesh_dim_names=("blobs",))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh must have a '{axis}' axis")
    return mesh.size(names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis`: its rank in the axis's group,
    the order in which all_gather stacks the ranks' tensors."""
    axis_size(mesh, axis)
    return dist.get_rank(mesh.get_group(axis))


def shard(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous block of `t` along `dim`, cut into equal
    blocks over `axis`."""
    d = axis_size(mesh, axis)
    if t.shape[dim] % d != 0:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not divide over {d} ranks of '{axis}'")
    k = t.shape[dim] // d
    return t.narrow(dim, axis_index(mesh, axis) * k, k)


def gather_shards(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """The inverse of `shard`: every rank's block along `dim` (0 <= dim <
    t.dim()), joined in the ranks' order."""
    return all_gather(t, mesh, axis).movedim(-1, dim).flatten(dim, dim + 1)


def _through_host(t: torch.Tensor, group) -> bool:
    """gloo takes CUDA tensors in neither all_gather nor all_to_all: the
    collectives copy them to host memory and back."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Every rank's `t` (one shape on all of them) along `axis`, stacked on
    a new last dimension in the order of the ranks' coordinates."""
    group = mesh.get_group(axis)
    staged = _through_host(t, group)
    src = (t.cpu() if staged else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts, dim=-1)
    return out.to(t.device) if staged else out


def all_to_all(t: torch.Tensor, mesh: DeviceMesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Cut `t` into equal blocks along split_dim, send block j to the rank
    at coordinate j on `axis`, and join the blocks received along
    concat_dim in the order of their senders' coordinates."""
    d = axis_size(mesh, axis)
    if t.shape[split_dim] % d != 0:
        raise ValueError(f"dimension {split_dim} of size {t.shape[split_dim]} does not split over {d} ranks")
    group = mesh.get_group(axis)
    staged = _through_host(t, group)
    send = torch.stack(t.chunk(d, dim=split_dim))  # block j, for the rank at j
    send = (send.cpu() if staged else send).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(t.device)
    return torch.cat(recv.unbind(0), dim=concat_dim)
