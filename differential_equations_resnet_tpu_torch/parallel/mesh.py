"""Meshes of ranks, and where a batch and the parameters live on them.

Port of `differential_equations_resnet_tpu/parallel/mesh.py`.  A port mesh
is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, with named axes (``data``, ``model``, ``pipe``):
one process a device, NCCL between CUDA devices and gloo on the CPU.  The
JAX package runs one program over every device of its mesh and lets XLA
place the collectives; here every rank runs the same Python program on its
own share and the collectives are explicit (`parallel.collectives`).

- ``data``: the batch is split over it (`shard_batch`, in the JAX
  device-major order: the rank at coordinate i on ``data`` holds rows
  [i*B/d, (i+1)*B/d)); the parameters are replicated (`shard_params`) and
  the train step averages the gradients over it.
- ``model``: channel tensor parallelism of the identity stacks
  (`parallel.tensor_parallel`).
- ``pipe``: the identity stack pipelined over depth (`parallel.pipeline`).

A single process gets a world of one through an in-memory store, with no
environment variables and no launcher; several processes call
`initialize_multihost` (or ``torch.distributed.init_process_group``)
first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from differential_equations_resnet_tpu_torch import resolve_device


def backend_for(device_type: str) -> str:
    """The process-group backend for tensors on ``device_type``: NCCL
    between CUDA devices (gloo for the CPU side of the same group), gloo on
    the CPU."""
    return "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device_type: str) -> None:
    """The default process group, made here as a world of one (an in-memory
    store, rank 0) where none exists yet."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
):
    """A mesh of ``shape`` over the ranks ``devices`` (default: every rank
    of the world, in order), its axes named ``axis_names``.  Default shape:
    the whole world on the first axis.  Every rank of the world calls it;
    a rank outside the mesh (``devices`` or ``shape`` left it out) gets a
    mesh in which it has no coordinate.  ``device_type`` is "cuda" unless
    the caller names the CPU (see `resolve_device`).  Raises `ValueError`
    when the shape needs more ranks than there are."""
    device_type = resolve_device(device_type).type
    ensure_process_group(device_type)
    if devices is None:
        devices = list(range(dist.get_world_size()))
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > len(devices):
        raise ValueError(f"Mesh shape {shape} needs {n} devices, have {len(devices)}.")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.as_tensor(np.asarray(list(devices)[:n]).reshape(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=axis_names)


def axis_size(mesh, axis: str) -> int:
    """The size of the mesh's axis ``axis``; 1 for an axis it does not have."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.shape[names.index(axis)]) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 for an axis the mesh does not
    have)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 0
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return int(coordinate[names.index(axis)])


def batch_sharding(mesh, batch_axis: str = "data"):
    """The placements of a batch on the mesh: rows split over
    ``batch_axis``, replicated over every other axis (DTensor placements,
    one per mesh axis).  A description: it moves no data."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    return tuple(Shard(0) if name == batch_axis else Replicate() for name in names)


def replicated_sharding(mesh):
    """The placements of a replicated tensor: `Replicate` on every axis."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def _rows(x, index: int, count: int):
    n = x.shape[0]
    if n % count:
        raise ValueError(
            f"a batch of {n} rows does not split evenly over {count} ranks of the data axis")
    per = n // count
    return x[index * per:(index + 1) * per]


def _map(fn, tree):
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh, batch, batch_axis: str = "data"):
    """This rank's rows of a global batch (a tensor or array, or a tuple,
    list or dict of them, each with a leading batch axis): the block at this
    rank's coordinate on ``batch_axis``, as JAX places a batch sharded over
    that axis.  Views, not copies."""
    index, count = axis_index(mesh, batch_axis), axis_size(mesh, batch_axis)
    return _map(lambda x: _rows(x, index, count), batch)


def shard_params(mesh, params):
    """Make every rank of the mesh hold the values of the rank at the
    mesh's origin: each tensor of ``params`` (a tree of tensors or an
    `nn.Module`, whose parameters and buffers are taken) broadcast in place
    along each mesh axis in turn.  Returns ``params``."""
    if isinstance(params, torch.nn.Module):
        tensors = list(params.parameters()) + list(params.buffers())
    else:
        tensors = []
        _map(lambda t: tensors.append(t) if isinstance(t, torch.Tensor) else None, params)
    with torch.no_grad():
        for dim in range(mesh.ndim):
            group = mesh.get_group(dim)
            src = dist.get_global_rank(group, 0)
            for t in tensors:
                dist.broadcast(t.data, src=src, group=group)
    return params


def local_batch_slice(global_batch_size: int) -> slice:
    """The slice of a globally indexed batch that this process feeds (one
    process a device here: its rank's share of the world)."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch_size // count
    return slice(index * per, (index + 1) * per)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join ``num_processes`` processes into the default process group over
    TCP at ``coordinator_address`` ("host:port"; process 0 listens there):
    NCCL for CUDA tensors (gloo for CPU ones) where CUDA is present, each
    process then on the card ``process_id`` modulo the host's cards (one
    process a card, as `DeviceMesh` assumes); else gloo.  A no-op for one
    process."""
    if num_processes is None or num_processes <= 1:
        return
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend_for("cuda" if cuda else "cpu"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
