"""Device meshes for the port's SPMD parallelism (counterpart of
gcm_tpu/parallel/mesh.py).

The JAX package names its mesh axes ``dp`` (data parallel over the batch)
and ``tp`` (tensor parallel over the GNN feature dims) and lets GSPMD
split arrays by PartitionSpecs. Here one process runs one shard: the mesh
is a `torch.distributed.device_mesh.DeviceMesh` with mesh_dim_names
("dp", "tp") over the ranks of the default process group, a rank's
coordinate on an axis is its rank in that axis' group, and a `Spec` says
which dimension of a tensor the ranks of an axis hold blocks of.
`shard_tensor` cuts a global tensor to the rank's block and
`gather_tensor` puts the blocks back together.

NCCL carries the collectives of CUDA tensors and gloo those of CPU
tensors; a gloo world whose tensors live on the card (several ranks on
one card, which NCCL refuses) gets a mesh of device type "cpu", and
`parallel/comm.py` stages the collectives gloo cannot run on CUDA
tensors through host memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

AXES = ("dp", "tp")


def make_mesh(dp: int | None = None, tp: int = 1, device_type: str = "cuda"):
    """A (dp, tp) DeviceMesh over the initialised world; dp defaults to
    world_size // tp. device_type="cuda" (the default) raises when there
    is no card, as every entry point of the port does."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh builds a CUDA mesh by default and no card is "
            "available; pass device_type='cpu' to run on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type {device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: "
            "initialize_multihost, world_of_one or spawn_world "
            "(parallel/distributed.py)")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks do not divide by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} must equal the world's {n} ranks")
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(mesh_type, (dp, tp), mesh_dim_names=AXES)


def axis_group(mesh, axis: str):
    """The process group of the mesh axis `axis` that holds this rank."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on `axis` (JAX's lax.axis_index)."""
    return mesh.get_local_rank(axis)


def bind_batch(module, group) -> None:
    """Make every batch-wide mean inside module (EuclideanEdge's score,
    a mean over the batch's current nodes) run over the rows of every
    rank of `group`, as GSPMD keeps JAX's mean global under dp. The
    data-parallel wrappers call it when they are built, so a forward, a
    checkpoint's recompute and a reversible replay in the backward all
    read the same group. group None (or a group of one rank) unbinds."""
    from gcm_tpu_torch.parallel.comm import GroupRef

    ref = None
    if group is not None and dist.get_world_size(group) > 1:
        ref = GroupRef(group)
    for m in module.modules():
        if hasattr(m, "batch_group"):
            m.batch_group = ref


@dataclass(frozen=True)
class Spec:
    """Which mesh axis each tensor dimension is split over (None: whole),
    trailing dimensions whole: the PartitionSpec of a NamedSharding."""
    mesh: object
    dims: tuple = ()


def batch_sharding(mesh, ndim: int) -> Spec:
    """The leading (batch) dimension split over dp, the rest whole."""
    return Spec(mesh, ("dp",) + (None,) * (ndim - 1))


def replicated(mesh) -> Spec:
    return Spec(mesh, ())


def block(n: int, parts: int, index: int) -> slice:
    """The index-th of `parts` equal blocks of range(n)."""
    if n % parts:
        raise ValueError(f"{n} does not split into {parts} equal blocks")
    nb = n // parts
    return slice(index * nb, (index + 1) * nb)


def shard_tensor(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's block of the global tensor t under spec (a view)."""
    for dim, axis in enumerate(spec.dims):
        if axis is not None:
            sl = block(t.shape[dim], axis_size(spec.mesh, axis),
                       axis_rank(spec.mesh, axis))
            t = t.narrow(dim, sl.start, sl.stop - sl.start)
    return t


def gather_tensor(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The global tensor from every rank's block (no gradient)."""
    from gcm_tpu_torch.parallel.comm import all_gather_data

    for dim, axis in enumerate(spec.dims):
        if axis is not None:
            t = all_gather_data(t, axis_group(spec.mesh, axis), dim)
    return t
