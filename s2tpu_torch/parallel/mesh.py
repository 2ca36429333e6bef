"""Device mesh for the port: the counterpart of ``s2tpu/parallel/mesh.py``.

A ('data', 'model') ``torch.distributed.device_mesh.DeviceMesh`` over the
process group the caller initialized (``torch.distributed`` has no ambient
cluster: the caller gives ``init_process_group`` its address, world size and
rank; ``parallel.multihost.initialize`` does it from a launcher's
environment). On the card, :func:`make_mesh` binds each process to its own
card first (:func:`local_cuda_index`). Parameters stay replicated on every
rank, as the JAX package keeps them (``replicate_pytree``), and
:func:`replicate_module` makes them rank 0's.

- The 'model' axis: the tensor-parallel ViT (``models/prithvi_mae.py`` with
  ``tp_axis``) splits its heads and MLP hidden over the 'model' group.
- The 'data' axis (:class:`DataAxis`): each rank holds its slice of every
  global batch (the counterpart of ``data_sharding``), and what the JAX
  program reduces over the whole batch is summed over the data group: the
  BatchNorm statistics (differentiably, :meth:`DataAxis.sum`), the loss
  denominators (:meth:`DataAxis.total`), and the gradients and step sums in
  a few flat f32 buckets (:meth:`DataAxis.all_reduce_flat_`).

Not ported yet (ROADMAP A16): ``fsdp_param_shardings`` on a model axis above
one rank (FSDP2); with a model axis of one the JAX package replicates too.
"""

from __future__ import annotations

import dataclasses
import os
import typing

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
BUCKET_BYTES = 64 << 20  # one flat f32 all-reduce of the gradients: B5's ~134 MB go in three


def local_cuda_index() -> int:
    """This process's card: ``LOCAL_RANK`` where a launcher set it
    (torchrun), else the global rank modulo the host's cards."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()


def make_mesh(num_devices: int = -1, model_parallel: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """('data', 'model') mesh over the initialized process group's
    ``num_devices`` ranks (-1: all of them), ``model_parallel`` ranks on the
    model axis and the rest on the data axis; one device per rank, the card
    by default, which becomes the process's current device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if num_devices == -1 else num_devices
    if n != world:
        raise ValueError(f"the mesh spans the whole process group: {n} devices asked, world size {world}")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices do not split into a model axis of {model_parallel}")
    if device_type == "cuda":
        torch.cuda.set_device(local_cuda_index())
    return init_device_mesh(device_type, (n // model_parallel, model_parallel), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_for_num_devices(num_devices: int, device_type: str, cli: str) -> DeviceMesh | None:
    """The mesh of a trainer's ``train.num_devices`` without one given (the
    JAX trainers build ``make_mesh(num_devices)``): None for one device (1,
    or -1 outside a process group of several ranks); else a data axis over
    the initialized process group, which must hold ``num_devices`` ranks
    (``cli``, the module that starts them, is named in the error)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices == 1 or (num_devices == -1 and world == 1):
        return None
    if num_devices != -1 and num_devices != world:
        raise RuntimeError(
            f"num_devices={num_devices} needs a process group of {num_devices} ranks, one process and one card "
            f"each, and this process has {world}: run `python -m {cli} ... --num-devices {num_devices}`, which "
            f"starts them, or launch the ranks with `torchrun --nproc-per-node {num_devices} -m {cli} ... "
            f"--num-devices {num_devices}`, or pass mesh= from parallel.mesh.make_mesh after init_process_group"
        )
    return make_mesh(world, 1, device_type)


def axis_size(mesh, name: str) -> int:
    """Ranks on the axis ``name`` of ``mesh``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@torch.no_grad()
def replicate_module(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank of ``mesh``
    (the whole process group, :func:`make_mesh`) in place (the counterpart of
    ``replicate_pytree``); returns ``module``."""
    del mesh  # the mesh spans the default group
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


class _Sum(torch.autograd.Function):
    """The sum of ``x`` over ``group``; the gradient of every rank's input
    is the sum of the ranks' output gradients (each rank's loss uses the
    sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """This rank's place on the data axis: the axis's process ``group``, the
    rank's ``index`` on it and its ``size``. Each rank holds rows
    ``[index * n, (index + 1) * n)`` of every global batch of ``size * n``
    rows (:meth:`local`), as ``data_sharding`` lays a batch out.

    Every collective here runs on the current stream's order with no host
    sync, so that a CUDA graph of a whole step captures it over NCCL
    (:attr:`capturable`): the BatchNorm sums (:meth:`sum`, forward and
    backward), the loss denominators (:meth:`total`) and the gradient
    buckets (:meth:`all_reduce_flat_`), whose flat buffers are persistent,
    one set per list of shapes, so that a replay finds them at the
    addresses its capture saw."""

    group: typing.Any = None
    index: int = 0
    size: int = 1
    # (shapes, dtype, device) of an all_reduce_flat_ list -> its flat buffers
    _buckets: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this axis's collectives: one rank,
        or an NCCL group (gloo's collectives on card tensors pass through
        the host)."""
        return self.size == 1 or dist.get_backend(self.group) == "nccl"

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice of the global ``x`` along ``dim``."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the axis, differentiably."""
        return x if self.size == 1 else _Sum.apply(x, self.group)

    def total(self, x: torch.Tensor | int | float) -> torch.Tensor | int | float:
        """A loss denominator over the global batch from this rank's: a
        tensor is summed over the axis (outside autograd); a count of
        elements, equal on every rank, is multiplied by the axis size."""
        if self.size == 1:
            return x
        if not isinstance(x, torch.Tensor):
            return x * self.size
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_reduce_flat_(self, tensors: list[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> None:
        """Sum each of ``tensors`` (f32) over the axis in place, packed into
        flat buffers of at most ``bucket_bytes`` (one tensor larger than that
        goes alone): a few collectives where one a tensor would be hundreds."""
        if self.size == 1:
            return
        for bucket, flat in self._flat_buffers(tensors, bucket_bytes):
            torch.cat([b.reshape(-1) for b in bucket], out=flat)
            dist.all_reduce(flat, group=self.group)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))

    def _flat_buffers(self, tensors: list[torch.Tensor], bucket_bytes: int) -> list[tuple[list, torch.Tensor]]:
        """``tensors`` in consecutive buckets, each with its persistent flat
        buffer (made at the first call with these shapes)."""
        key = (tuple(tuple(t.shape) for t in tensors), tensors[0].dtype, tensors[0].device, bucket_bytes)
        if key not in self._buckets:
            groups: list[list[int]] = []
            nbytes = 0
            for i, t in enumerate(tensors):
                size = t.numel() * t.element_size()
                if not groups or nbytes + size > bucket_bytes:
                    groups.append([])
                    nbytes = 0
                groups[-1].append(i)
                nbytes += size
            self._buckets[key] = [
                (g[0], g[-1] + 1, torch.empty(sum(tensors[i].numel() for i in g), dtype=tensors[0].dtype,
                                              device=tensors[0].device))
                for g in groups
            ]
        return [(tensors[start:stop], flat) for start, stop, flat in self._buckets[key]]


SINGLE = DataAxis()


def data_axis(mesh: DeviceMesh | None) -> DataAxis:
    """The data axis of ``mesh`` as this rank sees it (:data:`SINGLE`
    without a mesh)."""
    if mesh is None or axis_size(mesh, DATA_AXIS) == 1:
        return SINGLE
    return DataAxis(mesh.get_group(DATA_AXIS), mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS))
