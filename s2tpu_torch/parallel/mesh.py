"""Device mesh for the port: the counterpart of ``s2tpu/parallel/mesh.py``.

A ('data', 'model') ``torch.distributed.device_mesh.DeviceMesh`` over the
process group the caller initialized (``torch.distributed`` has no ambient
cluster: the caller gives ``init_process_group`` its address, world size and
rank; ``parallel.multihost.initialize`` does it from a launcher's
environment). On the card, :func:`make_mesh` binds each process to its own
card first (:func:`local_cuda_index`). Parameters are replicated on every
rank, as the JAX package keeps them (``replicate_pytree``), and
:func:`replicate_module` makes them rank 0's.

- The 'model' axis (:class:`ModelAxis`): the tensor-parallel ViT
  (``models/prithvi_mae.py`` with ``tp_axis``) splits its heads and MLP
  hidden over the 'model' group, and with ``cp_axis`` its tokens between
  the blocks (:meth:`ModelAxis.split`, :meth:`ModelAxis.gather`,
  :meth:`ModelAxis.gather_summed`, :meth:`ModelAxis.reduce_scatter`).
  With ``param_sharding="fsdp"`` the segmentation trainer shards its
  parameters over it (:class:`ShardedParameters`, the counterpart of
  ``fsdp_param_shardings``).
- The 'data' axis (:class:`DataAxis`): each rank holds its slice of every
  global batch (the counterpart of ``data_sharding``), and what the JAX
  program reduces over the whole batch is summed over the data group: the
  BatchNorm statistics (differentiably, :meth:`DataAxis.sum`), the loss
  denominators (:meth:`DataAxis.total`), and the gradients and step sums in
  a few flat f32 buckets (:meth:`DataAxis.all_reduce_flat_`).

A batch is laid out over the data axis only (``P('data')``), so the ranks of
one model group hold the same rows and compute the same gradient of every
parameter they all see whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import typing

import torch
import torch.distributed as dist
from torch import nn
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


def mesh_for_num_devices(num_devices: int, device_type: str, cli: str, model_parallel: int = 1) -> DeviceMesh | None:
    """The mesh of a trainer's ``train.num_devices`` without one given (the
    JAX trainers build ``make_mesh(num_devices, model_parallel=...)``): None
    for one device (1, or -1 outside a process group of several ranks); else
    the initialized process group, which must hold ``num_devices`` ranks
    (``cli``, the module that starts them, is named in the error), as a data
    axis x a model axis of ``model_parallel`` ranks."""
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
    return make_mesh(world, model_parallel, device_type)


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
class Axis:
    """This rank's place on one axis of the mesh: the axis's process
    ``group``, the rank's ``index`` on it and its ``size``.

    Every collective here runs on the current stream's order with no host
    sync, so that a CUDA graph of a whole step captures it over NCCL
    (:attr:`capturable`); the flat buffers of :meth:`all_reduce_flat_` are
    persistent, one set per list of shapes, so that a replay finds them at
    the addresses its capture saw."""

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
        """This rank's slice of ``x`` along ``dim`` (``size`` equal slices)."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

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


class DataAxis(Axis):
    """This rank's place on the data axis. Each rank holds rows
    ``[index * n, (index + 1) * n)`` of every global batch of ``size * n``
    rows (:meth:`local`), as ``data_sharding`` lays a batch out; the
    BatchNorm sums (:meth:`sum`, forward and backward), the loss
    denominators (:meth:`total`) and the gradient buckets
    (:meth:`all_reduce_flat_`) run over its group."""

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


class ModelAxis(Axis):
    """This rank's place on the model axis, whose ranks hold the same rows.

    Its collectives along one dimension of a tensor, each with the backward
    that its consumers call for (tokens between context-parallel ViT blocks,
    parameter shards of FSDP):

    - :meth:`gather`: the ranks' slices joined; consumers of the whole are
      the same on every rank, so the backward keeps this rank's slice of the
      gradient (no collective).
    - :meth:`split`: this rank's slice of a tensor every rank holds whole;
      the backward joins the slices' gradients.
    - :meth:`gather_summed`: the slices joined for consumers that differ by
      rank (a head's or hidden column's share); the backward sums the
      ranks' gradients and keeps this rank's slice (a reduce-scatter).
    - :meth:`reduce_scatter`: the ranks' partial sums summed, this rank's
      slice kept; the backward joins the slices' gradients.

    Over NCCL the collectives are the tensor forms (one all-gather or
    reduce-scatter into one buffer); over gloo the list all-gather and an
    all-reduce followed by the slice, which gloo runs on every device."""

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Collective.apply(x, self, dim, "all_gather", "slice")

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Collective.apply(x, self, dim, "slice", "all_gather")

    def gather_summed(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Collective.apply(x, self, dim, "all_gather", "sum_local")

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _Collective.apply(x, self, dim, "sum_local", "all_gather")

    def _nccl(self) -> bool:
        return dist.get_backend(self.group) == "nccl"

    def slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``x`` along ``dim``, contiguous."""
        return self.local(x, dim).contiguous()

    def all_gather(self, x: torch.Tensor, dim: int, stride: tuple[int, ...] | None = None) -> torch.Tensor:
        """The ranks' equal slices ``x`` joined along ``dim`` (no autograd),
        in ``stride`` when given (:func:`_join`)."""
        x = x.contiguous()
        if self._nccl():
            out = torch.empty((self.size, *x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            out = torch.stack(parts)
        return _join(out, dim, stride)

    def sum_local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the ranks, this rank's slice along ``dim`` kept
        (no autograd)."""
        if self._nccl():
            moved = x.movedim(dim, 0).contiguous()
            out = torch.empty((moved.shape[0] // self.size, *moved.shape[1:]), dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, moved, group=self.group)
            return out.movedim(0, dim)
        full = x.contiguous()
        dist.all_reduce(full, group=self.group)
        return self.slice(full, dim)


def _join(parts: torch.Tensor, dim: int, stride: tuple[int, ...] | None = None) -> torch.Tensor:
    """The equal slices ``parts`` (stacked on a leading axis of the ranks)
    joined along ``dim`` of a slice; in ``stride`` when given, the whole
    parameter's strides (channels-last convs stay so)."""
    shape = parts.shape[1:]
    whole = parts.movedim(0, dim).reshape(*shape[:dim], -1, *shape[dim + 1:])
    if stride is None or whole.stride() == stride:
        return whole
    return torch.empty_strided(whole.shape, stride, dtype=whole.dtype, device=whole.device).copy_(whole)


class _Collective(torch.autograd.Function):
    """A :class:`ModelAxis` collective along ``dim`` (its method
    ``forward``) whose backward is the method ``backward``."""

    @staticmethod
    def forward(ctx, x, axis: ModelAxis, dim: int, forward: str, backward: str):
        ctx.axis, ctx.dim, ctx.backward_op = axis, dim, backward
        return getattr(axis, forward)(x, dim)

    @staticmethod
    def backward(ctx, g):
        return getattr(ctx.axis, ctx.backward_op)(g, ctx.dim), None, None, None, None


SINGLE = DataAxis()
MODEL_SINGLE = ModelAxis()


def data_axis(mesh: DeviceMesh | None) -> DataAxis:
    """The data axis of ``mesh`` as this rank sees it (:data:`SINGLE`
    without a mesh)."""
    if mesh is None or axis_size(mesh, DATA_AXIS) == 1:
        return SINGLE
    return DataAxis(mesh.get_group(DATA_AXIS), mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS))


def model_axis(mesh: DeviceMesh | None) -> ModelAxis:
    """The model axis of ``mesh`` as this rank sees it (:data:`MODEL_SINGLE`
    without a mesh)."""
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return MODEL_SINGLE
    return ModelAxis(mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS), axis_size(mesh, MODEL_AXIS))


# ---------------------------------------------------------------------------
# FSDP: parameters sharded over the model axis (``fsdp_param_shardings``)
# ---------------------------------------------------------------------------
FSDP_MIN_SIZE = 2**16


def largest_divisible_axis(shape: typing.Sequence[int], n: int) -> int | None:
    """The largest axis of ``shape`` that ``n`` divides, the first on a tie;
    None when there is none (``s2tpu/parallel/mesh.py:47-54``)."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best, best_size = i, s
    return best


def reference_axes(module: nn.Module, tensor: torch.Tensor) -> list[tuple[int, ...]]:
    """The axes of the JAX package's kernel behind a parameter of
    ``module``, each as the torch dimensions it flattens, in order
    (``checkpoint/convert.py``'s layouts): a conv (O, I, kh, kw) is flax's
    (kh, kw, I, O) (a 1x1 conv's Dense kernel (I, O) drops two axes of 1,
    which no model axis above one shards); a transpose conv (I, O, kh, kw)
    is (kh, kw, I, O); a dense (O, I) is (I, O); the tubelet patch
    embedding's Conv3d (D, C, t, p, q) is the Dense kernel (t·p·q·C, D);
    anything else keeps its axes."""
    if tensor.dim() == 4 and isinstance(module, nn.ConvTranspose2d):
        return [(2,), (3,), (0,), (1,)]
    if tensor.dim() == 4 and isinstance(module, nn.Conv2d):
        return [(2,), (3,), (1,), (0,)]
    if tensor.dim() == 2 and isinstance(module, nn.Linear):
        return [(1,), (0,)]
    if tensor.dim() == 5 and isinstance(module, nn.Conv3d):
        return [(2, 3, 4, 1), (0,)]
    return [(d,) for d in range(tensor.dim())]


def fsdp_shard_dim(module: nn.Module, tensor: torch.Tensor, n: int, min_size: int = FSDP_MIN_SIZE) -> int | None:
    """The torch dimension the FSDP rule shards ``module``'s parameter
    ``tensor`` on over a model axis of ``n`` ranks, None to replicate it:
    as ``fsdp_param_shardings``, a tensor of at least ``min_size`` elements
    is sharded on its kernel's largest axis that ``n`` divides (the first on
    a tie, in the JAX package's axis order, :func:`reference_axes`). An axis
    that flattens several torch dimensions is split on the first of them
    whose size is not 1, which holds contiguous equal parts of it when
    ``n`` divides that size (else the tensor is refused)."""
    if n == 1 or tensor.numel() < min_size:
        return None
    axes = reference_axes(module, tensor)
    axis = largest_divisible_axis([math.prod(tensor.shape[d] for d in dims) for dims in axes], n)
    if axis is None:
        return None
    dim = next((d for d in axes[axis] if tensor.shape[d] != 1), axes[axis][0])
    if tensor.shape[dim] % n:
        raise ValueError(f"a {tuple(tensor.shape)} parameter's shard axis {axes[axis]} does not split into "
                         f"{n} contiguous parts on one dimension")
    return dim


@dataclasses.dataclass(frozen=True)
class _Shard:
    module: nn.Module
    attr: str  # the parameter's name in ``module``
    dim: int  # the torch dimension it is sharded on
    stride: tuple[int, ...]  # the whole tensor's strides (channels-last convs stay so)


class ShardedParameters:
    """FSDP over the model axis (``s2tpu/train/trainer.py:341-362``): every
    parameter of ``model`` that the rule shards (:func:`fsdp_shard_dim`) is
    replaced in place by this rank's contiguous slice, so the optimizer,
    the f32 master and the EMA, built on the parameters, hold slices too
    and update them elementwise; the rest stay whole (replicated).

    Inside :meth:`gathered` each sharded parameter's module sees the whole
    tensor under the parameter's name: one all-gather a dtype
    (:class:`_GatherParameters`), whose backward keeps this rank's slice of
    the whole gradient. The ranks of a model group hold the same rows
    (``P('data')``), so each computes the same whole gradient and the slice
    needs no collective: a reduce-scatter would count it ``size`` times.
    The data axis then sums the slices' gradients as it sums whole ones.
    Checkpoints hold whole tensors (:meth:`full`, a collective of every
    rank), which a rank reads back into its slices (:meth:`local`)."""

    def __init__(self, model: nn.Module, axis: ModelAxis, min_size: int = FSDP_MIN_SIZE) -> None:
        self.axis = axis
        self.shards: dict[str, _Shard] = {}
        modules = dict(model.named_modules())
        with torch.no_grad():
            for name, p in model.named_parameters():
                mod_name, _, attr = name.rpartition(".")
                module = modules[mod_name]
                dim = fsdp_shard_dim(module, p, axis.size, min_size)
                if dim is None:
                    continue
                self.shards[name] = _Shard(module, attr, dim, tuple(p.stride()))
                p.data = axis.slice(p.data, dim)
        self._params = dict(model.named_parameters())

    def __contains__(self, name: str) -> bool:
        return name in self.shards

    @contextlib.contextmanager
    def gathered(self) -> typing.Iterator[None]:
        """Inside the block every sharded parameter's module reads the whole
        tensor as the parameter (an instance attribute in front of it), in
        the parameter's dtype and strides; the parameter itself stays this
        rank's slice."""
        names = list(self.shards)
        fulls = _GatherParameters.apply(self, names, *(self._params[n] for n in names))
        try:
            for name, full in zip(names, fulls):
                s = self.shards[name]
                s.module.__dict__[s.attr] = full
            yield
        finally:
            for s in self.shards.values():
                s.module.__dict__.pop(s.attr, None)

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of sharded tensor ``name`` from the ranks' slices ``t``
        (a collective), in the strides of the parameter's whole tensor."""
        s = self.shards[name]
        return self.axis.all_gather(t, s.dim, s.stride)

    @torch.no_grad()
    def full(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A state dict keyed by parameter names (the model's, the master's,
        the EMA's) with every sharded entry whole: a collective that every
        rank of the model axis makes, in the same order."""
        return {n: self._whole(n, t) if n in self.shards else t for n, t in state.items()}

    def local(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The inverse of :meth:`full`: this rank's slice of every sharded
        entry of a whole state dict."""
        return {n: self.axis.slice(t, self.shards[n].dim) if n in self.shards else t for n, t in state.items()}

    def _optimizer_state(self, state: dict, names: list[str], part) -> dict:
        """Adam's state dict with ``part(name, tensor)`` applied to the
        moments of each sharded parameter (``names``: the optimizer's
        parameters in order)."""
        per = {i: {k: part(names[i], v) if names[i] in self.shards and torch.is_tensor(v) and v.dim() else v
                   for k, v in st.items()} for i, st in state["state"].items()}
        return {**state, "state": per}

    @torch.no_grad()
    def full_optimizer(self, state: dict, names: list[str]) -> dict:
        return self._optimizer_state(state, names, self._whole)

    def local_optimizer(self, state: dict, names: list[str]) -> dict:
        return self._optimizer_state(state, names, lambda n, t: self.axis.slice(t, self.shards[n].dim))


class _GatherParameters(torch.autograd.Function):
    """The whole tensors of ``names`` from their slices, one all-gather a
    dtype; the backward keeps each whole gradient's slice of this rank."""

    @staticmethod
    def forward(ctx, sharded: ShardedParameters, names: list[str], *slices):
        ctx.sharded, ctx.names = sharded, names
        axis, fulls = sharded.axis, [None] * len(slices)
        for dtype in dict.fromkeys(t.dtype for t in slices):
            idx = [i for i, t in enumerate(slices) if t.dtype == dtype]
            flat = axis.all_gather(torch.cat([slices[i].reshape(-1) for i in idx]), 0).view(axis.size, -1)
            offset = 0
            for i in idx:
                t, s = slices[i], sharded.shards[names[i]]
                fulls[i] = _join(flat[:, offset:offset + t.numel()].reshape(axis.size, *t.shape), s.dim, s.stride)
                offset += t.numel()
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        axis = ctx.sharded.axis
        return (None, None, *(None if g is None else axis.slice(g, ctx.sharded.shards[n].dim)
                              for n, g in zip(ctx.names, grads)))
