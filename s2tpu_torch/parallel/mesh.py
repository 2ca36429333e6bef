"""Device mesh for the port: the counterpart of ``s2tpu/parallel/mesh.py``.

A ('data', 'model') ``torch.distributed.device_mesh.DeviceMesh`` over the
process group the caller initialized (``torch.distributed`` has no ambient
cluster: the caller gives ``init_process_group`` its address, world size and
rank). On the card, :func:`make_mesh` binds each process to its own card
first (:func:`local_cuda_index`). The tensor-parallel ViT
(``models/prithvi_mae.py`` with ``tp_axis``) splits its heads and MLP hidden
over the 'model' group; its parameters stay replicated on every rank, as the
JAX package keeps them (``replicate_pytree``), and :func:`replicate_module`
makes them rank 0's.

Not ported yet (ROADMAP A16): data parallelism over more than one rank
(DDP/FSDP2 in place of ``data_sharding`` and ``fsdp_param_shardings``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def local_cuda_index() -> int:
    """This process's card: ``LOCAL_RANK`` where a launcher set it
    (torchrun), else the global rank modulo the host's cards."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()


def make_mesh(num_devices: int = -1, model_parallel: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """('data', 'model') mesh over the initialized process group's
    ``num_devices`` ranks (-1: all of them), ``model_parallel`` ranks on the
    model axis; one device per rank, the card by default, which becomes the
    process's current device. Raises when the data axis would hold more than
    one rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if num_devices == -1 else num_devices
    if n != world:
        raise ValueError(f"the mesh spans the whole process group: {n} devices asked, world size {world}")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} devices do not split into a model axis of {model_parallel}")
    if n // model_parallel > 1:
        raise NotImplementedError(
            f"a data axis of {n // model_parallel} ranks is not ported to s2tpu_torch yet (DDP/FSDP2, "
            "ROADMAP A16); use a mesh whose ranks all lie on the model axis"
        )
    if device_type == "cuda":
        torch.cuda.set_device(local_cuda_index())
    return init_device_mesh(device_type, (n // model_parallel, model_parallel), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@torch.no_grad()
def replicate_module(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters to every rank of ``mesh`` in place (the
    counterpart of ``replicate_pytree``); returns ``module``."""
    group = mesh.get_group(MODEL_AXIS)  # the whole mesh while the data axis holds one rank
    src = dist.get_global_rank(group, 0)
    for p in module.parameters():
        dist.broadcast(p.data, src=src, group=group)
    return module
