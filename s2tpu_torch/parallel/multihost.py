"""Several processes, one rank and one device each: the counterpart of ``s2tpu/parallel/multihost.py``.

In the torch idiom every rank of a data axis is a process of its own, on one
card or on the CPU. This module supplies what the trainers and the CLI need
around ``torch.distributed``:

1. :func:`initialize`: the process group, from a launcher's environment
   (torchrun sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``PORT``) or
   from explicit arguments (a ``file://`` or ``tcp://`` store, as a spawning
   parent gives its children).
2. Input slicing: every process draws the same epoch order, crops and flips
   from the same seeds and feeds only its slice of each global batch
   (:func:`local_slice`, :func:`local_rows`), so no input crosses
   processes.
3. :func:`put_batch`: a rank's slice of a host array on its device (the
   global array of the JAX package is the slices of all ranks together).
4. The training CLIs' ranks: :func:`num_ranks` reads ``--num-devices``
   against a launcher or the visible cards, and :func:`spawn_ranks` runs a
   CLI's ``main`` as N ranks on this host when no launcher started them.
"""

from __future__ import annotations

import logging
import os
import tempfile
import typing

import numpy as np
import torch
import torch.distributed as dist

from s2tpu_torch.parallel.mesh import make_mesh
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


def under_launcher() -> bool:
    """Whether a launcher (torchrun) started this process as one rank of a
    group: its environment names the world."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> None:
    """Bring up the default process group: from the launcher's environment
    when no argument is given (``env://``), else from ``init_method``,
    ``world_size`` and ``rank``. ``backend`` defaults to NCCL where there is
    a card and gloo elsewhere. A no-op (with a warning) when a group is up."""
    if dist.is_initialized():
        logger.warning("torch.distributed is already initialized; skipping")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    if process_index() == 0:  # only rank 0 logs
        logger.info(f"distributed: {process_count()} processes ({backend})")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_slice(global_batch_size: int, n_proc: int | None = None, index: int | None = None) -> slice:
    """This process's contiguous slice of a global batch."""
    n = n_proc if n_proc is not None else process_count()
    i = index if index is not None else process_index()
    assert global_batch_size % n == 0, f"global batch {global_batch_size} must divide process count {n}"
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def local_rows(global_batch_size: int, micro_batches: int = 1, n_proc: int | None = None,
               index: int | None = None) -> np.ndarray:
    """This process's rows of a global batch that trains as ``micro_batches``
    micro-batches: its :func:`local_slice` of each global micro-batch, in
    micro-batch order, so that the m-th of its own ``micro_batches`` chunks
    is its share of global micro-batch m (BatchNorm then sees the samples
    together that the one-process step puts together)."""
    assert global_batch_size % micro_batches == 0, (
        f"global batch {global_batch_size} does not split into {micro_batches} micro-batches"
    )
    micro = global_batch_size // micro_batches
    sl = local_slice(micro, n_proc, index)
    return np.concatenate([np.arange(m * micro + sl.start, m * micro + sl.stop) for m in range(micro_batches)])


def put_batch(array: np.ndarray, device: torch.device | str, rows: np.ndarray | slice | None = None) -> torch.Tensor:
    """This process's ``rows`` of the global host ``array`` (None: its
    :func:`local_slice`, all of it in one process) on ``device``."""
    if rows is None:
        rows = local_slice(len(array))
    return torch.from_numpy(np.ascontiguousarray(array[rows])).to(device)


def num_ranks(num_devices: int, device: torch.device) -> int:
    """The data axis ``--num-devices`` asks for: a launcher's (or an
    initialized group's) world size for -1, which it must equal otherwise;
    without one, -1 takes every visible card (one process on the CPU).
    Asking for more cards than are visible is an error."""
    world = None
    if dist.is_initialized():
        world = dist.get_world_size()
    elif under_launcher():
        world = int(os.environ["WORLD_SIZE"])
    if world is not None:
        if num_devices not in (-1, world):
            raise SystemExit(f"--num-devices {num_devices} under a launcher of {world} ranks: they must be equal")
        return world
    n = (torch.cuda.device_count() if device.type == "cuda" else 1) if num_devices == -1 else num_devices
    if n < 1:
        raise SystemExit(f"--num-devices {num_devices}: give a positive count, or -1 for every visible card")
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--num-devices {n} asks for more cards than the {torch.cuda.device_count()} visible")
    return n


def spawn_ranks(main: typing.Callable[[list[str]], typing.Any], argv: list[str], n: int,
                device: torch.device) -> typing.Any:
    """Run ``main(argv)`` as ``n`` ranks on this host, one process each (one
    card each on the card, NCCL over the loopback; gloo on the CPU), meeting
    through a file store in a temporary directory; returns rank 0's
    result. ``main`` is a module-level function: the ranks import it."""
    import torch.multiprocessing as mp

    if device.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # every rank is on this host
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(main, argv, n, f"file://{tmp}/store", backend, f"{tmp}/result.pt"), nprocs=n)
        return torch.load(f"{tmp}/result.pt", weights_only=False)


def _rank_main(rank: int, main: typing.Callable[[list[str]], typing.Any], argv: list[str], n: int,
               init_method: str, backend: str, result: str) -> None:
    """One spawned rank: the process group, then ``main(argv)``; rank 0
    leaves its result in ``result``."""
    initialize(init_method, n, rank, backend)
    if backend == "gloo":  # the CPU's threads shared out among the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    try:
        out = main(argv)
        if rank == 0:
            torch.save(out, result)
    finally:
        dist.destroy_process_group()


def data_axis_mesh(n: int, device: torch.device, model_parallel: int = 1):
    """A CLI's mesh of ``n`` ranks, in a process that is one of them: brings
    up a launcher's process group (torchrun) when none is up, checks that
    the group holds ``n`` ranks and returns its mesh, a data axis x a model
    axis of ``model_parallel`` ranks (the MAE CLI's pipeline stages; None
    for one rank). Only rank 0 logs INFO; the others' warnings still show."""
    if n > 1 and not dist.is_initialized():
        initialize(backend="nccl" if device.type == "cuda" else "gloo")
    world = process_count()
    if n != world:
        raise SystemExit(f"--num-devices {n} in a process group of {world} ranks: they must be equal")
    if process_index() != 0:
        logging.disable(logging.INFO)
    return make_mesh(n, model_parallel, device.type) if n > 1 else None


def share_run_name(train_config, n: int) -> None:
    """Rank 0's run name (its random part) names the run on all ``n``
    ranks."""
    if n > 1:
        name = [train_config.run_name]
        dist.broadcast_object_list(name, src=0)
        train_config.run_name = name[0]
