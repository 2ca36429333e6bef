"""Rematerialization of one block (the port of ``jax.checkpoint`` in ``s2tpu/train/trainer.py:465-466`` and ``mae_trainer.py:240-244``).

:func:`checkpointed` runs a block under ``torch.utils.checkpoint`` in its
non-reentrant form: the block keeps only its inputs for the backward pass and
runs its forward again there, so the activations inside it never live
through the rest of the forward. The trainers wrap each MBConv block and
decoder stage of the UNet and each ViT block of Prithvi, which lowers the
step's peak memory by the activations of all blocks but one.

Two things must not happen twice. BatchNorm updates its running statistics
in its forward: :func:`recomputing` tells it that this forward is the
recompute, and it leaves them alone. Random masks would be drawn again from
an explicit generator, which the checkpoint does not restore: the callers
draw them before the block and pass them in as tensors, so the recompute
sees the same masks and nothing in a block draws from the global generators
(which is why their state is not saved either).
"""

from __future__ import annotations

import contextlib
import threading
import typing

import torch
from torch.utils.checkpoint import checkpoint

_state = threading.local()


def recomputing() -> bool:
    """True inside the backward pass's second run of a checkpointed block.
    The flag is per thread: the recompute runs on the autograd engine's
    thread, which sets and clears it around its own call."""
    return getattr(_state, "on", False)


@contextlib.contextmanager
def _recompute() -> typing.Iterator[None]:
    _state.on = True
    try:
        yield
    finally:
        _state.on = False


def checkpointed(fn: typing.Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(*args)``, its activations recomputed in the backward pass instead
    of kept; the recompute runs with :func:`recomputing` true."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute()))
