"""The optimizer (the port of ``s2tpu/train/train_state.py::make_optimizer``).

``torch.optim.Adam`` with ``weight_decay`` folds L2 into the gradient before
the moments (coupled decay), which is the JAX package's ``adam_l2``
(``:130-143``), not AdamW. The frozen-parameter mask (``:146-165``: frozen
leaves get a zero update, so no L2 either) is the parameters'
``requires_grad``: a frozen one stays out of the optimizer. The f32 master
of bf16-stored parameters and the parameter EMA are not ported yet.
"""

from __future__ import annotations

import typing

import torch


def make_optimizer(
    params: typing.Iterable[torch.nn.Parameter], learning_rate: float, weight_decay: float,
    betas: tuple[float, float],
) -> torch.optim.Adam:
    """Adam with coupled L2 at eps 1e-8 (optax ``scale_by_adam``'s) over the
    parameters that require a gradient. The trainer overwrites the learning
    rate from its schedule before each step."""
    trainable = [p for p in params if p.requires_grad]
    return torch.optim.Adam(trainable, lr=learning_rate, betas=betas, eps=1e-8, weight_decay=weight_decay)
