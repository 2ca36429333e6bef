"""LR schedules as plain ``step -> lr`` functions (the port of ``s2tpu/train/schedules.py``).

StepLR and cosine annealing with warmup and restarts, indexed by optimizer
step; the trainer sets the learning rate of step ``s`` before that step's
update, as optax's ``scale_by_learning_rate`` reads the schedule at the
update count.
"""

from __future__ import annotations

import math
import typing

Schedule = typing.Callable[[int], float]


def step_decay(base_lr: float, step_size: int, gamma: float) -> Schedule:
    """lr = base_lr * gamma^(step // step_size)  (torch StepLR)."""

    def schedule(count: int) -> float:
        return base_lr * gamma ** (count // step_size)

    return schedule


def cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    max_lr: float = 0.1,
    min_lr: float = 0.001,
    warmup_steps: int = 0,
    cycle_mult: float = 1.0,
    gamma: float = 1.0,
) -> Schedule:
    """Warmup + cosine restarts with growing cycles and decaying peaks
    (``s2tpu/train/schedules.py:28-66``): cycle c has length
    ``(first_cycle_steps - warmup) * cycle_mult^c + warmup`` and peak
    ``max_lr * gamma^c``; linear warmup from min_lr, then cosine back to it."""
    if warmup_steps >= first_cycle_steps:
        raise ValueError(f"warmup_steps {warmup_steps} must be < first_cycle_steps {first_cycle_steps}")

    def schedule(count: int) -> float:
        count = float(count)
        if cycle_mult == 1.0:
            cycle = math.floor(count / first_cycle_steps)
            step_in_cycle = count - cycle * first_cycle_steps
            cycle_steps = float(first_cycle_steps)
        else:
            # Invert the geometric cycle-length series to find the cycle index.
            cycle = math.floor(math.log(count / first_cycle_steps * (cycle_mult - 1.0) + 1.0) / math.log(cycle_mult))
            step_in_cycle = count - first_cycle_steps * (cycle_mult**cycle - 1.0) / (cycle_mult - 1.0)
            cycle_steps = first_cycle_steps * cycle_mult**cycle
        peak = max_lr * gamma**cycle
        if step_in_cycle < warmup_steps:
            return min_lr + (peak - min_lr) * step_in_cycle / max(warmup_steps, 1)
        return min_lr + (peak - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (step_in_cycle - warmup_steps) / (cycle_steps - warmup_steps))
        )

    return schedule


def build_schedule(
    base_lr: float,
    scheduler_type: str | None,
    steps_per_epoch: int = 1,
    *,
    step_size_epochs: int | None = None,
    step_gamma: float | None = None,
    first_cycle_epochs: int | None = None,
    cycle_mult: float | None = None,
    max_lr: float | None = None,
    min_lr: float | None = None,
    warmup_epochs: int | None = None,
    gamma: float | None = None,
) -> Schedule:
    """Factory mirroring ``s2tpu/train/schedules.py::build_schedule``
    (``:69-103``); None is the constant ``base_lr``."""
    if scheduler_type is None:
        return lambda count: base_lr
    if scheduler_type == "step":
        return step_decay(base_lr, (step_size_epochs or 1) * steps_per_epoch, step_gamma or 0.1)
    if scheduler_type == "cosine":
        kwargs: dict[str, typing.Any] = {}
        if max_lr is not None:
            kwargs["max_lr"] = max_lr
        if min_lr is not None:
            kwargs["min_lr"] = min_lr
        if cycle_mult is not None:
            kwargs["cycle_mult"] = cycle_mult
        if gamma is not None:
            kwargs["gamma"] = gamma
        if warmup_epochs is not None:
            kwargs["warmup_steps"] = warmup_epochs * steps_per_epoch
        return cosine_annealing_warmup_restarts(first_cycle_steps=(first_cycle_epochs or 10) * steps_per_epoch, **kwargs)
    raise ValueError(f"Unknown scheduler type {scheduler_type!r}")
