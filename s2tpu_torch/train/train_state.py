"""The optimizer and what travels with it (the port of ``s2tpu/train/train_state.py``).

``torch.optim.Adam`` with ``weight_decay`` folds L2 into the gradient before
the moments (coupled decay), which is the JAX package's ``adam_l2``
(``:130-143``), not AdamW. The frozen-parameter mask (``:146-165``: frozen
leaves get a zero update, so no L2 either) is the parameters'
``requires_grad``: a frozen one stays out of the optimizer.

:class:`F32Master` is ``with_f32_master`` (``:101-127``): the model stores
its parameters in bf16, Adam walks f32 master copies of them, and after each
update every bf16 parameter is rewritten as the cast of its master, never a
rounded delta added on top. :class:`ParamEMA` is ``with_param_ema``
(``:47-91``): an f32 average of the parameters after each update, of the
masters under bf16 storage; BatchNorm statistics are not averaged. Both
carry a ``state_dict`` that the checkpoints save beside Adam's.

A train step sums its micro-batches' gradients in f32
(:func:`accumulate_grads`) and hands the mean to :func:`apply_update`.
"""

from __future__ import annotations

import contextlib
import typing

import numpy as np
import torch
from torch import nn


def draw_seed(seed: int, step: int, micro: int = 0) -> int:
    """Seed of the random draws (drop-connect, dropout, MAE masking noise) of
    micro-batch ``micro`` of optimizer step ``step``: a function of the three
    alone, as the JAX steps fold the step and the micro-batch into their key,
    so that a resumed run draws what the uninterrupted run would have."""
    return int(np.random.SeedSequence((seed, step, micro)).generate_state(1, np.uint64)[0] >> np.uint64(1))


class F32Master:
    """f32 master copies of ``model``'s parameters, taken at full precision;
    the model's parameters are then stored in bf16."""

    def __init__(self, model: nn.Module) -> None:
        self.master: dict[str, torch.Tensor] = {}
        self._by_param: dict[int, torch.Tensor] = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                m = p.detach().float().clone()
                self.master[name] = m
                self._by_param[id(p)] = m
                p.data = p.data.to(torch.bfloat16)

    def of(self, params: typing.Iterable[nn.Parameter]) -> list[torch.Tensor]:
        """The masters of ``params``, in order."""
        return [self._by_param[id(p)] for p in params]

    @torch.no_grad()
    def write_back(self, params: list[nn.Parameter]) -> None:
        """Each of ``params`` := the bf16 cast of its master."""
        for p, m in zip(params, self.of(params)):
            p.copy_(m)

    def state_dict(self) -> dict[str, torch.Tensor]:
        return self.master

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        for name, m in self.master.items():
            m.copy_(state[name])


class ParamEMA:
    """f32 exponential moving average (``decay``) of ``model``'s parameters
    after each update, read from ``master`` when the parameters are stored
    in bf16 (averaging the bf16 copies would average their rounding)."""

    def __init__(self, model: nn.Module, decay: float, master: F32Master | None = None) -> None:
        self.decay = decay
        self.params = dict(model.named_parameters())
        sources = master.master if master is not None else {n: p for n, p in self.params.items()}
        self.ema = {n: t.detach().float().clone() for n, t in sources.items()}
        self._source = {id(p): sources[n] for n, p in self.params.items()}
        self._ema = {id(p): self.ema[n] for n, p in self.params.items()}

    @torch.no_grad()
    def update(self, params: list[nn.Parameter]) -> None:
        """ema := decay * ema + (1 - decay) * the source, for the updated
        ``params`` (a frozen parameter's average stays equal to it)."""
        ema = [self._ema[id(p)] for p in params]
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, [self._source[id(p)] for p in params], alpha=1.0 - self.decay)

    @contextlib.contextmanager
    def swapped_in(self) -> typing.Iterator[None]:
        """The model runs on the average (cast to each parameter's dtype)
        inside the block, on its own parameters again after it."""
        live = {n: p.data for n, p in self.params.items()}
        try:
            for n, p in self.params.items():
                p.data = self.ema[n].to(p.dtype)
            yield
        finally:
            for n, p in self.params.items():
                p.data = live[n]

    def state_dict(self) -> dict[str, torch.Tensor]:
        return self.ema

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        for name, e in self.ema.items():
            e.copy_(state[name])


def make_optimizer(
    params: typing.Iterable[nn.Parameter], learning_rate: float, weight_decay: float,
    betas: tuple[float, float], master: F32Master | None = None,
) -> torch.optim.Adam:
    """Adam with coupled L2 at eps 1e-8 (optax ``scale_by_adam``'s) over the
    parameters that require a gradient, or over their f32 masters. The
    trainer overwrites the learning rate from its schedule before each step
    (:func:`set_lr`).

    On the card Adam is capturable and its learning rate is a one-element f32
    device tensor, so that a CUDA graph can capture the update and take each
    step's rate from that tensor: every step on the card, eager or graphed,
    runs this same arithmetic, and a graphed step equals an eager one bit
    for bit."""
    trainable = [p for p in params if p.requires_grad]
    if master is not None:
        trainable = master.of(trainable)
    device = trainable[0].device if trainable else torch.device("cpu")
    if device.type != "cuda":
        return torch.optim.Adam(trainable, lr=learning_rate, betas=betas, eps=1e-8, weight_decay=weight_decay)
    lr = torch.tensor(learning_rate, dtype=torch.float32, device=device)
    return torch.optim.Adam(trainable, lr=lr, betas=betas, eps=1e-8, weight_decay=weight_decay, capturable=True)


def set_lr(optimizer: torch.optim.Adam, lr: float) -> None:
    """Every group's learning rate := ``lr``: written into the device tensor
    of a capturable Adam (one fill on the current stream), else stored."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Adam, state: dict) -> None:
    """``optimizer.load_state_dict(state)``, keeping what :func:`make_optimizer`
    chose for this device: a checkpoint written by a non-capturable Adam (any
    checkpoint from the CPU) stores a float learning rate,
    ``capturable=False`` and each step count on the CPU, and a capturable
    Adam keeps its device tensor rate, its flag and the counts on the
    parameters' device."""
    live = [(g["lr"], g.get("capturable", False)) for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable) in zip(optimizer.param_groups, live):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
        group["lr"], group["capturable"] = lr, capturable
        if capturable:
            for p in group["params"]:
                st = optimizer.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)


def accumulate_grads(params: list[nn.Parameter], sums: list[torch.Tensor] | None) -> list[torch.Tensor]:
    """Add the gradients that the last backward left in ``params`` to the f32
    ``sums`` (None for the first micro-batch) and clear them, so that bf16
    gradients are never summed in bf16 (``s2tpu/train/trainer.py:524-529``)."""
    grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None else p.grad.float() for p in params]
    for p in params:
        p.grad = None
    if sums is None:
        return grads
    torch._foreach_add_(sums, grads)
    return sums


def apply_update(
    optimizer: torch.optim.Adam, params: list[nn.Parameter], grads: list[torch.Tensor],
    master: F32Master | None = None, ema: ParamEMA | None = None,
) -> None:
    """One Adam step from the f32 gradients ``grads`` of ``params``: on the
    parameters (their ``.grad`` keeps ``grads``), or on their masters, which
    are then cast into the bf16 parameters; then the EMA follows."""
    targets = params if master is None else master.of(params)
    for t, g in zip(targets, grads):
        t.grad = g
    optimizer.step()
    if master is not None:
        master.write_back(params)
    if ema is not None:
        ema.update(params)


@torch.no_grad()
def watch_norms(
    grads: dict[str, torch.Tensor], params: dict[str, torch.Tensor], sharded=None,
) -> tuple[list[str], torch.Tensor]:
    """The global and per-tensor L2 norms of a step's gradients and of its new
    parameters (``s2tpu/train/trainer.py::_watch_norms``), in f32 on the
    device: the names and one vector, which the host reads only on a logged
    step. Names are the state dict's. With ``sharded`` (the trainer's
    :class:`~s2tpu_torch.parallel.mesh.ShardedParameters`), the tensors it
    shards are this rank's slices: their squared norms are summed over the
    model axis in one all-reduce, so every rank logs the whole tensors'
    norms."""
    g = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in grads.values()])
    p = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in params.values()])
    if sharded is not None and sharded.shards:
        mask = torch.tensor([n in sharded for n in (*grads, *params)], device=g.device)
        both = torch.cat([g, p])
        squares = torch.where(mask, both.square(), 0.0)
        sharded.axis.all_reduce_flat_([squares])
        g, p = torch.where(mask, squares.sqrt(), both).split([len(grads), len(params)])
    names = ["grads/global_norm", "params/global_norm", *(f"grads/{n}" for n in grads),
             *(f"params/{n}" for n in params)]
    return names, torch.cat([g.square().sum().sqrt()[None], p.square().sum().sqrt()[None], g, p])
