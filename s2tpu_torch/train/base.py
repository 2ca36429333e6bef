"""What the segmentation and MAE trainers share (the port of ``s2tpu/train/trainer.py:75-146``).

``TrainerBase`` holds the state around the optimizer that both trainers
keep: the f32 master of bf16 parameters, the parameter EMA, the per-step
update with its watch norms, the checkpoint state, the resume from an epoch
or a pending preemption checkpoint, and ``fit``'s epoch loop with its SIGTERM
handler. A subclass supplies the model, the optimizer, ``run_train_epoch``
and ``_end_epoch``.
"""

from __future__ import annotations

import contextlib
import signal
import typing

import torch
import torch.distributed as dist

from s2tpu_torch.train.train_state import F32Master, ParamEMA, apply_update, watch_norms
from s2tpu_torch.utils import get_logger, get_unique_run_name

logger = get_logger(__name__)


def set_remat(model: torch.nn.Module, on: bool) -> None:
    """Checkpoint the blocks of every module in ``model`` that can (those
    with a ``remat`` switch)."""
    for m in model.modules():
        if hasattr(m, "remat"):
            m.remat = on


class PreemptionInterrupt(Exception):
    """Raised by the epoch loops at the first step boundary after a SIGTERM;
    carries how far training got, for the preemption checkpoint."""

    def __init__(self, epoch: int, batches_done: int) -> None:
        super().__init__(f"preempted in epoch {epoch} after {batches_done} batches")
        self.epoch = epoch
        self.batches_done = batches_done


def preempt_requested(trainer) -> bool:
    """Has this process, or any rank of the trainer's mesh, been asked to
    stop? With a mesh of several processes and a checkpoint manager, every
    rank calls this at every step boundary and the flags are reduced (MAX),
    so all ranks stop at the same batch."""
    mesh = getattr(trainer, "mesh", None)
    if trainer.ckpt is None or mesh is None or dist.get_world_size() == 1:
        return trainer.preempt_flag
    flag = torch.tensor([int(trainer.preempt_flag)], device=trainer.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


_NOT_INSTALLED = object()  # distinct from a previous handler of None (one installed outside Python)


def install_preempt_handler(trainer):
    """SIGTERM -> ``trainer.preempt_flag``, when a checkpoint manager is
    attached and ``fit`` runs in the main thread; returns the previous
    handler (or a marker that nothing was installed)."""
    if trainer.ckpt is None:
        return _NOT_INSTALLED

    def handler(signum, frame):
        del signum, frame
        logger.warning("SIGTERM received: saving a preemption checkpoint at the next step boundary")
        trainer.preempt_flag = True

    try:
        return signal.signal(signal.SIGTERM, handler)
    except ValueError:  # not the main thread
        return _NOT_INSTALLED


def restore_preempt_handler(prev) -> None:
    if prev is _NOT_INSTALLED:
        return
    try:
        signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
    except ValueError:
        pass


def with_is_last(it: typing.Iterable) -> typing.Iterator[tuple[typing.Any, bool]]:
    """``(item, is_last)`` with one item of lookahead: the loops do not stop
    on an epoch's last batch (resume would enter an epoch with none left)."""
    it = iter(it)
    try:
        prev = next(it)
    except StopIteration:
        return
    for cur in it:
        yield prev, False
        prev = cur
    yield prev, True


class TrainerBase:
    """What the two trainers share around their optimizer: the f32 master,
    the EMA, the per-step update, the watch norms and the checkpoint state."""

    def _init_params(self, t) -> None:
        """Master, EMA, remat and preemption state, after the model exists
        (in f32) and before the optimizer does."""
        set_remat(self.model, t.remat)
        self.master = F32Master(self.model) if t.param_dtype == "bfloat16" else None
        self.ema = ParamEMA(self.model, t.ema_decay, self.master) if t.ema_decay else None
        self.step = 0  # optimizer updates applied so far
        self.preempt_flag = False  # set by the SIGTERM handler (fit)
        self._skip_batches = 0  # batches of the resumed epoch already trained
        self._resumed_from_preempt = False  # this run consumed the preemption checkpoint

    def _trainable(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def _zero_grads(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.model.parameters():
            p.grad = None

    def _update(self, named: list[tuple[str, torch.nn.Parameter]], grads: list[torch.Tensor], accum: int,
                watch: bool) -> dict[str, typing.Any]:
        """Apply the mean of the summed micro-batch ``grads``; the watch norms
        (names and device vector) when ``watch``."""
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        params = [p for _, p in named]
        apply_update(self.optimizer, params, grads, self.master, self.ema)
        self.step += 1
        if not watch:
            return {}
        return {"watch": watch_norms(dict(zip((n for n, _ in named), grads)), dict(self.model.named_parameters()))}

    def _watch_this_step(self) -> bool:
        """Whether the next step's norms will be logged."""
        wi = self.config.train.watch_interval
        return self.run_logger is not None and wi > 0 and (self.step + 1) % wi == 0

    def _maybe_log_watch(self, step_metrics: dict) -> None:
        if "watch" in step_metrics:
            names, values = step_metrics["watch"]
            self.run_logger.log_scalars(dict(zip(names, values.tolist())), step=self.step)

    def eval_weights(self) -> typing.ContextManager:
        """The weights of validation and serving: the EMA's when kept."""
        return self.ema.swapped_in() if self.ema is not None else contextlib.nullcontext()

    def _extras(self) -> dict:
        return {
            "master": self.master.state_dict() if self.master is not None else None,
            "ema": self.ema.state_dict() if self.ema is not None else None,
        }

    def _load(self, restored: dict) -> None:
        self.model.load_state_dict(restored["model"], strict=True)
        self.optimizer.load_state_dict(restored["optimizer"])
        for name, part in (("master", self.master), ("ema", self.ema)):
            if part is not None:
                if restored.get(name) is None:
                    raise ValueError(f"the checkpoint has no {name}, which this run's config keeps")
                part.load_state_dict(restored[name])
        self.step = restored["step"]

    def _resume_preempted(self) -> int | None:
        """Restore a pending preemption checkpoint; returns its epoch (None
        when there is none)."""
        if not self.ckpt.has_preempt():
            return None
        epoch = self.ckpt.preempt_epoch()
        self._before_restore(epoch)
        restored = self.ckpt.restore_preempt()
        self._load(restored)
        self._skip_batches = restored["batches_done"]
        self._resumed_from_preempt = True
        logger.info(
            f"Resumed from the preemption checkpoint: epoch {epoch}, {self._skip_batches} batches already "
            f"trained (step {self.step})"
        )
        return epoch

    def _before_restore(self, epoch: int) -> None:
        """Match the optimizer's structure to a checkpoint of ``epoch``."""

    def resume_from_checkpoint(self, epoch: int | None = None) -> int:
        """Restore the model, Adam, the master, the EMA and the step: from a
        pending preemption checkpoint (unless ``epoch`` is given; the epoch
        it interrupted is returned and its trained batches are skipped), or
        from the checkpoint manager's ``epoch`` (default: its latest), which
        returns the epoch after it; 0 when there is no checkpoint."""
        if self.ckpt is None:
            raise ValueError("resume requires a checkpoint manager")
        if epoch is None:
            preempted = self._resume_preempted()
            if preempted is not None:
                return preempted
        latest = epoch if epoch is not None else self.ckpt.latest_epoch()
        if latest is None:
            return 0
        self._before_restore(latest)
        self._load(self.ckpt.restore(latest))
        logger.info(f"Resumed from checkpoint epoch {latest} (step {self.step})")
        return latest + 1

    def fit(self, epochs: int | None = None, start_epoch: int = 0) -> list[dict]:
        cfg = self.config
        max_epochs = epochs if epochs is not None else cfg.train.max_epochs
        if max_epochs <= 0:
            raise ValueError("fit() needs an explicit positive epoch count")
        if cfg.train.run_name is None:
            cfg.train.run_name = get_unique_run_name(postfix=cfg.train.project_name)
        history: list[dict] = []
        prev = install_preempt_handler(self)
        try:
            for epoch in range(start_epoch, max_epochs):
                self._enter_epoch(epoch)
                try:
                    if preempt_requested(self):  # arrived between epochs or during eval
                        raise PreemptionInterrupt(epoch, self._skip_batches)
                    train_metrics = self.run_train_epoch(epoch)
                    if self._resumed_from_preempt:
                        # only the marker this run consumed: another run's stays
                        self.ckpt.clear_preempt()
                        self._resumed_from_preempt = False
                except PreemptionInterrupt as pi:
                    if self.ckpt is not None and self.is_main:
                        self.ckpt.save_preempt(pi.epoch, pi.batches_done, self.model, self.optimizer, self.step,
                                               **self._extras())
                    logger.warning(
                        f"Preempted in epoch {pi.epoch} after {pi.batches_done} batches: state saved; rerun "
                        "with --resume-from (or --auto-resume) for an exact continuation"
                    )
                    return history
                record = self._end_epoch(epoch, train_metrics)
                history.append(record)
                if self.ckpt is not None and self.is_main and (epoch + 1) % cfg.train.ckpt_every_n_epochs == 0:
                    self.ckpt.save_epoch(epoch, self.model, self.optimizer, self.step, metrics=record,
                                         **self._extras())
            return history
        finally:
            restore_preempt_handler(prev)

    def _enter_epoch(self, epoch: int) -> None:
        """Per-epoch transitions before training it."""

    def _train_loop(
        self, epoch: int, batches: typing.Iterable, step: typing.Callable, skip: int
    ) -> tuple[list, int, int]:
        """One epoch's steps over ``batches``, whose first ``skip`` batches a
        resumed run already trained: returns the steps' outputs, their count
        and the images seen; raises PreemptionInterrupt at a step boundary
        after a SIGTERM."""
        outs, n, images_seen = [], 0, 0
        cfg = self.config
        for i, (batch, is_last) in enumerate(with_is_last(batches)):
            m = step(batch)
            outs.append(m)
            n += 1
            images_seen += batch.images.shape[0]
            if self.run_logger is not None and (i + 1) % cfg.train.log_interval == 0:
                self.run_logger.log_scalars({"train/loss_step": float(m["loss"])}, step=self.step)
            self._maybe_log_watch(m)
            if not is_last and preempt_requested(self):
                raise PreemptionInterrupt(epoch, skip + n)
        if n == 0 and not skip:
            raise ValueError(
                f"train epoch {epoch} produced ZERO batches: the train pool "
                f"({len(self.dm.train_idx)} segments) is smaller than one batch "
                f"({cfg.datamodule.batch_size}); reduce --bs or grow the dataset/split"
            )
        return outs, n, images_seen
