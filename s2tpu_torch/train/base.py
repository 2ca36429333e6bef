"""What the segmentation and MAE trainers share (the port of ``s2tpu/train/trainer.py:75-146``).

``TrainerBase`` holds the state around the optimizer that both trainers
keep: the f32 master of bf16 parameters, the parameter EMA, the per-step
update with its watch norms, the draw generators, the checkpoint state, the
resume from an epoch or a pending preemption checkpoint, ``fit``'s epoch loop
with its SIGTERM handler, and the device corpus's epoch of windows. A
subclass supplies the model, the optimizer, the step (``_step`` and
``_corpus_step``), ``run_train_epoch`` and ``_end_epoch``.

The device corpus's epoch (``_run_corpus_epoch``, the port of
``s2tpu/train/trainer.py:772-883`` and ``mae_trainer.py:381-488``) draws
each step's segment indices and crop offsets on the host, exactly as the JAX
loop does, and trains them in windows of ``steps_per_dispatch`` steps
(``train_window``): the window's (K, 3, B) int32 draws go to the device in
one copy. On the card, with K > 1, the whole step (gather, flips,
normalization, forward, loss, backward, f32 gradient sums, Adam, the master
write-back, the EMA and the epoch sums) is one CUDA graph
(:class:`s2tpu_torch.train.graphs.StepGraph`), replayed once a step: the host
writes the step's learning rate and the window's row into the graph's
inputs and reseeds the step's generators, a handful of launches where an
eager step makes thousands. The graph holds one step, not K: its capture
costs the same at any K, and the remainder of an epoch (fewer than K
batches, run as single steps as in the JAX loop) replays the same graph.
Everything a graphed step computes is what the eager step computes, bit for
bit. On the CPU the same windows run eager steps, as the caller asked for
the CPU.

On a data axis of several ranks (``data_axis``, one process each), each
rank trains its rows of the same global draws (its slice of each window's
draws is the graph's input), the preemption flag is reduced over the whole
mesh at every step boundary (a window's, on the corpus), and checkpoints are written by rank 0 while
the others wait (``checkpoint.io.on_rank0``); every rank reads them on
resume. Over NCCL each rank captures the same step graph, with the step's
collectives (BatchNorm sums, loss denominators, the gradient buckets) in it
in the same order, so a replay is a real step on every rank; ``s2tpu`` runs
its fused windows on a one-process data mesh and turns them off only across
processes (``s2tpu/train/trainer.py:814-825``), and in the port every rank
is a process. Over gloo (ranks sharing one card, or the CPU) the windows run
eager steps.
"""

from __future__ import annotations

import contextlib
import signal
import time
import typing

import numpy as np
import torch
import torch.distributed as dist

from s2tpu_torch import plotting, profiling
from s2tpu_torch.checkpoint.io import on_rank0
from s2tpu_torch.data.device_corpus import sample_crop_batch, sample_sharded_crop_batch, sharded_epoch_orders
from s2tpu_torch.data.pipeline import epoch_rng, sample_epoch_order
from s2tpu_torch.parallel.mesh import MODEL_SINGLE, SINGLE, DataAxis, ModelAxis, ShardedParameters
from s2tpu_torch.train.graphs import StepGraph
from s2tpu_torch.train.train_state import (
    F32Master, ParamEMA, apply_update, draw_seed, load_optimizer_state, set_lr, watch_norms,
)
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
    if trainer.ckpt is None or trainer.mesh is None or dist.get_world_size() == 1:
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

    mesh = None  # the process group's ('data', 'model') mesh, where the trainer runs on one
    data_axis: DataAxis = SINGLE  # this rank's place on the mesh's data axis
    model_axis: ModelAxis = MODEL_SINGLE  # this rank's place on the mesh's model axis
    shards: ShardedParameters | None = None  # the parameters sharded over the model axis (FSDP), if any

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
        # Micro-batch i of every step draws (flips, drop-connect or dropout,
        # masking noise) from generators[i], reseeded from (seed, step, i)
        # before the step; one generator each, so that a CUDA graph of the
        # step can hold every one of them.
        self.generators = [torch.Generator(device=self.device) for _ in range(max(t.grad_accum_steps, 1))]
        self._graph: StepGraph | None = None  # the captured corpus step; None until the first graphed window
        self._sums: dict[str, torch.Tensor] | None = None  # the corpus epoch's device sums
        self._window_logged = False  # the one log line when watching or gloo turns graphs off
        # Whether another rank of the mesh holds a run logger (rank 0 alone
        # does): the rule for windows must be the same on every rank.
        self._peer_logs = self._on_any_rank(self.run_logger is not None)
        self._no_pyplot_warned = False  # the one warning when matplotlib is missing

    def _on_any_rank(self, flag: bool) -> bool:
        """``flag`` or'ed over the ranks of the trainer's mesh (one
        collective; ``flag`` itself without a mesh of several ranks)."""
        if self.mesh is None or dist.get_world_size() == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def _trainable(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]

    def _zero_grads(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.model.parameters():
            p.grad = None

    def _learning_rate(self) -> float:
        """The learning rate of the next update."""
        return self.config.train.lr

    def _begin_step(self) -> None:
        """The host's part of the next step: its learning rate into the
        optimizer and its generators reseeded from (seed, step, micro-batch)."""
        set_lr(self.optimizer, self._learning_rate())
        seed = self.config.train.seed
        for i, g in enumerate(self.generators):
            g.manual_seed(draw_seed(seed, self.step, i))

    def _update(self, named: list[tuple[str, torch.nn.Parameter]], grads: list[torch.Tensor], accum: int,
                watch: bool) -> dict[str, typing.Any]:
        """Apply the mean of the summed micro-batch ``grads``; the watch norms
        (names and device vector) when ``watch``. The caller counts the step."""
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        params = [p for _, p in named]
        apply_update(self.optimizer, params, grads, self.master, self.ema)
        if not watch:
            return {}
        return {"watch": watch_norms(dict(zip((n for n, _ in named), grads)), dict(self.model.named_parameters()),
                                     self.shards)}

    def _watch_this_step(self) -> bool:
        """Whether the next step's norms will be logged; with sharded
        parameters on every rank when rank 0 logs, since the norms of the
        slices are summed over the model axis."""
        wi = self.config.train.watch_interval
        logs = self.run_logger is not None or (self.shards is not None and self._peer_logs)
        return logs and wi > 0 and (self.step + 1) % wi == 0

    def _maybe_log_watch(self, step_metrics: dict) -> None:
        if "watch" in step_metrics and self.run_logger is not None:
            names, values = step_metrics["watch"]
            self.run_logger.log_scalars(dict(zip(names, values.tolist())), step=self.step)

    def _image_pyplot(self):
        """pyplot for the epoch's images, or None: without a run logger, or
        without matplotlib (one warning a trainer). Asked before any forward
        the images need, so where matplotlib is missing none runs."""
        if self.run_logger is None:
            return None
        plt = plotting.pyplot()
        if plt is None and not self._no_pyplot_warned:
            logger.warning("matplotlib is not installed: epoch images are not logged")
            self._no_pyplot_warned = True
        return plt

    def eval_weights(self) -> typing.ContextManager:
        """The weights of validation and serving: the EMA's when kept."""
        return self.ema.swapped_in() if self.ema is not None else contextlib.nullcontext()

    def whole_weights(self) -> typing.ContextManager:
        """Around every use of the model: with parameters sharded over the
        model axis, the modules see them whole inside the block (one
        all-gather; :meth:`ShardedParameters.gathered`)."""
        return self.shards.gathered() if self.shards is not None else contextlib.nullcontext()

    def _extras(self) -> dict:
        return {
            "master": self.master.state_dict() if self.master is not None else None,
            "ema": self.ema.state_dict() if self.ema is not None else None,
        }

    def _checkpoint_state(self) -> dict:
        """What a checkpoint holds: the model, Adam, the master and the EMA,
        each whole. With sharded parameters their slices are gathered over
        the model axis first, a collective that every rank makes before rank
        0 writes."""
        state = {"model": self.model, "optimizer": self.optimizer, **self._extras()}
        if self.shards is None:
            return state
        names = [n for n, _ in self._trainable()]  # the optimizer's parameters, in order
        return {"model": self.shards.full(self.model.state_dict()),
                "optimizer": self.shards.full_optimizer(self.optimizer.state_dict(), names),
                **{k: None if v is None else self.shards.full(v) for k, v in self._extras().items()}}

    def _load(self, restored: dict) -> None:
        if self.shards is not None:  # whole tensors on disk: this rank keeps its slices
            names = [n for n, _ in self._trainable()]
            restored = {**restored, "model": self.shards.local(restored["model"]),
                        "optimizer": self.shards.local_optimizer(restored["optimizer"], names),
                        **{k: self.shards.local(restored[k]) for k in ("master", "ema") if restored.get(k) is not None}}
        self.model.load_state_dict(restored["model"], strict=True)
        load_optimizer_state(self.optimizer, restored["optimizer"])
        self._graph = None  # Adam's state tensors are new: capture the step again
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
                        on_rank0(self.ckpt.clear_preempt)
                        self._resumed_from_preempt = False
                except PreemptionInterrupt as pi:
                    if self.ckpt is not None:
                        state = self._checkpoint_state()
                        on_rank0(lambda: self.ckpt.save_preempt(pi.epoch, pi.batches_done, step=self.step, **state))
                    logger.warning(
                        f"Preempted in epoch {pi.epoch} after {pi.batches_done} batches: state saved; rerun "
                        "with --resume-from (or --auto-resume) for an exact continuation"
                    )
                    return history
                record = self._end_epoch(epoch, train_metrics)
                history.append(record)
                if self.ckpt is not None and (epoch + 1) % cfg.train.ckpt_every_n_epochs == 0:
                    state = self._checkpoint_state()
                    on_rank0(lambda: self.ckpt.save_epoch(epoch, step=self.step, metrics=record, **state))
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

    # ------------------------------------------------------------------
    # The device corpus: windows of steps, graphed on the card.
    def _window_size(self) -> int:
        """Steps a corpus window trains: ``steps_per_dispatch``, but 1 (said
        once in the log) when the norms are watched, which are read each
        step; on every rank of a mesh when rank 0 watches, so that no rank
        replays a step graph while another runs eager steps."""
        t = self.config.train
        k = max(t.steps_per_dispatch, 1)
        if k > 1 and (self.run_logger is not None or self._peer_logs) and t.watch_interval > 0:
            if not self._window_logged:
                logger.info("steps_per_dispatch > 1 disabled (watch logging requires per-step dispatch)")
                self._window_logged = True
            return 1
        return k

    def _graphed(self) -> bool:
        """Whether the corpus steps replay the captured step graph: on the
        card, with windows above one step, on one rank or on mesh axes
        whose collectives a graph can hold (NCCL). A gloo axis on the card
        (ranks sharing a card) trains its windows eagerly, said once in the
        log."""
        if self.device.type != "cuda" or self._window_size() == 1:
            return False
        if self.data_axis.capturable and self.model_axis.capturable:
            return True
        if not self._window_logged:
            logger.info("corpus windows run eager steps: a gloo axis's collectives pass through the host, "
                        "which a CUDA graph cannot capture (NCCL ranks replay the step graph)")
            self._window_logged = True
        return False

    def _corpus_sum_shapes(self) -> dict[str, tuple[int, ...]]:
        """The per-step outputs the corpus epoch sums, and their shapes."""
        return {"loss": ()}

    def _corpus_step(self, row: torch.Tensor) -> dict[str, typing.Any]:
        """One step on the corpus crops of ``row`` ((3, B) int32 indices and
        offsets on the device), its loss (and confusion matrix) added to the
        epoch's device sums; capturable."""
        raise NotImplementedError

    def _add_to_sums(self, m: dict[str, typing.Any]) -> None:
        for k, total in self._sums.items():
            total.add_(m[k])

    def train_window(self, draws: np.ndarray) -> dict[str, typing.Any] | None:
        """Train one window of corpus steps: ``draws`` is (K, 3, B) int32, each
        step's segment indices and row and column offsets, uploaded in one
        copy. Where :meth:`_graphed`, every step replays the captured step
        graph (the first one captures it); otherwise the steps run eagerly.
        Returns the last eager step's outputs (None for graphed steps, whose
        outputs live in the graph)."""
        with profiling.span("s2tpu.train.window"):
            if self._sums is None:
                self._sums = {k: torch.zeros(shape, dtype=torch.float32, device=self.device)
                              for k, shape in self._corpus_sum_shapes().items()}
            with profiling.span("s2tpu.train.draws"):
                rows = torch.from_numpy(np.ascontiguousarray(draws, dtype=np.int32))
                if self.device.type == "cuda":  # from pinned memory: the copy does not wait for the stream
                    rows = rows.pin_memory().to(self.device, non_blocking=True)
            graphed = self._graphed()
            m = None
            for row in rows:
                with profiling.span("s2tpu.train.begin_step"):
                    self._begin_step()
                if graphed:
                    if self._graph is None:
                        with profiling.span("s2tpu.train.capture"):
                            self._graph = StepGraph(self._corpus_step, row, self.generators)
                    else:
                        with profiling.span("s2tpu.train.replay"):
                            self._graph.replay(row)
                else:
                    with profiling.span("s2tpu.train.eager_step"):
                        m = self._corpus_step(row)
                    self._maybe_log_watch(m)
                self.step += 1
            return m

    def _corpus_sampler(self, rng: np.random.Generator, sample_weights: np.ndarray | None, overfit: int,
                        random_crop: bool) -> tuple[typing.Callable[[int], np.ndarray], int]:
        """The epoch's draws from ``rng`` as the JAX loop makes them: a
        function of the step giving this rank's (3, rows) int32 segment ids
        and crop offsets, and the epoch's step count. The plain corpus: the
        epoch's order over the train split (weighted when
        ``sample_weights``), one ``sample_crop_batch`` a step, this rank's
        rows of it. The sharded corpus: one order a block
        (``sharded_epoch_orders``, per-block weights), one
        ``sample_sharded_crop_batch`` a step, this rank's block's rows of it
        (local ids)."""
        dmc = self.config.datamodule
        bs, crop, hw = dmc.batch_size, dmc.random_crop_size, self.corpus.hw
        if self.corpus.sharded:
            per = bs // self.data_axis.size
            weights = None
            if sample_weights is not None:
                owners = self.dm.train_idx // self.corpus.n_local
                w = sample_weights[self.dm.train_idx]
                weights = [w[owners == k] for k in range(self.data_axis.size)]
            orders, n_batches = sharded_epoch_orders(rng, self.corpus.shard_pools(self.dm.train_idx), per, overfit,
                                                     weights=weights)
            mine = slice(self.data_axis.index * per, (self.data_axis.index + 1) * per)
            return (lambda b: np.stack(sample_sharded_crop_batch(rng, orders, b, per, hw, crop, random_crop))[:, mine],
                    n_batches)
        order, n_batches = sample_epoch_order(rng, self.dm.train_idx, sample_weights, bs, overfit)
        rows = self.dm.local_rows()  # this rank's rows of each global draw (None: all)

        def sample(b: int) -> np.ndarray:
            draws = np.stack(sample_crop_batch(rng, order, b, bs, hw, crop, random_crop))
            return draws if rows is None else draws[:, rows]

        return sample, n_batches

    def _run_corpus_epoch(self, epoch: int, sample_weights: np.ndarray | None) -> tuple[int, dict, float]:
        """One epoch from the device corpus: the JAX loop's draws
        (:meth:`_corpus_sampler`) in windows of ``_window_size()`` steps, a
        remainder of fewer as single steps. A resumed epoch replays the
        skipped prefix's draws without training on them. A SIGTERM stops it
        at a window boundary. Returns the batches trained, the epoch's device
        sums and its seconds."""
        cfg = self.config
        dmc = cfg.datamodule
        bs, overfit = dmc.batch_size, cfg.train.overfit_batches
        rng = epoch_rng(dmc.shuffle_seed, epoch, overfit)
        sample, n_batches = self._corpus_sampler(rng, sample_weights, overfit, dmc.augment and overfit == 0)
        if n_batches == 0:
            raise ValueError(
                f"train epoch {epoch} produced ZERO device-corpus batches: the train pool "
                f"({len(self.dm.train_idx)} segments) is smaller than one batch ({bs}); "
                "reduce --bs or grow the dataset/split"
            )

        skip, self._skip_batches = self._skip_batches, 0
        for b in range(min(skip, n_batches)):
            sample(b)
        k = self._window_size()
        if self._sums is not None:
            for total in self._sums.values():
                total.zero_()
        t0 = time.time()
        b = skip
        while b < n_batches:
            take = k if b + k <= n_batches else 1
            self.train_window(np.stack([sample(b + j) for j in range(take)]))
            b += take
            # b == n_batches: the epoch just finished; stopping there would
            # resume into an epoch with no batch left.
            if b < n_batches and preempt_requested(self):
                raise PreemptionInterrupt(epoch, b)
        return max(n_batches - skip, 0), self._sums, time.time() - t0
