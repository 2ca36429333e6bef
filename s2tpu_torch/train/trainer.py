"""Segmentation trainer: eager train/eval steps and the epoch loop (the port of ``s2tpu/train/trainer.py``).

One train step normalizes the int16 crops on the device, runs the model in
the compute dtype, computes the loss (the fused CE/focal kernels on the
card), back-propagates (the depthwise kernels' input and filter gradients on
the card), and applies Adam with coupled L2 at the schedule's learning rate
for that step. The confusion matrix accumulates on the device; the host
reads the loss only at ``log_interval`` and at epoch end.

The step's extras (``:451-541``), each a config field:

- ``grad_accum_steps``: the batch runs as that many micro-batches in turn,
  BatchNorm's running statistics threaded through them; their gradients are
  summed in f32, divided by the count, and applied in one update.
- ``remat``: each MBConv block and decoder stage (each ViT block of
  fc-prithvi's backbone) is recomputed in the backward pass
  (``models.remat``).
- ``param_dtype='bfloat16'``: the parameters are stored in bf16 and Adam
  walks their f32 masters (``train_state.F32Master``).
- ``ema_decay``: an f32 average of the parameters after each update, which
  validation, BatchNorm recalibration and checkpoints' serving use
  (``train_state.ParamEMA``).
- ``watch_interval``: with a run logger, every that many steps the global
  and per-tensor norms of the gradients and new parameters, computed on the
  device and read only then (``_watch_norms``, ``_maybe_log_watch``).
- ``bn_recalibration_batches``: before each val pass, the running
  statistics := exact statistics pooled over that many of epoch 0's train
  batches, taken with the eval weights (``recalibrate_bn``).

Drop-connect (UNet), dropout (fc-prithvi's head) and the device-side flips
draw from the micro-batch's generator, reseeded for every step from (seed,
step, micro-batch), as the JAX step folds the step into its key, so a
resumed run draws what the uninterrupted run would have. ``fit``
(``train.base.TrainerBase``, shared with the MAE trainer) installs a
SIGTERM handler when a checkpoint manager is attached: at the next step
boundary it saves the model, Adam, the master, the EMA, the step and how
many batches of the epoch are done, and returns;
``resume_from_checkpoint`` then re-enters that epoch and skips its trained
prefix (``:75-146``, ``:885-933``).

Also ported: ``train_step``/``eval_step``, ``run_train_epoch``,
``run_eval_epoch``, ``_metric_exclude_index``, ``resume_from_checkpoint``
and ``fit`` (``:1086-1227``), and fc-prithvi's hooks: the pretrained
backbone (``_load_prithvi_backbone``, ``:369-436``), the frozen backbone
kept out of the optimizer, and the frozen-then-unfrozen transition
(``unfreeze_backbone``, ``_maybe_unfreeze``, ``:636-709``).
The device corpus (``train.device_corpus``, ``:772-883``): the train split's
segments are uploaded to the card once (``data.device_corpus``), each step's
crops are gathered there from three (B,) int32 vectors that the host draws
as the JAX loop does, and ``train.steps_per_dispatch`` steps at a time run
as replays of one CUDA graph of the whole step (``train.base``, windows; the
remainder of an epoch as single steps). Flips then run on the device
(``data.augment.random_flips``), as they do whenever ``host_flips`` is off:
the host's stream then draws no flips, so a corpus epoch and a streamed epoch
with ``host_flips=False`` take the same draws and train the same steps, bit
for bit. BatchNorm recalibration gathers its batches from the corpus
(``:1004-1050``).

With a run logger, each epoch also logs images (``_log_epoch_images``,
``:1229-1289``, the single-process branch): the validation confusion matrix
and the predictions of one random validation sample and of sample 0, from
the eval weights in eval mode under no_grad, drawing from none of the
step's generators; where matplotlib is missing, none is drawn (one warning).

A data axis (``mesh``, or ``train.num_devices`` N > 1 in a process group of
N ranks; one process and one device a rank): each rank trains its rows of
every global batch (``Datamodule.set_process``) and the step computes what
the JAX program computes over a data mesh of N devices
(``tests/test_trainer.py:69``): BatchNorm statistics of the global batch and
drop-connect masks drawn for it (``EfficientNetUNet.set_data_axis``), the
losses' denominators summed over the ranks, and after backward the f32
gradient sums summed over the ranks in a few flat buckets with the step's
loss (``DataAxis.all_reduce_flat_``): each rank's loss is its share of the
global loss, so the sum is the global batch's gradient, not N times it.
Every rank then applies the same update to the same replicated parameters.
The train and eval confusion matrices and eval loss sums are summed over
the ranks before the metrics. With gradient accumulation, a rank's
micro-batch m is its slice of global micro-batch m, and the sum over the
ranks runs once, after the last micro-batch.

fc-prithvi trains on a data axis too (``PrithviSegmentationNet.set_data_axis``):
the head's BatchNorm takes the global batch's statistics and its dropout
draws the global batch's keep mask, of which each rank keeps its rows; every
rank loads the same backbone, and rank 0's parameters are replicated. With a
frozen backbone the gradient buckets hold the trainable parameters only; the
unfreeze builds new buckets (they key on the list of shapes) and drops the
step graph. BatchNorm recalibration skips fc-prithvi, as the JAX trainer does
(its model config has no ``bn_momentum_override``).

The sharded corpus (``train.device_corpus_sharded`` on a data axis of N > 1
ranks, ``:784-802``): each rank uploads only its block of the segments
(``DeviceCorpus(data=...)``), every rank draws the same per-block epoch
orders (weighted per block when the sampling is), and each trains the
block's rows it owns, gathered by local ids with no collective; BatchNorm
recalibration draws its batches the same way (``:1018-1045``). On one rank
it is the plain corpus, as in the JAX trainer.

A model axis (``mesh=make_mesh(n, model_parallel=m)``): a batch lies over the
data axis only (``P('data')``), so the m ranks of a model group train the
same rows. With ``param_sharding="replicated"`` (the default) every model
peer runs the same step on whole parameters. With ``param_sharding="fsdp"``
(``:341-362``) every parameter that ``fsdp_param_shardings``' rule shards
(``parallel.mesh.ShardedParameters``: at least 2**16 elements, on the
kernel's largest axis that m divides) is held as this rank's slice, and so
are its Adam moments, its f32 master and its EMA, which update elementwise;
BatchNorm statistics and the other parameters stay whole. Each step sees the
whole parameters through one all-gather (``whole_weights``), whose backward
keeps this rank's slice of the gradient that every model peer computes
alike; the data axis then sums the slices as it sums whole gradients. The
watch norms sum the slices' squares over the model axis, and checkpoints
hold whole tensors (``train.base.TrainerBase._checkpoint_state``), so an
FSDP run and a one-rank run resume each other's checkpoints and
``cli.infer`` serves them unchanged. fc-prithvi shards its backbone too,
frozen or not; the unfreeze builds Adam over the slices.
"""

from __future__ import annotations

import itertools
import time
import typing

import numpy as np
import torch
import torch.distributed as dist

from s2tpu_torch import resolve_device
from s2tpu_torch.configs.data_config import BANDS as PRITHVI_BANDS
from s2tpu_torch.configs.data_config import LABEL_MAPS, parse_bands
from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES, Config
from s2tpu_torch.data.augment import augment_batch, model_input, normalize
from s2tpu_torch.data.device_corpus import DeviceCorpus
from s2tpu_torch.data.pipeline import Datamodule, prefetch_to_device
from s2tpu_torch.models.efficientnet_unet import BatchNorm, EfficientNetUNet
from s2tpu_torch.parallel.mesh import (
    ShardedParameters, data_axis, mesh_device, mesh_for_num_devices, model_axis, replicate_module,
)
from s2tpu_torch.train import metrics as metrics_lib
from s2tpu_torch.train.losses import make_loss_fn
from s2tpu_torch.train.schedules import build_schedule
from s2tpu_torch.train.base import TrainerBase
from s2tpu_torch.train.train_state import accumulate_grads, make_optimizer
from s2tpu_torch.utils import get_logger

logger = get_logger(__name__)


PARAM_SHARDINGS = ("replicated", "fsdp")


def pool_batch_stats(stats: list[tuple[torch.Tensor, torch.Tensor]]) -> tuple[torch.Tensor, torch.Tensor]:
    """Pool one BatchNorm's exact (mean, biased var) over equal-size batches
    (``s2tpu/train/trainer.py:53-72``): E[x] is the mean of the batch means,
    Var[x] = mean(var + mean^2) - E[x]^2, clipped at 0; in f64, returned in
    the inputs' dtype."""
    means = torch.stack([m.double() for m, _ in stats])
    ex2 = torch.stack([v.double() + m.double() ** 2 for m, v in stats]).mean(0)
    mean = means.mean(0)
    dtype = stats[0][0].dtype
    return mean.to(dtype), (ex2 - mean * mean).clamp_min(0.0).to(dtype)


class SegmentationTrainer(TrainerBase):
    """Trains ``config``'s model on ``datamodule``'s batches on one device
    (``resolve_device``: the card unless ``device="cpu"``), or as one rank
    of ``mesh`` (or of the mesh ``train.num_devices`` asks for) on the
    rank's device, its parameters whole or (``param_sharding="fsdp"``)
    sharded over the mesh's model axis. Only rank 0 logs (``run_logger``)
    and writes checkpoints."""

    def __init__(
        self,
        config: Config,
        datamodule: Datamodule,
        run_logger=None,
        checkpoint_manager=None,
        device: torch.device | str | None = None,
        mesh=None,
        param_sharding: str = "replicated",
    ) -> None:
        if param_sharding not in PARAM_SHARDINGS:
            raise ValueError(f"param_sharding={param_sharding!r}: one of {PARAM_SHARDINGS}")
        t = config.train
        self.mesh = mesh if mesh is not None else mesh_for_num_devices(
            t.num_devices, resolve_device(device).type, "s2tpu_torch.cli.train_segmentation")
        self.data_axis = data_axis(self.mesh)
        self.model_axis = model_axis(self.mesh)
        n_data = self.data_axis.size
        if t.num_devices not in (-1, n_data):
            raise ValueError(f"train.num_devices={t.num_devices}, but the mesh's data axis holds {n_data} ranks")
        if config.datamodule.batch_size % n_data:
            raise ValueError(
                f"batch_size {config.datamodule.batch_size} must be divisible by the data-parallel mesh size "
                f"{n_data} (set train.num_devices or the batch size)"
            )
        self.is_prithvi = config.model_name.value.startswith("fc-prithvi")
        self.config = config
        self.dm = datamodule
        self.device = resolve_device(device) if self.mesh is None else mesh_device(self.mesh)
        self.is_main = self.mesh is None or dist.get_rank() == 0
        self.run_logger = run_logger if self.is_main else None
        self.ckpt = checkpoint_manager
        if n_data > 1:
            datamodule.set_process(n_data, self.data_axis.index, max(t.grad_accum_steps, 1))
        self.compute_dtype = COMPUTE_DTYPES[t.compute_dtype]
        self.model = config.build_model(
            dtype=self.compute_dtype, device=self.device, param_dtype=torch.float32,
            generator=torch.Generator().manual_seed(t.seed),
        )
        if self.is_prithvi:
            self._load_prithvi_backbone()
        self.model.set_data_axis(self.data_axis)
        if self.mesh is not None and dist.get_world_size() > 1:
            replicate_module(self.model, self.mesh)
        if param_sharding == "fsdp" and self.model_axis.size > 1:
            self.shards = ShardedParameters(self.model, self.model_axis)
        mean, std = datamodule.mean_std()
        in_ch = config.datamodule.dataset_cfg.in_channels
        if len(mean) != in_ch:
            raise ValueError(
                f"band-count mismatch: the dataset statistics carry {len(mean)} channels "
                f"but dataset_cfg.bands names {in_ch}; set --bands to the rasters' band set"
            )
        self.mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
        self.std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)
        self.loss_fn = make_loss_fn(
            t.loss_type.value,
            num_classes=config.num_classes,
            masked_loss=t.masked_loss,
            weighted_loss=t.weighted_loss,
            class_distribution=t.class_distribution,
            label_smoothing=t.label_smoothing,
            focal_gamma=t.focal_loss_gamma,
            dice_eps=t.dice_eps,
            dice_weight=t.dice_focal_dice_weight,
            focal_weight=t.dice_focal_focal_weight,
            device=self.device,
            data_axis=self.data_axis,
        )
        steps_per_epoch = max(len(datamodule.train_idx) // config.datamodule.batch_size, 1)
        self.schedule = build_schedule(
            t.lr,
            t.lr_scheduler_type.value if t.lr_scheduler_type else None,
            steps_per_epoch=steps_per_epoch,
            step_size_epochs=t.step_lr_sched_step_size,
            step_gamma=t.step_lr_sched_gamma,
            first_cycle_epochs=t.cosine_lr_sched_first_cycle_steps,
            cycle_mult=t.cosine_lr_sched_cycle_mult,
            max_lr=t.cosine_lr_sched_max_lr,
            min_lr=t.cosine_lr_sched_min_lr,
            warmup_epochs=t.cosine_lr_sched_warmup_steps,
            gamma=t.cosine_lr_sched_gamma,
        )
        self._init_params(t)
        self.optimizer = make_optimizer(self.model.parameters(), self.schedule(0), t.weight_decay, t.betas,
                                        self.master)
        dmc = config.datamodule
        # Flips run on the host in its crop gather when host_flips is on; the
        # corpus has no host gather, so its flips run on the device (:447-449).
        self.device_flips = dmc.augment and (t.device_corpus or not dmc.host_flips)
        self.corpus = None
        if t.device_corpus:
            self.corpus = DeviceCorpus(datamodule.source, self.device,
                                       data=self.data_axis if t.device_corpus_sharded else None)

    # ------------------------------------------------------------------
    def _load_prithvi_backbone(self) -> None:
        """Pretrained weights into fc-prithvi's backbone: the encoder of a port
        MAE run directory (``train.backbone_ckpt``, this system's own
        pretrain -> finetune flow; decoder keys dropped, the encoder loaded
        with strict=True) or the published ``weights/Prithvi_100M.pt``
        (encoder only). Missing weights only warn, LOUDLY when the backbone
        is frozen: a head fitted to a frozen random encoder is meaningless."""
        from s2tpu_torch.checkpoint.convert import encoder_state_dict, load_prithvi_weights

        backbone, frozen = self.model.backbone, self.model.frozen_backbone
        if self.config.train.backbone_ckpt:
            from s2tpu_torch.checkpoint.io import load_mae_checkpoint

            _, state = load_mae_checkpoint(self.config.train.backbone_ckpt)
            backbone.load_state_dict(encoder_state_dict(state), strict=True)
            logger.info(f"Loaded MAE-pretrained backbone from {self.config.train.backbone_ckpt}")
            return
        bands = parse_bands(self.config.datamodule.dataset_cfg.bands)
        if bands != list(PRITHVI_BANDS):
            # The published patch embedding belongs to the six Prithvi-HLS
            # bands: band identity, not count, decides.
            msg = (
                f"fc-prithvi with bands={bands}: the published Prithvi_100M.pt is trained on "
                f"{list(PRITHVI_BANDS)} and cannot initialize this backbone; the encoder starts from random "
                "init (pretrain with cli.train_mae on the same band set and pass --backbone-ckpt for a "
                "matched encoder)."
            )
            logger.warning(msg + (" The backbone is FROZEN: unfreeze it or this head fits a random encoder."
                                  if frozen else ""))
            return
        try:
            load_prithvi_weights(backbone, include_decoder=False)
            logger.info("Loaded pretrained Prithvi backbone weights")
        except FileNotFoundError as e:
            if frozen:
                logger.warning(
                    f"Prithvi weights unavailable ({e}) and the backbone is FROZEN: training would fit the "
                    "head to a frozen RANDOM encoder, which is meaningless. Provide weights/Prithvi_100M.pt "
                    "or unfreeze the backbone."
                )
            else:
                logger.warning(f"Prithvi weights unavailable ({e}); backbone trains from random init")

    def unfreeze_backbone(self) -> None:
        """The frozen-then-unfrozen transition (BASELINE config #4): the
        backbone trains from here on, with a fresh Adam over ALL parameters
        (the frozen phase's has no moments for the backbone); parameters,
        BatchNorm statistics, the step counter, the f32 master (exact, not
        re-derived from the bf16 parameters) and the EMA carry over, and
        ``train.unfreeze_lr_scale`` multiplies the schedule from now on. A
        no-op unless a frozen fc-prithvi is live."""
        if not (self.is_prithvi and self.model.frozen_backbone):
            return
        logger.info(
            f"Unfreezing Prithvi backbone: full-network training from step {self.step} "
            "(fresh optimizer moments; params/BN/step/master/EMA carry over)"
        )
        t = self.config.train
        t.frozen_backbone = False
        self.model.set_frozen(False)
        scale = t.unfreeze_lr_scale
        if scale != 1.0:
            base = self.schedule
            self.schedule = lambda step, _base=base: _base(step) * scale
        self.optimizer = make_optimizer(self.model.parameters(), self.schedule(self.step), t.weight_decay, t.betas,
                                        self.master)
        self._graph = None  # a new optimizer: capture the step again

    def _maybe_unfreeze(self, epoch: int) -> None:
        """The scheduled unfreeze on entering ``epoch`` (also on resuming into
        a later epoch than the transition)."""
        at = self.config.train.unfreeze_backbone_at_epoch
        if at is not None and epoch >= at:
            self.unfreeze_backbone()

    _enter_epoch = _before_restore = _maybe_unfreeze

    def _input(self, images: torch.Tensor) -> torch.Tensor:
        x = normalize(images, self.mean, self.std, dtype=self.compute_dtype)
        ds = self.config.datamodule.dataset_cfg
        return model_input(x, ds.stack_time_into_channels, ds.squeeze_time_dim)

    def _ignore_index(self) -> int | None:
        return 0 if self.config.train.masked_loss else None

    def _learning_rate(self) -> float:
        return self.schedule(self.step)  # optax reads the schedule at the update count

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> dict[str, typing.Any]:
        """One optimizer update on a device batch, in ``grad_accum_steps``
        micro-batches; returns the device-side loss, confusion matrix and
        loss components (no host sync), and the watch norms on a watched
        step."""
        self._begin_step()
        out = self._step(images, labels)
        self.step += 1
        return out

    def _step(self, images: torch.Tensor, labels: torch.Tensor) -> dict[str, typing.Any]:
        """The device work of one step, after ``_begin_step``: flips (when
        ``device_flips``), normalization, forward, loss, backward and the
        update, with no host sync (a CUDA graph captures it)."""
        t, dmc = self.config.train, self.config.datamodule
        accum = max(t.grad_accum_steps, 1)
        if images.shape[0] % accum:
            raise ValueError(f"batch {images.shape[0]} does not split into {accum} micro-batches")
        self.model.train()
        self._zero_grads()
        named = self._trainable()
        grads, loss, cm, comps = None, 0.0, 0, {}
        ds = dmc.dataset_cfg
        with self.whole_weights():
            for x, y, g in zip(images.chunk(accum), labels.chunk(accum), self.generators):
                x, y = augment_batch(
                    x, y, g, self.mean, self.std, p_horizontal=dmc.random_horizontal_flip_p,
                    p_vertical=dmc.random_vertical_flip_p, dtype=self.compute_dtype, train=self.device_flips,
                    data_axis=self.data_axis,
                )
                logits = self.model(model_input(x, ds.stack_time_into_channels, ds.squeeze_time_dim), generator=g)
                out = self.loss_fn(logits, y)
                out.total.backward()
                grads = accumulate_grads([p for _, p in named], grads)
                with torch.no_grad():
                    cm = cm + metrics_lib.confusion_matrix_update(
                        logits.argmax(-1), y, self.config.num_classes, ignore_index=self._ignore_index()
                    )
                loss = loss + out.total.detach()
                comps = {k: comps.get(k, 0.0) + v.detach() for k, v in out.components.items()}
        if self.data_axis.size > 1:
            # Each rank's loss is its share of the global loss: the sums over
            # the ranks are the global batch's gradient and loss.
            scalars = torch.stack([loss, *comps.values()])
            self.data_axis.all_reduce_flat_([*grads, scalars])
            loss, comps = scalars[0], dict(zip(comps, scalars[1:]))
        update = self._update(named, grads, accum, self._watch_this_step())
        return {"loss": loss / accum, "cm": cm, **{k: v / accum for k, v in comps.items()}, **update}

    def _corpus_sum_shapes(self) -> dict[str, tuple[int, ...]]:
        k = self.config.num_classes
        return {"loss": (), "cm": (k, k)}

    def _corpus_step(self, row: torch.Tensor) -> dict[str, typing.Any]:
        images, labels = self.corpus.gather(row[0], row[1], row[2], self.config.datamodule.random_crop_size)
        m = self._step(images, labels)
        self._add_to_sums(m)
        return m

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, labels: torch.Tensor, batch_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        """Loss and confusion matrix of a padded eval batch from running
        statistics, on the weights in the model (``eval_weights`` puts the
        EMA there)."""
        self.model.eval()
        with self.whole_weights():
            logits = self.model(self._input(images))
        out = self.loss_fn(logits, labels, batch_mask=batch_mask)
        cm = metrics_lib.confusion_matrix_update(
            logits.argmax(-1), labels, self.config.num_classes,
            ignore_index=self._ignore_index(), batch_mask=batch_mask,
        )
        return {"loss": out.total, "cm": cm}

    # ------------------------------------------------------------------
    def _metric_exclude_index(self) -> int | None:
        """Class left out of macro IoU/F1 (torchmetrics ``ignore_index``
        averaging): the masked background class."""
        return self._ignore_index()

    def run_train_epoch(self, epoch: int) -> dict:
        if self.corpus is not None:
            n, sums, seconds = self._run_corpus_epoch(epoch, self.dm._sample_weights)
            if n == 0:  # a resumed epoch whose batches were all trained
                return {"loss": float("nan"), "images_per_sec": 0.0}
            out = metrics_lib.compute_metrics(self._global_cm(sums["cm"]),
                                              exclude_index=self._metric_exclude_index())
            out["loss"] = float(sums["loss"]) / n
            out["images_per_sec"] = n * self.config.datamodule.batch_size / max(seconds, 1e-9)
            return out
        cfg = self.config
        t0 = time.time()
        skip, self._skip_batches = self._skip_batches, 0
        batches = prefetch_to_device(
            self.dm.train_batches(epoch, overfit_batches=cfg.train.overfit_batches, start=skip),
            self.device, depth=cfg.datamodule.prefetch,
        )
        outs, n, images_seen = self._train_loop(epoch, batches, lambda b: self.train_step(b.images, b.labels), skip)
        if n == 0:  # a resumed epoch whose batches were all trained
            return {"loss": float("nan"), "images_per_sec": 0.0}
        # summed in step order, as the corpus epoch sums on the device
        cm = sum((m["cm"] for m in outs[1:]), outs[0]["cm"])
        out = metrics_lib.compute_metrics(self._global_cm(cm), exclude_index=self._metric_exclude_index())
        out["loss"] = float(sum((m["loss"] for m in outs[1:]), outs[0]["loss"])) / n
        out["images_per_sec"] = images_seen * self.data_axis.size / max(time.time() - t0, 1e-9)  # global
        return out

    def _global_cm(self, cm: torch.Tensor) -> np.ndarray:
        """An epoch's confusion matrix summed over the data axis, on the host
        (the train loss needs no sum: each step's is already global)."""
        cm = cm.clone()
        self.data_axis.all_reduce_flat_([cm])
        return cm.cpu().numpy()

    def run_eval_epoch(self, split: str = "val") -> dict:
        acc = metrics_lib.MetricAccumulator(self.config.num_classes, ignore_index=self._metric_exclude_index())
        with self.eval_weights():
            for batch in prefetch_to_device(self.dm.eval_batches(split), self.device, depth=2):
                m = self.eval_step(batch.images, batch.labels, batch.mask)
                acc.update(m["cm"].cpu().numpy(), float(m["loss"]))
        if self.data_axis.size > 1:  # each rank's sums over its slices: the global batches' sums
            sums = torch.from_numpy(np.append(acc.cm.ravel(), acc.loss_sum)).to(self.device)
            self.data_axis.all_reduce_flat_([sums])
            sums = sums.cpu().numpy()
            acc.cm, acc.loss_sum = sums[:-1].reshape(acc.cm.shape), float(sums[-1])
        return acc.compute()

    @torch.no_grad()
    def recalibrate_bn(self, n_batches: int = 8) -> None:
        """Every BatchNorm's running statistics := exact statistics pooled
        over ``n_batches`` train batches, taken with the eval weights
        (``s2tpu/train/trainer.py:1052-1085``): a train-mode forward per batch
        at momentum 0 (so the running statistics become that batch's), no
        flips, drop-connect drawn from a fixed seed, parameters untouched.
        The batches are the first of epoch 0's stream, or, with the device
        corpus, gathered from it by the JAX package's own draws
        (:meth:`_recal_corpus_batches`). Models without BatchNorm momentum (the
        ViT) are skipped, as in the JAX package."""
        if not isinstance(self.model, EfficientNetUNet):
            logger.warning("recalibrate_bn: the model has no bn_momentum_override; skipping")
            return
        bns = [m for m in self.model.modules() if isinstance(m, BatchNorm)]
        decays = [bn.decay for bn in bns]
        stats: list[list[tuple[torch.Tensor, torch.Tensor]]] = [[] for _ in bns]
        self.model.train()
        generator = self.generators[0]
        try:
            for bn in bns:
                bn.decay = 0.0
            with self.eval_weights(), self.whole_weights():
                if self.corpus is not None:
                    batches = self._recal_corpus_batches(n_batches)
                else:
                    host = itertools.islice(self.dm.train_batches(0), n_batches)
                    batches = (b.images for b in prefetch_to_device(host, self.device, depth=2))
                for images in batches:
                    generator.manual_seed(0)  # the JAX pass's fixed dropout key
                    self.model(self._input(images), generator=generator)
                    for s, bn in zip(stats, bns):
                        s.append((bn.running_mean.clone(), bn.running_var.clone()))
        finally:
            for bn, decay in zip(bns, decays):
                bn.decay = decay
        if not stats[0]:
            return
        for bn, s in zip(bns, stats):
            mean, var = pool_batch_stats(s)
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)

    def _recal_corpus_batches(self, n_batches: int) -> typing.Iterator[torch.Tensor]:
        """Up to ``n_batches`` batches of crops gathered on the device from
        the corpus, with no host image traffic (``:1004-1050``): drawn as an
        epoch draws them (:meth:`_corpus_sampler`: a permutation of the train
        split, or of each block's pool on the sharded corpus, and random
        crops), from a generator of their own, seeded by (shuffle_seed,
        0x5EED), distinct from every epoch's stream."""
        dmc = self.config.datamodule
        sample, available = self._corpus_sampler(np.random.default_rng((dmc.shuffle_seed, 0x5EED)), None, 0, True)
        for b in range(min(n_batches, available)):
            idx, ys, xs = torch.from_numpy(sample(b)).to(self.device)
            yield self.corpus.gather(idx, ys, xs, dmc.random_crop_size)[0]

    def _end_epoch(self, epoch: int, train_metrics: dict) -> dict:
        """BN recalibration, the val pass, the epoch's record and its logs."""
        cfg = self.config
        if cfg.train.bn_recalibration_batches > 0 and len(self.dm.val_idx):
            self.recalibrate_bn(cfg.train.bn_recalibration_batches)
        val_metrics = self.run_eval_epoch("val") if len(self.dm.val_idx) else {}
        record = {
            "epoch": epoch,
            "train/lr": float(self.schedule(self.step)),
            **{f"train/{k}": v for k, v in train_metrics.items() if np.isscalar(v)},
            **{f"val/{k}": v for k, v in val_metrics.items() if np.isscalar(v)},
        }
        pci = val_metrics.get("per_class_iou")
        if pci is not None:
            class_names = LABEL_MAPS[cfg.datamodule.dataset_cfg.label_map].class_names
            record.update({
                f"val/iou_{class_names[k] if k < len(class_names) else k}": float(v)
                for k, v in enumerate(np.asarray(pci, np.float64)) if np.isfinite(v)
            })
        if self.is_main:
            logger.info(
                f"epoch {epoch}: train loss {train_metrics.get('loss', float('nan')):.4f} "
                f"iou {train_metrics.get('iou', float('nan')):.4f} | "
                f"val loss {val_metrics.get('loss', float('nan')):.4f} "
                f"iou {val_metrics.get('iou', float('nan')):.4f} | "
                f"{train_metrics.get('images_per_sec', 0):.1f} img/s"
            )
        if self.run_logger is not None:
            self.run_logger.log_scalars({k: v for k, v in record.items() if k != "epoch"}, step=self.step)
            self._log_epoch_images(val_metrics or train_metrics)
        return record

    def _log_epoch_images(self, epoch_metrics: dict) -> None:
        """The confusion matrix and two prediction overlays, one random
        validation sample (``default_rng(step)``) and sample 0, each
        center-cropped (``s2tpu/train/trainer.py:1229-1289``). Never stops
        training: a failure is a warning."""
        plt = self._image_pyplot()
        if plt is None:
            return
        from s2tpu_torch.plotting import confusion_matrix_figure, plot_sentinel_and_mask, stretch_rgb

        try:
            step = self.step
            cfg = self.config
            lm = LABEL_MAPS[cfg.datamodule.dataset_cfg.label_map]
            cm = epoch_metrics.get("confusion_matrix")
            if cm is not None:
                names = lm.class_names[1:] if cfg.train.masked_loss else lm.class_names
                cm_vis = cm[1:, 1:] if (cfg.train.masked_loss and cm.shape[0] == lm.num_classes) else cm
                self.run_logger.log_image("val/confusion_matrix",
                                          confusion_matrix_figure(cm_vis, names[: cm_vis.shape[0]]), step)
            indices = self.dm.val_idx if len(self.dm.val_idx) else self.dm.train_idx
            rng = np.random.default_rng(step)
            for name, idx in (
                ("val/segmentation", int(rng.choice(indices))),
                ("val/fixed_prediction_dynamics", int(indices[0])),
            ):
                sample = self.dm.source[idx]
                crop = cfg.datamodule.random_crop_size
                # samples are (H, W, C) or, multi-temporal, (T, H, W, C)
                y0 = (sample.x.shape[-3] - crop) // 2
                x0 = (sample.x.shape[-2] - crop) // 2
                img = sample.x[..., y0 : y0 + crop, x0 : x0 + crop, :]
                lbl = sample.y[y0 : y0 + crop, x0 : x0 + crop]
                pred = self._predict_classes(img)
                disp = img[0] if img.ndim == 4 else img  # first frame of a T > 1 stack
                fig = plot_sentinel_and_mask(stretch_rgb(disp.transpose(2, 0, 1)), lbl, lm, pred=pred)
                self.run_logger.log_image(name, fig, step)
                plt.close("all")
        except Exception as e:  # noqa: BLE001 - image logging must never kill training
            logger.warning(f"epoch image logging failed: {e}", exc_info=True)

    @torch.no_grad()
    def _predict_classes(self, image: np.ndarray) -> np.ndarray:
        """The eval weights' class map of one int16 ([T,] H, W, C) image, in
        eval mode (the model's mode is restored after)."""
        was_training = self.model.training
        self.model.eval()
        try:
            with self.eval_weights(), self.whole_weights():
                logits = self.model(self._input(torch.from_numpy(np.array(image)[None]).to(self.device)))
            return logits[0].argmax(-1).cpu().numpy()
        finally:
            self.model.train(was_training)
