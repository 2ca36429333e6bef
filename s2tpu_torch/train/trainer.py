"""Segmentation trainer: eager train/eval steps and the epoch loop (the port of ``s2tpu/train/trainer.py``).

One train step normalizes the int16 crops on the device, runs the model in
the compute dtype over f32 parameters, computes the loss (the fused CE/focal
kernels on the card), back-propagates (the depthwise kernels' input and
filter gradients on the card), and applies Adam with coupled L2 at the
schedule's learning rate for that step. The confusion matrix accumulates on
the device; the host reads the loss only at ``log_interval`` and at epoch end.

Ported: ``train_step``/``eval_step`` (``:451-570``), ``run_train_epoch``,
``run_eval_epoch``, ``_metric_exclude_index``, epoch-level
``resume_from_checkpoint`` and ``fit`` (``:885-933``, ``:1086-1227``), and
fc-prithvi's hooks: the pretrained backbone (``_load_prithvi_backbone``,
``:369-436``), the frozen backbone kept out of the optimizer, and the
frozen-then-unfrozen transition (``unfreeze_backbone``, ``_maybe_unfreeze``,
``:636-709``).
Not ported yet, and refused where the config asks for them: gradient
accumulation, remat, bf16 parameter storage with an f32 master, parameter
EMA, BN recalibration, the device corpus and device-side flips. Watch norms
(``watch_interval``), SIGTERM preemption and epoch image logging are not
ported and have no effect.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from s2tpu_torch import resolve_device
from s2tpu_torch.configs.data_config import BANDS as PRITHVI_BANDS
from s2tpu_torch.configs.data_config import LABEL_MAPS, parse_bands
from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES, Config
from s2tpu_torch.data.augment import model_input, normalize
from s2tpu_torch.data.pipeline import Datamodule, prefetch_to_device
from s2tpu_torch.train import metrics as metrics_lib
from s2tpu_torch.train.losses import make_loss_fn
from s2tpu_torch.train.schedules import build_schedule
from s2tpu_torch.train.train_state import make_optimizer
from s2tpu_torch.utils import get_logger, get_unique_run_name

logger = get_logger(__name__)


def _refuse_unported(config: Config) -> None:
    t, dm = config.train, config.datamodule
    unported = {
        "param_dtype='bfloat16' (f32 master)": t.param_dtype != "float32",
        "remat": t.remat,
        "grad_accum_steps > 1": t.grad_accum_steps > 1,
        "ema_decay": t.ema_decay is not None,
        "bn_recalibration_batches > 0": t.bn_recalibration_batches > 0,
        "device_corpus": t.device_corpus or t.device_corpus_sharded,
        "device-side flips (host_flips=False)": dm.augment and not dm.host_flips,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"not ported to s2tpu_torch yet: {', '.join(asked)}")


class SegmentationTrainer:
    """Trains ``config``'s model on ``datamodule``'s batches on one device
    (``resolve_device``: the card unless ``device="cpu"``)."""

    def __init__(
        self,
        config: Config,
        datamodule: Datamodule,
        run_logger=None,
        checkpoint_manager=None,
        device: torch.device | str | None = None,
    ) -> None:
        _refuse_unported(config)
        self.config = config
        self.dm = datamodule
        self.device = resolve_device(device)
        self.run_logger = run_logger
        self.ckpt = checkpoint_manager
        t = config.train
        self.compute_dtype = COMPUTE_DTYPES[t.compute_dtype]
        self.is_prithvi = config.model_name.value.startswith("fc-prithvi")
        self.model = config.build_model(
            dtype=self.compute_dtype, device=self.device, param_dtype=torch.float32,
            generator=torch.Generator().manual_seed(t.seed),
        )
        if self.is_prithvi:
            self._load_prithvi_backbone()
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
        self.optimizer = make_optimizer(self.model.parameters(), self.schedule(0), t.weight_decay, t.betas)
        self.step = 0  # optimizer updates applied so far
        # Drop-connect (UNet) and dropout (fc-prithvi's head) masks are drawn
        # on the device from this generator.
        self.drop_generator = torch.Generator(device=self.device).manual_seed(t.seed)

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
        BatchNorm statistics and the step counter carry over, and
        ``train.unfreeze_lr_scale`` multiplies the schedule from now on. A
        no-op unless a frozen fc-prithvi is live."""
        if not (self.is_prithvi and self.model.frozen_backbone):
            return
        logger.info(
            f"Unfreezing Prithvi backbone: full-network training from step {self.step} "
            "(fresh optimizer moments; params/BN/step carry over)"
        )
        t = self.config.train
        t.frozen_backbone = False
        self.model.set_frozen(False)
        scale = t.unfreeze_lr_scale
        if scale != 1.0:
            base = self.schedule
            self.schedule = lambda step, _base=base: _base(step) * scale
        self.optimizer = make_optimizer(self.model.parameters(), self.schedule(self.step), t.weight_decay, t.betas)

    def _maybe_unfreeze(self, epoch: int) -> None:
        """The scheduled unfreeze on entering ``epoch`` (also on resuming into
        a later epoch than the transition)."""
        at = self.config.train.unfreeze_backbone_at_epoch
        if at is not None and epoch >= at:
            self.unfreeze_backbone()

    def _input(self, images: torch.Tensor) -> torch.Tensor:
        x = normalize(images, self.mean, self.std, dtype=self.compute_dtype)
        ds = self.config.datamodule.dataset_cfg
        return model_input(x, ds.stack_time_into_channels, ds.squeeze_time_dim)

    def _ignore_index(self) -> int | None:
        return 0 if self.config.train.masked_loss else None

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
        """One optimizer update on a device batch; returns the device-side
        loss, confusion matrix and loss components (no host sync)."""
        self.model.train()
        lr = self.schedule(self.step)  # optax reads the schedule at the update count
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        logits = self.model(self._input(images), generator=self.drop_generator)
        out = self.loss_fn(logits, labels)
        self.optimizer.zero_grad(set_to_none=True)
        out.total.backward()
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            cm = metrics_lib.confusion_matrix_update(
                logits.argmax(-1), labels, self.config.num_classes, ignore_index=self._ignore_index()
            )
        return {"loss": out.total.detach(), "cm": cm, **{k: v.detach() for k, v in out.components.items()}}

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, labels: torch.Tensor, batch_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        """Loss and confusion matrix of a padded eval batch from running statistics."""
        self.model.eval()
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
        cfg = self.config
        acc_loss, acc_cm, n, images_seen = None, None, 0, 0
        t0 = time.time()
        batches = prefetch_to_device(
            self.dm.train_batches(epoch, overfit_batches=cfg.train.overfit_batches),
            self.device, depth=cfg.datamodule.prefetch,
        )
        for i, batch in enumerate(batches):
            m = self.train_step(batch.images, batch.labels)
            acc_loss = m["loss"] if acc_loss is None else acc_loss + m["loss"]
            acc_cm = m["cm"] if acc_cm is None else acc_cm + m["cm"]
            n += 1
            images_seen += batch.images.shape[0]
            if self.run_logger is not None and (i + 1) % cfg.train.log_interval == 0:
                self.run_logger.log_scalars({"train/loss_step": float(m["loss"])}, step=self.step)
        if n == 0:
            raise ValueError(
                f"train epoch {epoch} produced ZERO batches: the train pool "
                f"({len(self.dm.train_idx)} segments) is smaller than one batch "
                f"({cfg.datamodule.batch_size}); reduce --bs or grow the dataset/split"
            )
        out = metrics_lib.compute_metrics(acc_cm.cpu().numpy(), exclude_index=self._metric_exclude_index())
        out["loss"] = float(acc_loss) / n
        out["images_per_sec"] = images_seen / max(time.time() - t0, 1e-9)
        return out

    def run_eval_epoch(self, split: str = "val") -> dict:
        acc = metrics_lib.MetricAccumulator(self.config.num_classes, ignore_index=self._metric_exclude_index())
        for batch in prefetch_to_device(self.dm.eval_batches(split), self.device, depth=2):
            m = self.eval_step(batch.images, batch.labels, batch.mask)
            acc.update(m["cm"].cpu().numpy(), float(m["loss"]))
        return acc.compute()

    def resume_from_checkpoint(self, epoch: int | None = None) -> int:
        """Restore model, optimizer and step from the checkpoint manager's
        ``epoch`` (default: its latest); returns the epoch to continue from,
        0 when there is no checkpoint."""
        if self.ckpt is None:
            raise ValueError("resume requires a checkpoint manager")
        latest = epoch if epoch is not None else self.ckpt.latest_epoch()
        if latest is None:
            return 0
        restored = self.ckpt.restore(latest)
        self.step = restored["step"]
        # A checkpoint written at the end of epoch e holds epoch e's
        # optimizer: of every parameter once the backbone has unfrozen.
        self._maybe_unfreeze(latest)
        self.model.load_state_dict(restored["model"], strict=True)
        self.optimizer.load_state_dict(restored["optimizer"])
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
        class_names = LABEL_MAPS[cfg.datamodule.dataset_cfg.label_map].class_names
        for epoch in range(start_epoch, max_epochs):
            self._maybe_unfreeze(epoch)
            train_metrics = self.run_train_epoch(epoch)
            val_metrics = self.run_eval_epoch("val") if len(self.dm.val_idx) else {}
            record = {
                "epoch": epoch,
                "train/lr": float(self.schedule(self.step)),
                **{f"train/{k}": v for k, v in train_metrics.items() if np.isscalar(v)},
                **{f"val/{k}": v for k, v in val_metrics.items() if np.isscalar(v)},
            }
            pci = val_metrics.get("per_class_iou")
            if pci is not None:
                record.update({
                    f"val/iou_{class_names[k] if k < len(class_names) else k}": float(v)
                    for k, v in enumerate(np.asarray(pci, np.float64)) if np.isfinite(v)
                })
            history.append(record)
            logger.info(
                f"epoch {epoch}: train loss {train_metrics.get('loss', float('nan')):.4f} "
                f"iou {train_metrics.get('iou', float('nan')):.4f} | "
                f"val loss {val_metrics.get('loss', float('nan')):.4f} "
                f"iou {val_metrics.get('iou', float('nan')):.4f} | "
                f"{train_metrics.get('images_per_sec', 0):.1f} img/s"
            )
            if self.run_logger is not None:
                self.run_logger.log_scalars({k: v for k, v in record.items() if k != "epoch"}, step=self.step)
            if self.ckpt is not None and (epoch + 1) % cfg.train.ckpt_every_n_epochs == 0:
                self.ckpt.save_epoch(epoch, self.model, self.optimizer, self.step, metrics=record)
        return history
