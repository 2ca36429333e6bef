"""Prithvi MAE pretraining / finetuning trainer (the port of ``s2tpu/train/mae_trainer.py``).

One train step normalizes the int16 crops on the device, draws the (B, L)
masking noise from a device ``torch.Generator`` seeded from (seed, step) as
the JAX step folds the step into its key, runs the Prithvi MAE in the
compute dtype over f32 parameters (attention through the fused kernels
#8/#9 or the streaming kernel #5 where the JAX route sends it), and applies
Adam with coupled L2 at the constant configured learning rate (the MAE
linear scaling rule is applied by the config presets). Evaluation recomputes
the loss with padded rows left out of numerator and denominator, with the
same masking noise for every batch (the JAX eval step reuses its base key).

Flips: the JAX MAE path flips twice, on the host in the Datamodule
(``host_flips``) and again on the device in ``augment_batch``. The XOR of two
independent fair coins is a fair coin, so the port's single host flip per
axis gives crops of the same distribution; there is no device augmentation
and no augment key.

``from_scratch=False`` loads ``weights/Prithvi_100M.pt`` (published layout)
when present and otherwise warns and keeps the random init, as the JAX
trainer does.

With a ``mesh`` (``s2tpu_torch.parallel.mesh.make_mesh``) one trainer runs
in each process of the mesh's group, on the rank's device: a model config
with ``tp_axis`` splits the heads and MLP hidden over the 'model' group
(``PrithviConfig(tp_axis=MODEL_AXIS)``, as the JAX trainer takes it), the
parameters start as rank 0's, every rank sees the same batches (the same
shuffle seed) and draws the same masking noise (the same generator seed),
and only rank 0 logs and writes checkpoints. The data axis holds one rank.

Not ported, and refused where the config asks for them:
bf16 parameter storage with an f32 master, remat, gradient accumulation,
parameter EMA, pipeline stages, the device corpus and fused multi-step
dispatch, grad/param-norm watching (``watch_interval > 0`` with a run
logger), a data axis above one rank and context parallelism (``cp_axis``).
SIGTERM preemption and the per-epoch reconstruction image are not ported
and have no config switch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from s2tpu_torch import resolve_device
from s2tpu_torch.configs.data_config import BANDS, parse_bands
from s2tpu_torch.configs.mae import MAEConfig
from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES
from s2tpu_torch.data.augment import normalize
from s2tpu_torch.data.pipeline import Datamodule, prefetch_to_device
from s2tpu_torch.models.prithvi_mae import PrithviConfig, PrithviMAE, patchify, unpatchify
from s2tpu_torch.parallel.mesh import DATA_AXIS, mesh_device, replicate_module
from s2tpu_torch.train.losses import mae_reconstruction_loss
from s2tpu_torch.train.train_state import make_optimizer
from s2tpu_torch.utils import get_logger, get_unique_run_name, load_prithvi_mean_std, load_prithvi_model_args

logger = get_logger(__name__)


def _refuse_unported(config: MAEConfig, run_logger, mesh=None, model_config: PrithviConfig | None = None) -> None:
    t, m = config.train, config.model
    unported = {
        "a data axis above 1 (DDP/FSDP2, ROADMAP A16)": (
            mesh is not None and mesh.shape[mesh.mesh_dim_names.index(DATA_AXIS)] > 1
        ),
        "cp_axis (context parallelism)": model_config is not None and model_config.cp_axis is not None,
        "param_dtype='bfloat16' (f32 master)": t.param_dtype != "float32",
        "remat": t.remat,
        "grad_accum_steps > 1": t.grad_accum_steps > 1,
        "ema_decay": t.ema_decay is not None,
        "pipeline_stages > 1": m.pipeline_stages > 1,
        "device_corpus": t.device_corpus or t.device_corpus_sharded,
        "steps_per_dispatch > 1": t.steps_per_dispatch > 1,
        "watch_interval > 0 (grad/param norms)": run_logger is not None and t.watch_interval > 0,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"not ported to s2tpu_torch yet: {', '.join(asked)}")


def default_model_config(config: MAEConfig) -> PrithviConfig:
    """Prithvi-100M at the run's frame count and crop size (the sincos tables
    follow the token grid), with the run's attention route, pixel-norm loss
    and band count."""
    mc = PrithviConfig.from_model_args(
        load_prithvi_model_args(), num_frames=config.model.num_frames, img_size=config.datamodule.random_crop_size
    )
    return dataclasses.replace(
        mc,
        attention_impl=config.model.attention_impl,
        norm_pix_loss=config.model.norm_pix_loss,
        in_chans=config.datamodule.dataset_cfg.in_channels,
    )


class MAETrainer:
    """Trains a Prithvi MAE on ``datamodule``'s unlabeled crops on one device
    (``resolve_device``: the card unless ``device="cpu"``), or on this
    rank's device of ``mesh`` (``mesh_device``: the card ``make_mesh``
    bound the process to)."""

    def __init__(
        self,
        config: MAEConfig,
        datamodule: Datamodule,
        mesh=None,
        model_config: PrithviConfig | None = None,
        run_logger=None,
        checkpoint_manager=None,
        device: torch.device | str | None = None,
    ) -> None:
        _refuse_unported(config, run_logger, mesh, model_config)
        self.config = config
        self.dm = datamodule
        self.mesh = mesh
        self.is_main = mesh is None or dist.get_rank() == 0
        self.device = resolve_device(device) if device is not None or mesh is None else mesh_device(mesh)
        self.run_logger = run_logger if self.is_main else None
        self.ckpt = checkpoint_manager
        t = config.train
        self.mask_ratio = config.model.mask_ratio
        self.compute_dtype = COMPUTE_DTYPES[t.compute_dtype]
        self.model_config = model_config if model_config is not None else default_model_config(config)
        tp_axis = self.model_config.tp_axis
        self.model = PrithviMAE(
            self.model_config, dtype=self.compute_dtype, device=self.device,
            generator=torch.Generator().manual_seed(t.seed),
            tp_group=mesh.get_group(tp_axis) if mesh is not None and tp_axis is not None else None,
        )
        if not t.from_scratch:
            self._load_pretrained()
        if mesh is not None:
            replicate_module(self.model, mesh)
        if parse_bands(config.datamodule.dataset_cfg.bands) == list(BANDS):
            mean, std = load_prithvi_mean_std()  # the published Prithvi normalization
        else:
            # Any other band set: the dataset's own statistics (band identity,
            # not count, is what the published statistics belong to).
            mean, std = datamodule.mean_std()
            if len(mean) != self.model_config.in_chans:
                raise ValueError(
                    f"dataset statistics carry {len(mean)} channels but the model expects "
                    f"{self.model_config.in_chans}; the rasters were acquired with another band set"
                )
        self.mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
        self.std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)
        self.optimizer = make_optimizer(self.model.parameters(), t.lr, t.weight_decay, t.betas)
        self.step = 0  # optimizer updates applied so far
        self.noise_generator = torch.Generator(device=self.device)

    def _load_pretrained(self) -> None:
        """Published Prithvi_100M.pt weights when available (finetune path)."""
        if self.model_config.in_chans != 6:
            logger.warning(
                f"in_chans={self.model_config.in_chans}: the published Prithvi_100M.pt is a 6-band model; "
                "training from random init (use --from-scratch to silence this)"
            )
            return
        from s2tpu_torch.checkpoint.convert import load_prithvi_weights

        try:
            load_prithvi_weights(self.model)
        except FileNotFoundError as e:
            logger.warning(f"Pretrained Prithvi weights unavailable ({e}); using random init")

    # ------------------------------------------------------------------
    def _input(self, images: torch.Tensor) -> torch.Tensor:
        """int16 (B, [T,] H, W, C) crops -> normalized (B, T, H, W, C) in the compute dtype."""
        x = normalize(images, self.mean, self.std, dtype=self.compute_dtype)
        return x[:, None] if x.dim() == 4 else x

    def _noise(self, batch: int, seed: int) -> torch.Tensor:
        """(B, L) uniform masking noise from the device generator at ``seed``."""
        self.noise_generator.manual_seed(seed)
        return torch.rand((batch, self.model_config.num_patches), generator=self.noise_generator, device=self.device)

    def train_step(self, images: torch.Tensor, noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """One optimizer update on a device batch; returns the device-side
        loss (no host sync). ``noise`` (B, L) replaces the step's own draw."""
        self.model.train()
        x = self._input(images)
        if noise is None:
            noise = self._noise(x.shape[0], (self.config.train.seed << 32) + self.step)
        loss, _, _ = self.model(x, mask_ratio=self.mask_ratio, noise=noise)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach()}

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, batch_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        """Loss of a padded eval batch, padded rows excluded from both sums."""
        self.model.eval()
        x = self._input(images)
        _, pred, mask = self.model(x, mask_ratio=self.mask_ratio, noise=self._noise(x.shape[0], self.config.train.seed))
        mc = self.model_config
        target = patchify(x, mc.patch_size, mc.tubelet_size)
        loss = mae_reconstruction_loss(pred, target, mask, norm_pix=mc.norm_pix_loss, sample_weights=batch_mask)
        return {"loss": loss, "weight": batch_mask.float().mean(), "pred": pred, "mask": mask}

    @torch.no_grad()
    def reconstruct(self, images) -> np.ndarray:
        """Masked reconstruction of int16 crops back in pixel space,
        (B, T, H, W, C) float32 denormalized."""
        self.model.eval()
        x = self._input(torch.as_tensor(np.asarray(images)).to(self.device))
        _, pred, _ = self.model(x, mask_ratio=self.mask_ratio, noise=self._noise(x.shape[0], 1))
        mc = self.model_config
        rec = unpatchify(pred, mc.grid_size, mc.patch_size, mc.tubelet_size, mc.in_chans).float()
        return (rec * self.std + self.mean).cpu().numpy()

    # ------------------------------------------------------------------
    def run_train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        acc, n, images_seen = None, 0, 0
        t0 = time.time()
        batches = prefetch_to_device(
            self.dm.train_batches(epoch, overfit_batches=cfg.train.overfit_batches),
            self.device, depth=cfg.datamodule.prefetch,
        )
        for i, batch in enumerate(batches):
            m = self.train_step(batch.images)
            acc = m["loss"] if acc is None else acc + m["loss"]
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
        return {"loss": float(acc) / n, "images_per_sec": images_seen / max(time.time() - t0, 1e-9)}

    def run_eval_epoch(self, split: str = "val") -> dict:
        total, weight = 0.0, 0.0
        for batch in prefetch_to_device(self.dm.eval_batches(split), self.device, depth=2):
            m = self.eval_step(batch.images, batch.mask)
            w = float(m["weight"])
            total += float(m["loss"]) * w
            weight += w
        return {"loss": total / max(weight, 1e-9)} if weight else {}

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
        self.model.load_state_dict(restored["model"], strict=True)
        self.optimizer.load_state_dict(restored["optimizer"])
        self.step = restored["step"]
        if self.is_main:
            logger.info(f"Resumed MAE training from epoch {latest} (step {self.step})")
        return latest + 1

    def fit(self, epochs: int | None = None, start_epoch: int = 0) -> list[dict]:
        cfg = self.config
        max_epochs = epochs if epochs is not None else cfg.train.max_epochs
        if max_epochs <= 0:
            raise ValueError("fit() needs an explicit positive epoch count")
        if cfg.train.run_name is None:
            cfg.train.run_name = get_unique_run_name(postfix=cfg.train.project_name)
        history: list[dict] = []
        for epoch in range(start_epoch, max_epochs):
            tr = self.run_train_epoch(epoch)
            va = self.run_eval_epoch("val") if len(self.dm.val_idx) else {}
            record = {
                "epoch": epoch,
                "train/lr": float(cfg.train.lr),
                **{f"train/{k}": v for k, v in tr.items()},
                **{f"val/{k}": v for k, v in va.items()},
            }
            history.append(record)
            if not self.is_main:
                continue
            logger.info(
                f"mae epoch {epoch}: train loss {tr.get('loss', float('nan')):.4f} | "
                f"val loss {va.get('loss', float('nan')):.4f} | {tr.get('images_per_sec', 0):.1f} img/s"
            )
            if self.run_logger is not None:
                self.run_logger.log_scalars({k: v for k, v in record.items() if k != "epoch"}, step=self.step)
            if self.ckpt is not None and (epoch + 1) % cfg.train.ckpt_every_n_epochs == 0:
                self.ckpt.save_epoch(epoch, self.model, self.optimizer, self.step, metrics=record)
        return history
