"""Prithvi MAE pretraining / finetuning trainer (the port of ``s2tpu/train/mae_trainer.py``).

One train step normalizes the int16 crops on the device, draws the (B, L)
masking noise from a device ``torch.Generator`` seeded from (seed, step,
micro-batch) as the JAX step folds the step into its key, runs the Prithvi
MAE in the compute dtype (attention through the fused kernels #8/#9 or the
streaming kernel #5 where the JAX route sends it), and applies Adam with
coupled L2 at the constant configured learning rate (the MAE linear scaling
rule is applied by the config presets). The step's extras are the
segmentation trainer's (``train.trainer``): ``grad_accum_steps``
micro-batches with f32 gradient sums, ``remat`` of each ViT block,
``param_dtype='bfloat16'`` with an f32 master, ``ema_decay`` (validation
and the reconstruction on the average), and grad/param-norm watching every
``watch_interval`` steps with a run logger (``mae_trainer.py:200-300``).
``fit`` saves a preemption checkpoint at the step boundary after a SIGTERM,
and ``resume_from_checkpoint`` continues that epoch exactly
(``:381-528``, ``:545-633``). Evaluation recomputes
the loss with padded rows left out of numerator and denominator, with the
same masking noise for every batch (the JAX eval step reuses its base key).

Flips: the JAX MAE path flips twice, on the host in the Datamodule
(``host_flips``) and again on the device in ``augment_batch``. The XOR of two
independent fair coins is a fair coin, so on the streamed path the port's
single host flip per axis gives crops of the same distribution, and the
step does not flip. The device corpus (``train.device_corpus``,
``:112-124``, ``:381-488``) has no host gather: its crops are gathered on the
card and the step flips them there (``data.augment.random_flips``, drawn
from the micro-batch's generator before its masking noise) when
``datamodule.augment`` is on, as the JAX step does. ``steps_per_dispatch``
steps at a time then run as replays of one CUDA graph of the whole step
(``train.base``).

``from_scratch=False`` loads ``weights/Prithvi_100M.pt`` (published layout)
when present and otherwise warns and keeps the random init, as the JAX
trainer does.

With a ``mesh`` (``s2tpu_torch.parallel.mesh.make_mesh``, or the mesh
``train.num_devices`` N > 1 asks for in a process group of N ranks) one
trainer runs in each process of the mesh's group, on the rank's device,
the parameters starting as rank 0's; only rank 0 logs and writes
checkpoints. A model config with ``tp_axis`` splits the heads and MLP hidden
over the mesh's 'model' group (``PrithviConfig(tp_axis=MODEL_AXIS)``, as
the JAX trainer takes it), and one with ``cp_axis`` the tokens between the
blocks (context parallelism, with ``tp_axis`` or without): after the last
micro-batch's backward the gradients that cover only this rank's tokens
(``PrithviMAE.token_shard_parameters``) are summed over the model group in
one bucketed all-reduce, before the data axis's sum. Over the 'data' axis
(``s2tpu``'s ``make_mesh(n)`` and ``make_mesh(n, model_parallel=m)``) each rank trains
its rows of every global batch (``Datamodule.set_process``; the ranks of one
'model' group share theirs), and the step computes what the one-process step
computes on the global batch: the flips and the (B, L) masking noise are
drawn for the global micro-batch on every rank and sliced
(``DataAxis.local``), the masked-patch denominator is the global batch's
(``DataAxis.total``), and after the last micro-batch the f32 gradient sums
and the loss are summed over the data group in a few flat buckets. Eval sums
its loss numerators and its padded-row denominators over the data axis. The
per-epoch reconstruction image is skipped on a mesh of several ranks.

The sharded corpus (``train.device_corpus_sharded`` on a data axis of N > 1
ranks, ``:114-123``, ``:322-325``, ``:400-410``): each rank uploads only its
block of the images (the ranks of one 'model' group the same block), every
rank draws the same per-block epoch orders and trains the rows its block
owns, gathered by local ids with no collective. On one rank it is the plain
corpus, as in the JAX trainer.

Pipeline parallelism (``model.pipeline_stages`` S > 1, ``:214-238``): the
mesh's model axis of S ranks holds the stages (``train.num_devices`` N
builds ``make_mesh(N, model_parallel=S)``, as the JAX trainer does), and the
model runs its encoder blocks, and its decoder blocks where S divides their
depth, as a GPipe schedule of ``model.pipeline_microbatches`` micro-batches
(``parallel.pipeline``); each accumulation micro-batch's rows must split
into them. Each rank holds the gradients of its own stage's blocks only:
after the last micro-batch's backward they are summed over the model group
in one flat bucket, before the data axis's sum. Pipeline stages with
``tp_axis`` or ``cp_axis`` are refused: all three use the 'model' axis.
"""

from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch
import torch.distributed as dist

from s2tpu_torch import resolve_device
from s2tpu_torch.configs.data_config import BANDS, parse_bands
from s2tpu_torch.configs.mae import MAEConfig
from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES
from s2tpu_torch.data.augment import normalize, random_flips
from s2tpu_torch.data.device_corpus import DeviceCorpus
from s2tpu_torch.data.pipeline import Datamodule, prefetch_to_device
from s2tpu_torch.models.prithvi_mae import PrithviConfig, PrithviMAE, patchify, unpatchify
from s2tpu_torch.parallel.mesh import data_axis, mesh_device, mesh_for_num_devices, model_axis, replicate_module
from s2tpu_torch.parallel.pipeline import Pipeline, pipeline_parameters
from s2tpu_torch.train.losses import mae_reconstruction_loss
from s2tpu_torch.train.train_state import accumulate_grads, make_optimizer
from s2tpu_torch.train.base import TrainerBase
from s2tpu_torch.utils import get_logger, load_prithvi_mean_std, load_prithvi_model_args

logger = get_logger(__name__)


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


class MAETrainer(TrainerBase):
    """Trains a Prithvi MAE on ``datamodule``'s unlabeled crops on one device
    (``resolve_device``: the card unless ``device="cpu"``), or on this
    rank's device of ``mesh`` (or of the mesh ``train.num_devices`` asks
    for; ``mesh_device``: the card ``make_mesh`` bound the process to)."""

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
        t = config.train
        stages = max(config.model.pipeline_stages, 1)
        self.mesh = mesh if mesh is not None else mesh_for_num_devices(
            t.num_devices, resolve_device(device).type, "s2tpu_torch.cli.train_mae", model_parallel=stages)
        self.data_axis = data_axis(self.mesh)
        self.model_axis = model_axis(self.mesh)
        n_data = self.data_axis.size
        if stages > 1 and self.model_axis.size != stages:
            raise ValueError(f"pipeline_stages={stages} needs a mesh whose model axis holds {stages} ranks, "
                             f"and this one holds {self.model_axis.size}")
        # the JAX trainer's make_mesh(num_devices, model_parallel=stages): the stages count in num_devices
        if t.num_devices not in (-1, n_data * stages):
            raise ValueError(f"train.num_devices={t.num_devices}, but the mesh's data axis holds {n_data} ranks"
                             + (f" x {stages} pipeline stages" if stages > 1 else ""))
        accum = max(t.grad_accum_steps, 1)
        micro = config.model.pipeline_microbatches if stages > 1 else 1
        if config.datamodule.batch_size % (n_data * accum * micro):
            raise ValueError(
                f"batch_size {config.datamodule.batch_size} must split over the data axis's {n_data} ranks "
                f"x {accum} micro-batches" + (f" x {micro} pipeline microbatches" if stages > 1 else "")
            )
        self.config = config
        self.dm = datamodule
        self.is_main = self.mesh is None or dist.get_rank() == 0
        self.device = resolve_device(device) if self.mesh is None else mesh_device(self.mesh)
        self.run_logger = run_logger if self.is_main else None
        self.ckpt = checkpoint_manager
        if n_data > 1:
            datamodule.set_process(n_data, self.data_axis.index, max(t.grad_accum_steps, 1))
        self.mask_ratio = config.model.mask_ratio
        self.compute_dtype = COMPUTE_DTYPES[t.compute_dtype]
        self.model_config = model_config if model_config is not None else default_model_config(config)
        mc = self.model_config
        split = mc.tp_axis or mc.cp_axis  # the model axis, where the heads or the tokens are split over it
        self.model = PrithviMAE(
            mc, dtype=self.compute_dtype, device=self.device, generator=torch.Generator().manual_seed(t.seed),
            tp_group=self.mesh.get_group(split) if self.mesh is not None and split is not None else None,
            pipeline=Pipeline(self.model_axis, config.model.pipeline_microbatches) if stages > 1 else None,
        )
        self._token_shard = {id(p) for p in self.model.token_shard_parameters()}
        self._stage_only = {id(p) for p in pipeline_parameters(self.model)}
        self.model.data_axis = self.data_axis
        if not t.from_scratch:
            self._load_pretrained()
        if self.mesh is not None:
            replicate_module(self.model, self.mesh)
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
        self._init_params(t)
        self.optimizer = make_optimizer(self.model.parameters(), t.lr, t.weight_decay, t.betas, self.master)
        self.noise_generator = torch.Generator(device=self.device)  # eval and reconstruction noise
        # An unlabeled corpus: the labels are not uploaded.
        self.corpus = None
        if t.device_corpus:
            self.corpus = DeviceCorpus(datamodule.source, self.device, with_labels=False,
                                       data=self.data_axis if t.device_corpus_sharded else None)

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
        """This rank's rows of the global batch's (B, L) uniform masking
        noise, from the device generator at ``seed``."""
        self.noise_generator.manual_seed(seed)
        return self.data_axis.local(torch.rand((batch * self.data_axis.size, self.model_config.num_patches),
                                               generator=self.noise_generator, device=self.device))

    def train_step(self, images: torch.Tensor, noise: torch.Tensor | None = None) -> dict[str, typing.Any]:
        """One optimizer update on a device batch (this rank's rows), in
        ``grad_accum_steps`` micro-batches; returns the device-side loss of
        the global batch (no host sync), and the watch norms on a watched
        step. ``noise`` (B, L) over the global batch replaces the step's own
        draws (micro-batch i takes its i-th slice of rows, and of that, this
        rank's)."""
        self._begin_step()
        out = self._step(images, noise=noise)
        self.step += 1
        return out

    def _step(self, images: torch.Tensor, noise: torch.Tensor | None = None,
              flips: bool = False) -> dict[str, typing.Any]:
        """The device work of one step, after ``_begin_step``: flips (when
        ``flips``), normalization, masking noise, forward, backward and the
        update, with no host sync (a CUDA graph captures it)."""
        t = self.config.train
        accum = max(t.grad_accum_steps, 1)
        if images.shape[0] % accum:
            raise ValueError(f"batch {images.shape[0]} does not split into {accum} micro-batches")
        self.model.train()
        self._zero_grads()
        named = self._trainable()
        grads, loss = None, 0.0
        axis = self.data_axis
        noises = noise.chunk(accum) if noise is not None else [None] * accum
        for micro, n, g in zip(images.chunk(accum), noises, self.generators):
            if flips:
                micro, _ = random_flips(micro, None, g, data_axis=axis)
            x = self._input(micro)
            if n is None:  # the global micro-batch's draws, after its flips'
                n = torch.rand((x.shape[0] * axis.size, self.model_config.num_patches), generator=g,
                               device=self.device)
            loss_i, _, _ = self.model(x, mask_ratio=self.mask_ratio, noise=axis.local(n))
            loss_i.backward()
            grads = accumulate_grads([p for _, p in named], grads)
            loss = loss + loss_i.detach()
        if self._token_shard:  # context parallelism: each rank's share of these gradients, summed
            self.model_axis.all_reduce_flat_([g for (_, p), g in zip(named, grads) if id(p) in self._token_shard])
        if self._stage_only:  # pipeline: each stage's blocks' gradients (zero on the other stages), summed
            self.model_axis.all_reduce_flat_([g for (_, p), g in zip(named, grads) if id(p) in self._stage_only])
        if axis.size > 1:
            # Each rank's loss is its share of the global loss: the sums over
            # the ranks are the global batch's gradient and loss.
            loss = loss.reshape(1)
            axis.all_reduce_flat_([*grads, loss])
            loss = loss[0]
        return {"loss": loss / accum, **self._update(named, grads, accum, self._watch_this_step())}

    def _corpus_step(self, row: torch.Tensor) -> dict[str, typing.Any]:
        images, _ = self.corpus.gather(row[0], row[1], row[2], self.config.datamodule.random_crop_size)
        m = self._step(images, flips=self.config.datamodule.augment)
        self._add_to_sums(m)
        return m

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, batch_mask: torch.Tensor) -> dict[str, torch.Tensor]:
        """Loss of a padded eval batch, padded rows excluded from both sums,
        on the weights in the model (``eval_weights`` puts the EMA there);
        on a data axis, of the global batch (the ranks' numerators and
        padded-row counts summed)."""
        self.model.eval()
        x = self._input(images)
        _, pred, mask = self.model(x, mask_ratio=self.mask_ratio, noise=self._noise(x.shape[0], self.config.train.seed))
        mc = self.model_config
        target = patchify(x, mc.patch_size, mc.tubelet_size)
        loss = mae_reconstruction_loss(pred, target, mask, norm_pix=mc.norm_pix_loss, sample_weights=batch_mask,
                                       data_axis=self.data_axis)
        weight = batch_mask.float().sum() / (batch_mask.shape[0] * self.data_axis.size)
        if self.data_axis.size > 1:  # each rank's share of the global loss and weight
            sums = torch.stack([loss, weight])
            self.data_axis.all_reduce_flat_([sums])
            loss, weight = sums[0], sums[1]
        return {"loss": loss, "weight": weight, "pred": pred, "mask": mask}

    @torch.no_grad()
    def reconstruct(self, images) -> np.ndarray:
        """Masked reconstruction of int16 crops back in pixel space by the
        eval weights, (B, T, H, W, C) float32 denormalized."""
        self.model.eval()
        x = self._input(torch.as_tensor(np.asarray(images)).to(self.device))
        with self.eval_weights():
            _, pred, _ = self.model(x, mask_ratio=self.mask_ratio, noise=self._noise(x.shape[0], 1))
        mc = self.model_config
        rec = unpatchify(pred, mc.grid_size, mc.patch_size, mc.tubelet_size, mc.in_chans).float()
        return (rec * self.std + self.mean).cpu().numpy()

    # ------------------------------------------------------------------
    def run_train_epoch(self, epoch: int) -> dict:
        cfg = self.config
        if self.corpus is not None:
            n, sums, seconds = self._run_corpus_epoch(epoch, None)  # the JAX MAE corpus samples unweighted
            if n == 0:  # a resumed epoch whose batches were all trained
                return {"loss": float("nan"), "images_per_sec": 0.0}
            return {"loss": float(sums["loss"]) / n,
                    "images_per_sec": n * cfg.datamodule.batch_size / max(seconds, 1e-9)}
        t0 = time.time()
        skip, self._skip_batches = self._skip_batches, 0
        batches = prefetch_to_device(
            self.dm.train_batches(epoch, overfit_batches=cfg.train.overfit_batches, start=skip),
            self.device, depth=cfg.datamodule.prefetch,
        )
        outs, n, images_seen = self._train_loop(epoch, batches, lambda b: self.train_step(b.images), skip)
        if n == 0:  # a resumed epoch whose batches were all trained
            return {"loss": float("nan"), "images_per_sec": 0.0}
        loss = float(sum((m["loss"] for m in outs[1:]), outs[0]["loss"])) / n  # in step order
        return {"loss": loss, "images_per_sec": images_seen * self.data_axis.size / max(time.time() - t0, 1e-9)}

    def run_eval_epoch(self, split: str = "val") -> dict:
        total, weight = 0.0, 0.0
        with self.eval_weights():
            for batch in prefetch_to_device(self.dm.eval_batches(split), self.device, depth=2):
                m = self.eval_step(batch.images, batch.mask)
                w = float(m["weight"])
                total += float(m["loss"]) * w
                weight += w
        return {"loss": total / max(weight, 1e-9)} if weight else {}

    def _end_epoch(self, epoch: int, tr: dict) -> dict:
        """The val pass, the epoch's record and its logs (on the main rank)."""
        cfg = self.config
        va = self.run_eval_epoch("val") if len(self.dm.val_idx) else {}
        record = {
            "epoch": epoch,
            "train/lr": float(cfg.train.lr),
            **{f"train/{k}": v for k, v in tr.items()},
            **{f"val/{k}": v for k, v in va.items()},
        }
        if self.is_main:
            logger.info(
                f"mae epoch {epoch}: train loss {tr.get('loss', float('nan')):.4f} | "
                f"val loss {va.get('loss', float('nan')):.4f} | {tr.get('images_per_sec', 0):.1f} img/s"
            )
        if self.run_logger is not None:
            self.run_logger.log_scalars({k: v for k, v in record.items() if k != "epoch"}, step=self.step)
            self._log_reconstruction_image()
        return record

    def _log_reconstruction_image(self) -> None:
        """The first eval crop's RGB against its reconstruction
        (``s2tpu/train/mae_trainer.py:635-667``). Never stops training: a
        failure is a warning."""
        plt = self._image_pyplot()
        if plt is None:
            return
        if self.mesh is not None and dist.get_world_size() > 1:
            logger.info("reconstruction image skipped: the mesh holds several ranks")
            return
        from s2tpu_torch.plotting import reconstruction_figure

        was_training = self.model.training
        try:
            split = "val" if len(self.dm.val_idx) else "train"
            batch = next(iter(self.dm.eval_batches(split)))
            rec = self.reconstruct(batch.images[:1])[0, 0]  # (H, W, C) denormalized
            orig = np.asarray(batch.images[0], np.float64)
            if orig.ndim == 4:  # multi-temporal (T, H, W, C): frame 0
                orig = orig[0]
            self.run_logger.log_image("val/reconstruction", reconstruction_figure(orig, rec, self.mask_ratio),
                                      self.step)
            plt.close("all")
        except Exception as e:  # noqa: BLE001 - never kill training over a plot
            logger.warning(f"reconstruction logging failed: {e}", exc_info=True)
        finally:
            self.model.train(was_training)
