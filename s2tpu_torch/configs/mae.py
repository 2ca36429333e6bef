"""Prithvi MAE pretrain/finetune config (the port of ``s2tpu/configs/mae.py``).

The same dataclasses, field for field, and the same presets, so a
``config.json`` written by either package parses here. The MAE linear
learning-rate rule is ``lr = base · batch_size / 256`` with
``datamodule.batch_size`` the global batch of one optimizer step: there is
no device-count multiply (``s2tpu/configs/mae.py:1-10``). The comments on
fields describe the JAX trainer; the port's trainer refuses the fields of
features it does not have (``s2tpu_torch/train/mae_trainer.py``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from s2tpu_torch.configs.data_config import BandsMixin


class MAELRSchedulerType(str, enum.Enum):
    STEP = "step"
    COSINE_WARM_RESTARTS = "cosine_warm_restarts"


@dataclass
class MAEDatasetConfig(BandsMixin):
    aoi: str
    n_time_frames: int = 1
    data_dir: str | None = None
    # Spectral band set: a BAND_SETS name, comma list or explicit list. Any
    # set other than the Prithvi-HLS six normalizes with dataset statistics.
    bands: "list[str] | str" = "default"


@dataclass
class MAEDatamoduleConfig:
    dataset_cfg: MAEDatasetConfig
    batch_size: int = 32
    augment: bool = True
    data_split: tuple[float, float, float] = (0.8, 0.2, 0.0)
    val_batch_size_multiplier: int = 2
    random_crop_size: int = 224
    prefetch: int = 2
    shuffle_seed: int = 0


@dataclass
class MAEModelConfig:
    num_frames: int = 1
    mask_ratio: float = 0.75
    norm_pix_loss: bool = False
    # "fused": the fused attention kernels for 128 <= L within the budget,
    # the streaming kernel for long sequences; "xla": plain attention only.
    attention_impl: str = "fused"
    pipeline_stages: int = 1
    pipeline_microbatches: int = 2


@dataclass
class MAETrainConfig:
    from_scratch: bool = False
    lr: float = 5e-4
    weight_decay: float = 0.05
    betas: tuple[float, float] = (0.9, 0.999)

    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    remat: bool = False
    donate_state: bool = True
    ema_decay: float | None = None
    grad_accum_steps: int = 1
    watch_interval: int = 30

    max_epochs: int = -1
    log_interval: int = 50
    num_devices: int = -1
    overfit_batches: int = 0
    device_corpus: bool = False
    device_corpus_sharded: bool = False
    steps_per_dispatch: int = 1

    use_wandb_logger: bool = True
    project_name: str = "prithvi-mae-finetune"
    wandb_entity: str | None = None
    run_name: str | None = None
    tags: list[str] = field(default_factory=list)
    log_img_in_train: bool = False

    seed: int = 42

    lr_scheduler_type: MAELRSchedulerType | None = None
    step_lr_sched_step_size: int | None = None
    step_lr_sched_gamma: float | None = None
    cosine_warm_restarts_T_0: int | None = None
    cosine_warm_restarts_eta_min: float | None = None

    ckpt_every_n_epochs: int = 1
    ckpt_keep: int = 1


@dataclass
class MAEConfig:
    model: MAEModelConfig
    datamodule: MAEDatamoduleConfig
    train: MAETrainConfig


def base_config(aoi: str = "at") -> MAEConfig:
    return MAEConfig(
        model=MAEModelConfig(num_frames=1),
        datamodule=MAEDatamoduleConfig(dataset_cfg=MAEDatasetConfig(aoi=aoi)),
        train=MAETrainConfig(),
    )


def _effective_bs(config: MAEConfig) -> int:
    # Global samples per optimizer step: batch_size is already global.
    return config.datamodule.batch_size


def pretrain(config: MAEConfig) -> MAEConfig:
    config.train.from_scratch = True
    config.datamodule.batch_size = 64
    config.train.lr = 1.5e-4 * _effective_bs(config) / 256  # MAE pretrain base-lr rule
    return config


def finetune(config: MAEConfig) -> MAEConfig:
    config.train.from_scratch = False
    config.datamodule.batch_size = 64
    config.train.lr = 5e-4 * _effective_bs(config) / 256  # MAE finetune base-lr rule
    return config


def debug(config: MAEConfig) -> MAEConfig:
    config.train.num_devices = 1
    config.datamodule.batch_size = 1
    config.train.log_img_in_train = True
    config.train.tags.append("debug")
    return config


def overfit(config: MAEConfig) -> MAEConfig:
    config.train.overfit_batches = 1
    config.datamodule.augment = False
    config.train.log_img_in_train = True
    config.train.tags.append("overfit")
    return config


PRESETS = {"pretrain": pretrain, "finetune": finetune, "debug": debug, "overfit": overfit}


def config_from_dict(d: dict) -> MAEConfig:
    """Rebuild an MAEConfig from a run directory's ``config.json`` (the
    inverse of ``dataclasses.asdict``; JSON turns tuples into lists)."""
    ds = MAEDatasetConfig(**d["datamodule"]["dataset_cfg"])
    dm_kwargs = {k: v for k, v in d["datamodule"].items() if k != "dataset_cfg"}
    dm_kwargs["data_split"] = tuple(dm_kwargs["data_split"])
    train_kwargs = dict(d["train"])
    train_kwargs["betas"] = tuple(train_kwargs["betas"])
    return MAEConfig(
        model=MAEModelConfig(**d["model"]),
        datamodule=MAEDatamoduleConfig(dataset_cfg=ds, **dm_kwargs),
        train=MAETrainConfig(**train_kwargs),
    )
