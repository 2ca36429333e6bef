"""Segmentation experiment config tree (the port's copy of s2tpu's).

The dataclasses are field-for-field the JAX package's, so a ``config.json``
written by either package's checkpoint parses unchanged here. The model
factory builds the PyTorch modules of this package.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from dataclasses import dataclass, field

import torch

from s2tpu_torch.configs.data_config import BANDS, LABEL_MAPS, BandsMixin


class ModelName(str, enum.Enum):
    FC_PRITHVI_BACKBONE = "fc-prithvi-backbone"
    EFFICIENTNET_UNET_B0 = "efficientnet-unet-b0"
    EFFICIENTNET_UNET_B1 = "efficientnet-unet-b1"
    EFFICIENTNET_UNET_B2 = "efficientnet-unet-b2"
    EFFICIENTNET_UNET_B3 = "efficientnet-unet-b3"
    EFFICIENTNET_UNET_B4 = "efficientnet-unet-b4"
    EFFICIENTNET_UNET_B5 = "efficientnet-unet-b5"
    EFFICIENTNET_UNET_B6 = "efficientnet-unet-b6"
    EFFICIENTNET_UNET_B7 = "efficientnet-unet-b7"


class LossType(str, enum.Enum):
    CE = "ce"
    FOCAL = "focal"
    DICE = "dice"
    DICE_FOCAL = "dice_focal"


class LRSchedulerType(str, enum.Enum):
    STEP = "step"
    COSINE = "cosine"


@dataclass
class DatasetConfig(BandsMixin):
    aoi: str
    label_map: str
    n_time_frames: int = 1
    squeeze_time_dim: bool = False  # (C,H,W) vs (C,1,H,W) per-sample shape
    data_dir: str | None = None  # override DATA_DIR (tests / packed corpora)
    # Spectral band set: which Sentinel-2 bands the segment rasters carry, in
    # raster band order. Drives the model's in_channels, the acquisition
    # evalscript, and statistics lengths. Default = the 6 Prithvi-HLS bands
    # (reference data_config.py:72); "all12" trains on every L2A band
    # (BASELINE config #3). Accepts a BAND_SETS name or an explicit list.
    bands: list[str] = field(default_factory=lambda: list(BANDS))
    # Multi-temporal input for single-frame models (BASELINE config #3's
    # B5 on quarterly composites): fold the T axis into channels just before
    # the model — (B, T, H, W, C) -> (B, H, W, T*C), frame-major channel
    # order. The ViT consumes T natively (tubelet); this is the UNet path.
    stack_time_into_channels: bool = False
    # __post_init__ (band parsing) + in_channels come from BandsMixin.


@dataclass
class DatamoduleConfig:
    dataset_cfg: DatasetConfig
    batch_size: int
    data_split: tuple[float, float, float]
    val_batch_size_multiplier: int = 2
    augment: bool = True
    random_horizontal_flip_p: float = 0.5
    random_vertical_flip_p: float = 0.5
    random_crop_size: int = 224
    # Apply the random H/V flips on the host during the crop gather (numpy
    # views, overlapped with device compute) instead of as selects inside
    # the train step on the device (data/augment.random_flips). Ignored
    # (flips stay on the device) when train.device_corpus is set.
    host_flips: bool = True
    class_distribution: list[float] | None = None  # enables weighted sampling
    prefetch: int = 2  # host->device prefetch depth
    shuffle_seed: int = 0


@dataclass
class TrainConfig:
    # Field-for-field the JAX trainer's config; the comments describe that
    # trainer. Serving reads ``compute_dtype`` and ``class_distribution``.

    # optimizer
    lr: float = 1.5e-6
    weight_decay: float = 0.05
    betas: tuple[float, float] = (0.9, 0.999)

    # loss
    loss_type: LossType = LossType.CE
    masked_loss: bool = True  # ignore class 0 (unlabeled) in loss + metrics
    weighted_loss: bool = False
    label_smoothing: float = 0.0
    focal_loss_gamma: float | None = 2.0
    dice_eps: float | None = 1e-8
    dice_focal_dice_weight: float | None = 0.5
    dice_focal_focal_weight: float | None = 0.5

    # compilation / numerics (TPU analogue of torch.compile + precision flags)
    compute_dtype: str = "bfloat16"  # activations/matmul dtype
    # Parameter STORAGE dtype. "bfloat16" keeps model params in bf16 (half the
    # per-pass weight HBM reads, no per-step f32->bf16 casts) with an f32
    # master copy inside the optimizer state (train_state.with_f32_master),
    # so small Adam deltas are never rounded away. "float32" = plain storage.
    param_dtype: str = "float32"
    remat: bool = False  # jax.checkpoint the encoder to trade FLOPs for HBM
    # UNet-only: run the early encoder blocks on the c-major space-to-depth
    # layout (see EfficientNetUNetConfig.packed_early_blocks for variants:
    # False / "grouped" / "dense"). Layout-only — same params/checkpoints.
    packed_early_blocks: bool | str = False
    donate_state: bool = True  # donate train-state buffers to the jit'd step
    # Upload the corpus to the card once and crop there: per step the host
    # sends only index/offset vectors (data/device_corpus.py).
    device_corpus: bool = False
    # Shard the corpus segment axis over the data axis: each rank uploads
    # only its block of the segments (a data axis of one: the plain corpus).
    device_corpus_sharded: bool = False
    # In device-corpus mode, train N steps a window: on the card each step
    # replays one CUDA graph of the whole step (train/graphs.py), so the
    # host launches one graph where an eager step launches thousands.
    # Bit-identical to N single steps. One step a window while the norms
    # are watched (read every step); ignored in host-streamed mode.
    steps_per_dispatch: int = 1
    # When > 0, replace BN running statistics with exact statistics pooled
    # over this many train batches before each validation pass
    # (trainer.recalibrate_bn). Essential for short runs: the encoder's
    # 0.99 BN EMA (reference parity) needs hundreds of steps to converge.
    bn_recalibration_batches: int = 0

    # fc-prithvi-backbone: initialize the backbone from an s2tpu MAE
    # pretraining checkpoint directory (our own pretrain -> finetune flow)
    # instead of the converted Prithvi_100M.pt.
    backbone_ckpt: str | None = None
    # fc-prithvi-backbone: freeze the ViT encoder (stop_gradient + optax
    # zero-update mask; reference preset field segmentation.py:171 ->
    # prithvi_segmentation.py:152-154). False trains the full network.
    frozen_backbone: bool = True
    # Two-phase finetune (BASELINE config #4 "frozen-then-unfrozen"): train
    # with the frozen backbone until this epoch, then unfreeze — the trainer
    # rebuilds the model/optimizer/jitted steps at the transition (fresh Adam
    # moments; params/BN stats/step carry over). None = single phase.
    unfreeze_backbone_at_epoch: int | None = None
    # LR multiplier applied at the unfreeze transition (phase 2 trains the
    # full network — head-only LRs destabilize a pretrained encoder; measured
    # on the pretrain->finetune anchor: lr=1e-3 unfrozen scored 0.9146 vs
    # 0.9574 frozen). 1.0 = keep the schedule unchanged.
    unfreeze_lr_scale: float = 1.0

    # Parameter EMA: maintain an exponential moving average of the params
    # inside the optimizer state (train_state.with_param_ema); validation,
    # epoch image logging, BN recalibration, and `cli/infer` (default;
    # `--no-ema` opts out) then run
    # on the averaged weights (trainer.eval_state). Standard production
    # smoothing the reference lacks (torch.optim.swa_utils unused there).
    # None disables; typical values 0.99-0.9999.
    ema_decay: float | None = None

    # Gradient accumulation: split each batch into N sequential microbatches
    # (lax.scan inside the jit'd step) and apply one optimizer update on the
    # averaged gradients. Effective batch stays datamodule.batch_size;
    # activation memory drops to one microbatch. BN batch statistics are
    # computed per microbatch (running stats updated sequentially).
    grad_accum_steps: int = 1

    # trainer
    max_epochs: int = -1
    log_interval: int = 50
    # Per-layer gradient/parameter norm logging every N steps (reference
    # logger.watch(log="all", log_freq=30), train_segmentation.py:272).
    # 0 disables; the watch reductions are only added to the step program
    # when a run logger is attached, so benches stay unaffected.
    watch_interval: int = 30
    num_devices: int = -1  # -1 = all visible devices; data-parallel mesh size
    overfit_batches: int = 0  # >0: repeat the first N batches (sanity preset)

    # logger / run identity
    use_wandb_logger: bool = True
    project_name: str = "sentinel-segmentation"
    wandb_entity: str | None = None
    run_name: str | None = None
    tags: list[str] = field(default_factory=list)

    seed: int = 42
    class_distribution: list[float] | None = None  # filled from dataset stats

    # lr scheduler
    lr_scheduler_type: LRSchedulerType | None = None
    step_lr_sched_step_size: int | None = None
    step_lr_sched_gamma: float | None = None
    cosine_lr_sched_first_cycle_steps: int | None = None
    cosine_lr_sched_cycle_mult: float | None = None
    cosine_lr_sched_max_lr: float | None = None
    cosine_lr_sched_min_lr: float | None = None
    cosine_lr_sched_warmup_steps: int | None = None
    cosine_lr_sched_gamma: float | None = None

    # checkpointing
    ckpt_every_n_epochs: int = 1
    ckpt_keep: int = 1

    def __post_init__(self) -> None:
        # JSON round-trips (checkpoint config.json) deliver enums as strings.
        if isinstance(self.loss_type, str):
            self.loss_type = LossType(self.loss_type)
        if isinstance(self.lr_scheduler_type, str):
            self.lr_scheduler_type = LRSchedulerType(self.lr_scheduler_type)


@dataclass
class Config:
    model_name: ModelName
    datamodule: DatamoduleConfig
    train: TrainConfig
    num_classes: int | None = None  # derived from the label map

    def __post_init__(self) -> None:
        if isinstance(self.model_name, str):
            self.model_name = ModelName(self.model_name)
        if self.model_name.value.startswith("efficientnet-unet"):
            ds = self.datamodule.dataset_cfg
            assert ds.n_time_frames == 1 or ds.stack_time_into_channels, (
                "EfficientNet-UNet is single-frame: T>1 needs "
                "stack_time_into_channels (--stack-time) to fold frames into channels"
            )
            ds.squeeze_time_dim = ds.n_time_frames == 1
        if self.num_classes is None:
            self.num_classes = LABEL_MAPS[self.datamodule.dataset_cfg.label_map].num_classes

    def build_model(
        self,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        param_dtype: torch.dtype | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.nn.Module:
        """Instantiate the torch module for ``model_name`` on ``device``
        (``resolve_device``: the card unless ``"cpu"`` is asked for).

        ``dtype`` is the compute dtype (defaults to ``train.compute_dtype``).
        Conv and dense weights are held in ``param_dtype`` (default: the
        compute dtype, as serving holds them; the trainer asks for f32) and
        cast to the compute dtype where used; BatchNorm and the classifier
        stay float32 (efficientnet_unet.EfficientNetUNet; the Prithvi
        backbone's parameters are f32 too, prithvi_seg.PrithviSegmentationNet).
        ``generator`` seeds the initialisation. fc-prithvi's geometry is
        :func:`fc_prithvi_config`'s.
        """
        assert self.num_classes is not None
        if dtype is None:
            dtype = COMPUTE_DTYPES[self.train.compute_dtype]
        name = self.model_name.value
        if name.startswith("efficientnet-unet"):
            from s2tpu_torch import resolve_device
            from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig

            ds = self.datamodule.dataset_cfg
            in_ch = ds.in_channels * (ds.n_time_frames if ds.stack_time_into_channels else 1)
            config = EfficientNetUNetConfig(
                version=name.rsplit("-", 1)[-1],
                in_channels=in_ch,
                num_classes=self.num_classes,
                class_distribution=self.train.class_distribution,
            )
            return EfficientNetUNet(
                config, dtype=dtype, device=resolve_device(device), generator=generator, param_dtype=param_dtype
            )
        if name == ModelName.FC_PRITHVI_BACKBONE.value:
            from s2tpu_torch import resolve_device
            from s2tpu_torch.models.prithvi_seg import PrithviSegmentationNet

            return PrithviSegmentationNet(
                fc_prithvi_config(self), dtype=dtype, device=resolve_device(device), generator=generator,
                param_dtype=param_dtype,
            )
        raise ValueError(f"Unknown model: {self.model_name}")


COMPUTE_DTYPES: dict[str, torch.dtype] = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def fc_prithvi_config(config: Config):
    """fc-prithvi-backbone's ``PrithviSegmentationConfig`` for ``config``
    (the JAX ``Config.build_model``'s, ``:263-288``): Prithvi-100M at the
    run's frame count, band count and crop (the patch grid follows the crop;
    the sincos tables regenerate for any /16 crop), the FCN head of one 3x3
    conv of 256, dropout 0.1, frozen as ``train.frozen_backbone`` says. The
    backbone takes the kernels' attention route ("fused")."""
    from s2tpu_torch.models.prithvi_mae import PrithviConfig
    from s2tpu_torch.models.prithvi_seg import PrithviSegmentationConfig

    crop = config.datamodule.random_crop_size
    assert crop % 16 == 0, f"fc-prithvi-backbone needs a /16 crop, got {crop}"
    t = config.datamodule.dataset_cfg.n_time_frames
    return PrithviSegmentationConfig(
        num_frames=t,
        num_classes=config.num_classes,
        fcn_out_channels=256,
        fcn_num_convs=1,
        fcn_dropout=0.1,
        frozen_backbone=config.train.frozen_backbone,
        patch_height=crop // 16,
        patch_width=crop // 16,
        backbone=PrithviConfig(
            num_frames=t, img_size=crop, in_chans=config.datamodule.dataset_cfg.in_channels, attention_impl="fused"
        ),
    )


def base_config(model_name: ModelName | str, aoi: str = "fr", label_map: str = "cnes-multiclass") -> Config:
    """Default experiment config (the JAX package's ``base_config``)."""
    return Config(
        model_name=ModelName(model_name),
        datamodule=DatamoduleConfig(
            dataset_cfg=DatasetConfig(aoi=aoi, label_map=label_map),
            batch_size=32,
            data_split=(0.8, 0.2, 0.0),
            val_batch_size_multiplier=2,
            augment=True,
            random_horizontal_flip_p=0.5,
            random_vertical_flip_p=0.5,
        ),
        train=TrainConfig(),
    )


RunType = typing.Literal["train", "debug", "overfit", "tune"]


def apply_linear_lr_scaling(config: Config, reference_bs: int = 32) -> Config:
    """Treat ``train.lr`` as the base LR at ``reference_bs`` samples per step
    and scale it linearly to ``datamodule.batch_size``, the global batch
    (``s2tpu/configs/segmentation.py:313-335``)."""
    config.train.lr = config.train.lr * config.datamodule.batch_size / reference_bs
    return config


def set_run_type(config: Config, run_type: RunType) -> Config:
    """The JAX package's run-type presets (``s2tpu/configs/segmentation.py:338-360``)."""
    if run_type == "debug":
        config.train.num_devices = 1
        config.datamodule.batch_size = 1
        config.train.compute_dtype = "float32"
        config.train.tags.append("debug")
    elif run_type == "overfit":
        config.train.overfit_batches = 1
        config.datamodule.augment = False
        config.train.tags.append("overfit")
    elif run_type == "tune":
        config.train.tags.append("tune")
        config.train.use_wandb_logger = False  # trials log through the tune JSONL summary
    elif run_type != "train":
        raise ValueError(f"Unknown run type {run_type!r}")
    return config


def config_to_dict(config: Config) -> dict:
    """Flatten a config tree for the checkpoint's ``config.json``."""
    return dataclasses.asdict(config)


def config_from_dict(d: dict) -> Config:
    """Inverse of :func:`config_to_dict` (JSON turns tuples into lists)."""
    ds = DatasetConfig(**d["datamodule"]["dataset_cfg"])
    dm_kwargs = {k: v for k, v in d["datamodule"].items() if k != "dataset_cfg"}
    dm_kwargs["data_split"] = tuple(dm_kwargs["data_split"])
    train_kwargs = dict(d["train"])
    train_kwargs["betas"] = tuple(train_kwargs["betas"])
    return Config(
        model_name=d["model_name"],
        datamodule=DatamoduleConfig(dataset_cfg=ds, **dm_kwargs),
        train=TrainConfig(**train_kwargs),
        num_classes=d.get("num_classes"),
    )
