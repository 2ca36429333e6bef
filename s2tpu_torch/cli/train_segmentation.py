"""Segmentation training CLI (the port of ``s2tpu/cli/train_segmentation.py``).

    python -m s2tpu_torch.cli.train_segmentation <aoi> <labels> <model> [flags] [--device cpu]

Trains on the card unless ``--device cpu``. Epoch checkpoints land in
``ckpts/<project>/<run>/`` (or ``--resume-from``'s directory), which
``python -m s2tpu_torch.cli.infer <run dir>`` serves; scalars go to
``logs/runs/<run>.metrics.jsonl``. Only the flags of features the port has
are accepted: mesh and sharding flags, remat, the device corpus, bf16
parameter storage, EMA, BN recalibration and ``--type tune`` are not ported
yet, and argparse refuses them.

Multi-temporal B5 (BASELINE config #3) folds its frames into channels,
frame-major, for the single-frame UNet (in_channels = T x bands):

    python -m s2tpu_torch.cli.train_segmentation <aoi> cnes-multiclass efficientnet-unet-b5
        --time-frames 4 --stack-time --bands all12 [--loss-type focal --weighted-loss --bs 32]

fc-prithvi (BASELINE config #4) finetunes the Prithvi-100M encoder with a
segmentation neck and head, frozen then unfrozen:

    python -m s2tpu_torch.cli.train_segmentation <aoi> <labels> fc-prithvi-backbone --bs 32
        [--backbone-ckpt <MAE run dir>] [--unfreeze-backbone | --unfreeze-at-epoch N
        [--unfreeze-lr-scale S]] [--time-frames T]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.configs.data_config import AOI_NAMES, LABEL_MAPS
from s2tpu_torch.utils import get_logger, get_unique_run_name

logger = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("aoi", choices=list(AOI_NAMES))
    p.add_argument("labels", choices=list(LABEL_MAPS))
    p.add_argument("model", choices=[m.value for m in cfg_lib.ModelName])
    p.add_argument("--type", default="train", choices=["train", "debug", "overfit"])
    p.add_argument("--loss-type", default=None, choices=[t.value for t in cfg_lib.LossType])
    p.add_argument("--lr-scheduler", default=None, choices=[t.value for t in cfg_lib.LRSchedulerType])
    p.add_argument("--bs", type=int, default=None, help="batch size")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument(
        "--scale-lr-ref-bs", type=int, default=None, metavar="N",
        help="linear LR scaling: treat --lr as the base LR at N samples per step and scale it to the batch size",
    )
    p.add_argument("--epochs", type=int, default=None, help="number of epochs")
    p.add_argument("--log-interval", type=int, default=None)
    p.add_argument("--recompute-mean-std", action="store_true")
    p.add_argument("--focal-loss-gamma", type=float, default=None)
    p.add_argument("--weighted-loss", action="store_true")
    p.add_argument("--weighted-sampling", action="store_true")
    p.add_argument("--cosine-lr-sched-first-cycle-steps", type=int, default=None)
    p.add_argument("--cosine-lr-sched-cycle-mult", type=float, default=None)
    p.add_argument("--cosine-lr-sched-max-lr", type=float, default=None)
    p.add_argument("--cosine-lr-sched-min-lr", type=float, default=None)
    p.add_argument("--cosine-lr-sched-warmup-steps", type=int, default=None)
    p.add_argument("--cosine-lr-sched-gamma", type=float, default=None)
    p.add_argument("--name", default=None, help="run-name prefix")
    p.add_argument("--wandb", action="store_true", help="disable wandb (the port logs to JSONL only)")
    p.add_argument("--tags", nargs="+", default=[])
    p.add_argument("--compute-dtype", default=None, choices=list(cfg_lib.COMPUTE_DTYPES))
    p.add_argument(
        "--bands", default=None,
        help="spectral band set: 'default' (6 Prithvi-HLS bands), 'all12', or a comma list ('B02,B03,B04')",
    )
    p.add_argument("--crop", type=int, default=None, help="training crop size (default 224)")
    p.add_argument(
        "--time-frames", type=int, default=None,
        help="frames per sample (quarterly composites: 4); fc-prithvi takes them as tubelets, the UNet needs "
        "--stack-time",
    )
    p.add_argument(
        "--stack-time", action="store_true",
        help="fold the T axis into channels for single-frame models "
        "(BASELINE config #3: B5 on quarterly composites, in_channels = T*bands)",
    )
    p.add_argument("--data-dir", default=None, help="override the data root")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume-from", default=None, help="run directory of a previous run: restore its latest epoch")
    p.add_argument(
        "--auto-resume", action="store_true",
        help="resume from this run's own directory when it holds a checkpoint; needs a stable --name",
    )
    p.add_argument(
        "--backbone-ckpt", default=None,
        help="fc-prithvi: initialize the backbone from the encoder of a port MAE run directory",
    )
    p.add_argument(
        "--unfreeze-backbone", action="store_true",
        help="fc-prithvi: train the ViT encoder too (default: frozen)",
    )
    p.add_argument(
        "--unfreeze-at-epoch", type=int, default=None,
        help="fc-prithvi two-phase finetune: frozen backbone until this epoch, then unfrozen (fresh optimizer "
        "moments; params/BN/step carry over); resume-safe",
    )
    p.add_argument(
        "--unfreeze-lr-scale", type=float, default=None,
        help="LR multiplier applied at the unfreeze transition (full-network training usually wants ~0.1x)",
    )
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> cfg_lib.Config:
    config = cfg_lib.base_config(args.model, aoi=args.aoi, label_map=args.labels)
    config = cfg_lib.set_run_type(config, args.type)
    t, dmc = config.train, config.datamodule
    dmc.dataset_cfg.data_dir = args.data_dir or dmc.dataset_cfg.data_dir
    if args.bands:
        from s2tpu_torch.configs.data_config import parse_bands

        dmc.dataset_cfg.bands = parse_bands(args.bands)
    if args.time_frames:
        dmc.dataset_cfg.n_time_frames = args.time_frames
    if args.stack_time:
        dmc.dataset_cfg.stack_time_into_channels = True
    dmc.batch_size = args.bs or dmc.batch_size
    dmc.random_crop_size = args.crop or dmc.random_crop_size
    t.lr = args.lr or t.lr
    t.loss_type = cfg_lib.LossType(args.loss_type) if args.loss_type else t.loss_type
    t.max_epochs = args.epochs or t.max_epochs
    t.log_interval = args.log_interval or t.log_interval
    t.use_wandb_logger = False if args.wandb else t.use_wandb_logger
    t.tags.extend(args.tags)
    t.compute_dtype = args.compute_dtype or t.compute_dtype
    t.seed = args.seed if args.seed is not None else t.seed
    t.backbone_ckpt = args.backbone_ckpt or t.backbone_ckpt
    t.frozen_backbone = False if args.unfreeze_backbone else t.frozen_backbone
    t.unfreeze_backbone_at_epoch = (
        args.unfreeze_at_epoch if args.unfreeze_at_epoch is not None else t.unfreeze_backbone_at_epoch
    )
    t.unfreeze_lr_scale = args.unfreeze_lr_scale if args.unfreeze_lr_scale is not None else t.unfreeze_lr_scale
    t.weighted_loss = args.weighted_loss or t.weighted_loss
    t.focal_loss_gamma = args.focal_loss_gamma or t.focal_loss_gamma
    t.lr_scheduler_type = cfg_lib.LRSchedulerType(args.lr_scheduler) if args.lr_scheduler else t.lr_scheduler_type
    t.cosine_lr_sched_first_cycle_steps = args.cosine_lr_sched_first_cycle_steps
    t.cosine_lr_sched_cycle_mult = args.cosine_lr_sched_cycle_mult
    t.cosine_lr_sched_max_lr = args.cosine_lr_sched_max_lr
    t.cosine_lr_sched_min_lr = args.cosine_lr_sched_min_lr
    t.cosine_lr_sched_warmup_steps = args.cosine_lr_sched_warmup_steps
    t.cosine_lr_sched_gamma = args.cosine_lr_sched_gamma
    # --auto-resume needs a run name (-> checkpoint directory) that is stable
    # across invocations of the same command line.
    t.run_name = (
        f"{args.name or 'run'}_{t.project_name}"
        if args.auto_resume
        else get_unique_run_name(name=args.name, postfix=t.project_name)
    )
    if args.scale_lr_ref_bs:
        cfg_lib.apply_linear_lr_scaling(config, reference_bs=args.scale_lr_ref_bs)
    config.__post_init__()  # re-validate fields the flags changed
    return config


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse ``argv``, measure the class distribution and band statistics,
    then train; returns the per-epoch records."""
    from pathlib import Path

    from s2tpu_torch import resolve_device
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.logging_utils import RunLogger
    from s2tpu_torch.train.trainer import SegmentationTrainer

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # before any data work: no card, no run
    config = config_from_args(args)
    ds_cfg = config.datamodule.dataset_cfg
    source = TiffSource(ds_cfg.aoi, ds_cfg.label_map, ds_cfg.data_dir, n_time_frames=ds_cfg.n_time_frames)
    logger.info("Computing class distribution...")
    class_distribution = statistics.get_class_probabilities(
        source, num_classes=config.num_classes, ignore_zero_label=config.train.masked_loss
    )
    config.train.class_distribution = class_distribution.tolist()
    if args.weighted_sampling:
        config.datamodule.class_distribution = class_distribution.tolist()
    dm = Datamodule(config.datamodule, source=source)

    stats_path = source.data_dirs.base_path / "mean_std.json"
    if stats_path.exists() and not args.recompute_mean_std:
        dm.set_mean_std(*statistics.load_mean_std(stats_path))
    else:
        logger.info("Computing per-band mean/std (Welford pass)...")
        stats = statistics.calculate_mean_std(source, save_path=stats_path)
        dm.set_mean_std(np.asarray(stats["mean"]), np.asarray(stats["std"]))

    config_dict = dataclasses.asdict(config)
    run_logger = RunLogger(config.train.run_name, LOG_DIR / "runs", config=config_dict)
    ckpt_dir = Path(args.resume_from) if args.resume_from else CKPT_DIR / config.train.project_name / config.train.run_name
    ckpt = CheckpointManager(ckpt_dir, keep=config.train.ckpt_keep, config_dict=config_dict)
    trainer = SegmentationTrainer(config, dm, run_logger=run_logger, checkpoint_manager=ckpt, device=device)
    start_epoch = trainer.resume_from_checkpoint() if (args.resume_from or args.auto_resume) else 0
    epochs = config.train.max_epochs if config.train.max_epochs > 0 else 10**6
    logger.info(f"Training {config.model_name.value} on {device} into {ckpt_dir}")
    return trainer.fit(epochs=epochs, start_epoch=start_epoch)


if __name__ == "__main__":
    main()
