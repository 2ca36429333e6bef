"""Segmentation training CLI (the port of ``s2tpu/cli/train_segmentation.py``).

    python -m s2tpu_torch.cli.train_segmentation <aoi> <labels> <model> [flags] [--device cpu]

Trains on the card unless ``--device cpu``. Epoch checkpoints land in
``ckpts/<project>/<run>/`` (or ``--resume-from``'s directory), which
``python -m s2tpu_torch.cli.infer <run dir>`` serves; scalars go to
``logs/runs/<run>.metrics.jsonl``, with the grad/param norms every
``--watch-interval`` steps, and, where matplotlib is installed, each epoch's
confusion matrix and two validation predictions go to
``logs/runs/<run>/*.png``. ``--source`` picks the input: ``auto`` (default)
reads the packed corpus under ``<data>/<aoi>/packed/<labels>`` when one
exists (``python -m s2tpu_torch.cli.pack``), else the GeoTIFF tree;
``tiff``, ``packed`` (the memmap pack, gathered by the native C++ crop
gather) and ``records`` (the sharded ``.s2rec`` corpus) force one.
``--device-corpus`` uploads the AOI to the card once and gathers each step's
crops there; with it, ``--steps-per-dispatch N`` replays one CUDA graph of
the whole step N steps a window (on the CPU, with ``--device cpu``, the same
windows of eager steps). ``--device-corpus-sharded`` implies
``--device-corpus`` and, on N > 1 ranks, uploads to each rank only its
1/N block of the segments, from which it draws its rows of every batch (on
one rank it is the plain corpus). The trainer's extras take the JAX
CLI's flags (``--remat``, ``--param-dtype bfloat16``, ``--ema-decay D``,
``--watch-interval N``, ``--bn-recal N``); gradient accumulation is the
config field ``train.grad_accum_steps``, as in the JAX CLI. A SIGTERM saves
the state at the next step boundary; the same command with ``--auto-resume``
(or ``--resume-from <run dir>``) continues the interrupted epoch exactly.

``--type tune`` searches hyperparameters instead of training one run:
``--n-trials`` short fits of ``--epochs-per-trial`` epochs each, pruned by
ASHA (``--tune-eta``), over the learning rate, weight decay, loss, schedule
and, with ``--tune-crops`` / ``--tune-batch-sizes``, the crop and batch
size (``train/tune.py``); it logs ``tune/*`` scalars by rank and prints
``best_params=...``.

``--num-devices N`` trains data-parallel on N ranks, one process and one
card each (NCCL; with ``--device cpu``, N processes over gloo): each rank
trains its slice of every global ``--bs`` batch, with BatchNorm statistics,
losses and metrics of the global batch, and only rank 0 logs and writes
checkpoints. Outside a launcher the command starts the N ranks itself;
under ``torchrun --nproc-per-node N -m s2tpu_torch.cli.train_segmentation``
N must equal the world size. -1 (the default) takes every visible card (a
launcher's world size; one process on the CPU); N above the visible cards is
an error. fc-prithvi trains on N ranks as the UNet does. ``--fsdp`` passes
``param_sharding="fsdp"`` to the trainer, as ``s2tpu``'s CLI does: the
CLI's mesh has a model axis of one rank, over which nothing is sharded, so
the parameters stay replicated (pure data parallelism). A model axis above
one rank is reached through the trainer's API
(``SegmentationTrainer(mesh=make_mesh(n, model_parallel=m),
param_sharding="fsdp")``), as in ``s2tpu``.

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
import sys

import numpy as np
import torch.distributed as dist

from s2tpu_torch.configs import segmentation as cfg_lib
from s2tpu_torch.configs.data_config import AOI_NAMES, LABEL_MAPS
from s2tpu_torch.parallel import multihost
from s2tpu_torch.utils import get_logger, get_unique_run_name

logger = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("aoi", choices=list(AOI_NAMES))
    p.add_argument("labels", choices=list(LABEL_MAPS))
    p.add_argument("model", choices=[m.value for m in cfg_lib.ModelName])
    p.add_argument("--type", default="train", choices=["train", "debug", "overfit", "tune"])
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
    p.add_argument(
        "--watch-interval", type=int, default=None,
        help="grad/param-norm logging every N steps (0 disables; default 30)",
    )
    p.add_argument(
        "--bn-recal", type=int, default=None,
        help="pool exact BN statistics over N train batches before each val pass (short runs: the 0.99 BN EMA "
        "needs hundreds of steps to converge)",
    )
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
    p.add_argument(
        "--num-devices", type=int, default=-1,
        help="data-parallel ranks, one process and one card each (-1 = all visible cards; one process on the CPU)",
    )
    p.add_argument(
        "--fsdp", action="store_true",
        help="shard params over the 'model' mesh axis (the CLI's mesh has a model axis of 1: params stay "
        "replicated, pure data parallelism, as in s2tpu)",
    )
    p.add_argument(
        "--device-corpus-sharded", action="store_true",
        help="implies --device-corpus; on N ranks each card holds only its 1/N block of the segments",
    )
    p.add_argument("--remat", action="store_true", help="recompute each block's activations in the backward pass")
    p.add_argument(
        "--device-corpus", action="store_true",
        help="upload the corpus to the card once; crop and flip on the card",
    )
    p.add_argument(
        "--steps-per-dispatch", type=int, default=None,
        help="device-corpus mode: N steps a window, each a replay of one CUDA graph of the whole step "
        "(watched norms are read every step: with --watch-interval above 0, windows hold one eager step)",
    )
    p.add_argument("--compute-dtype", default=None, choices=list(cfg_lib.COMPUTE_DTYPES))
    p.add_argument(
        "--param-dtype", default=None, choices=["bfloat16", "float32"],
        help="parameter storage dtype (bfloat16 keeps an f32 master for the optimizer)",
    )
    p.add_argument(
        "--ema-decay", type=float, default=None,
        help="keep a parameter EMA and run validation and serving on the averaged weights (typical 0.99-0.9999)",
    )
    p.add_argument(
        "--source", default="auto", choices=["auto", "tiff", "packed", "records"],
        help="input backend: auto picks a packed corpus when one exists",
    )
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
    # --type tune knobs (random search with ASHA pruning)
    p.add_argument("--n-trials", type=int, default=10, help="tune: number of random-search trials")
    p.add_argument("--epochs-per-trial", type=int, default=3, help="tune: short-fit budget per trial")
    p.add_argument(
        "--tune-crops", default=None,
        help="tune: comma list of crop sizes to search (e.g. '128,224'); default keeps the configured crop fixed",
    )
    p.add_argument(
        "--tune-batch-sizes", default=None,
        help="tune: comma list of batch sizes to search; default keeps the configured batch size fixed",
    )
    p.add_argument("--tune-eta", type=int, default=2, help="tune: ASHA successive-halving factor (1 disables pruning)")
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
    t.watch_interval = args.watch_interval if args.watch_interval is not None else t.watch_interval
    t.bn_recalibration_batches = args.bn_recal if args.bn_recal is not None else t.bn_recalibration_batches
    t.num_devices = args.num_devices
    t.remat = args.remat or t.remat
    t.device_corpus = args.device_corpus or args.device_corpus_sharded or t.device_corpus
    t.device_corpus_sharded = args.device_corpus_sharded or t.device_corpus_sharded
    t.steps_per_dispatch = args.steps_per_dispatch if args.steps_per_dispatch is not None else t.steps_per_dispatch
    t.use_wandb_logger = False if args.wandb else t.use_wandb_logger
    t.tags.extend(args.tags)
    t.compute_dtype = args.compute_dtype or t.compute_dtype
    t.param_dtype = args.param_dtype or t.param_dtype
    t.ema_decay = args.ema_decay if args.ema_decay is not None else t.ema_decay
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


def main(argv: list[str] | None = None) -> list:
    """Parse ``argv``, open the input source, measure the class distribution
    and band statistics, then train; returns the per-epoch records (with
    ``--type tune``, the trials, best first)."""
    from pathlib import Path

    from s2tpu_torch import resolve_device
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs.data_config import DataDirs
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.data import statistics
    from s2tpu_torch.data.dataset import open_source
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.logging_utils import RunLogger
    from s2tpu_torch.train.trainer import SegmentationTrainer

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # before any data work: no card, no run
    n = multihost.num_ranks(args.num_devices, device)
    if n > 1 and not dist.is_initialized() and not multihost.under_launcher():
        if args.type == "tune":
            raise SystemExit("--type tune runs its trials in one process: use --num-devices 1")
        return multihost.spawn_ranks(main, argv, n, device)
    mesh = multihost.data_axis_mesh(n, device)
    rank0 = multihost.process_index() == 0
    config = config_from_args(args)
    multihost.share_run_name(config.train, n)
    ds_cfg = config.datamodule.dataset_cfg
    source = open_source(ds_cfg.aoi, ds_cfg.label_map, ds_cfg.data_dir, n_time_frames=ds_cfg.n_time_frames,
                         kind=args.source)
    logger.info(f"Input source: {type(source).__name__}")
    logger.info("Computing class distribution...")
    class_distribution = statistics.get_class_probabilities(
        source, num_classes=config.num_classes, ignore_zero_label=config.train.masked_loss
    )
    config.train.class_distribution = class_distribution.tolist()
    if args.weighted_sampling:
        config.datamodule.class_distribution = class_distribution.tolist()
    dm = Datamodule(config.datamodule, source=source)

    # Beside the GeoTIFF tree, whichever source is read: a packed or record
    # corpus has no tree of its own (s2tpu/cli/train_segmentation.py:272).
    stats_path = DataDirs(ds_cfg.aoi, ds_cfg.label_map, data_dir=ds_cfg.data_dir).base_path / "mean_std.json"
    if stats_path.exists() and not args.recompute_mean_std:
        dm.set_mean_std(*statistics.load_mean_std(stats_path))
    else:
        logger.info("Computing per-band mean/std (Welford pass)...")
        stats = statistics.calculate_mean_std(source, save_path=stats_path if rank0 else None)
        dm.set_mean_std(np.asarray(stats["mean"]), np.asarray(stats["std"]))

    config_dict = dataclasses.asdict(config)
    run_logger = RunLogger(config.train.run_name, LOG_DIR / "runs", config=config_dict) if rank0 else None
    if args.type == "tune":
        return _tune(args, config, dm, run_logger, device)
    ckpt_dir = Path(args.resume_from) if args.resume_from else CKPT_DIR / config.train.project_name / config.train.run_name
    ckpt = CheckpointManager(ckpt_dir, keep=config.train.ckpt_keep, config_dict=config_dict if rank0 else None)
    trainer = SegmentationTrainer(config, dm, run_logger=run_logger, checkpoint_manager=ckpt, device=device,
                                  mesh=mesh, param_sharding="fsdp" if args.fsdp else "replicated")
    start_epoch = trainer.resume_from_checkpoint() if (args.resume_from or args.auto_resume) else 0
    epochs = config.train.max_epochs if config.train.max_epochs > 0 else 10**6
    ranks = f" and {n - 1} more ranks" if n > 1 else ""
    logger.info(f"Training {config.model_name.value} on {trainer.device}{ranks} into {ckpt_dir}")
    return trainer.fit(epochs=epochs, start_epoch=start_epoch)


def _tune(args: argparse.Namespace, config: cfg_lib.Config, dm, run_logger, device) -> list:
    """``--type tune`` (``s2tpu/cli/train_segmentation.py:289-332``): the
    trials over a datamodule rebuilt per trial (crop and batch size are
    trial dimensions) with the measured band statistics; ``tune/*`` scalars
    by rank, then ``best_params=``."""
    from s2tpu_torch.data.pipeline import Datamodule
    from s2tpu_torch.train.tune import SearchSpace, tune

    if args.n_trials < 1:
        raise SystemExit("--n-trials must be >= 1 for --type tune")
    space = SearchSpace(
        crop_sizes=tuple(int(c) for c in args.tune_crops.split(",")) if args.tune_crops else (),
        batch_sizes=tuple(int(b) for b in args.tune_batch_sizes.split(",")) if args.tune_batch_sizes else (),
    )
    mean_std = dm.mean_std()

    def rebuild_dm(cfg):
        trial_dm = Datamodule(cfg.datamodule, source=dm.source)
        trial_dm.set_mean_std(*mean_std)
        return trial_dm

    results = tune(config, datamodule_factory=rebuild_dm, n_trials=args.n_trials,
                   epochs_per_trial=args.epochs_per_trial, seed=config.train.seed, space=space, eta=args.tune_eta,
                   device=device)
    for rank, r in enumerate(results):
        run_logger.log_scalars(
            {"tune/val_loss": r.val_loss, "tune/val_iou": r.val_iou,
             **{f"tune/param_{k}": float(v) for k, v in r.params.items() if isinstance(v, (int, float))}},
            step=rank,
        )
    best = results[0]
    logger.info(f"Best trial: {best.params} (val_loss {best.val_loss:.4f}, iou {best.val_iou:.4f})")
    print(f"best_params={best.params}")
    return results


if __name__ == "__main__":
    main()
