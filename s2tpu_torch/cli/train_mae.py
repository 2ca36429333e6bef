"""Prithvi MAE pretrain/finetune CLI (the port of ``s2tpu/cli/train_mae.py``).

    python -m s2tpu_torch.cli.train_mae <aoi> [--type pretrain|finetune|debug|overfit]
        [--from-scratch] [--bs N] [--epochs N] [--num-frames T] ... [--device cpu]

Trains on the card unless ``--device cpu``. The corpus is the AOI's
sentinel rasters only (labels are not read), with ``--num-frames`` frames
per sample: the source is built with the dataset config's
``n_time_frames``, which the JAX CLI leaves out. Epoch checkpoints land in
``ckpts/<project>/<run>/`` (or ``--resume-from``'s directory) and scalars in
``logs/runs/<run>.metrics.jsonl``, with the grad/param norms every
``train.watch_interval`` steps. The flags are the JAX CLI's, ``--ema-decay``,
``--grad-accum``, ``--remat``, ``--device-corpus`` and
``--steps-per-dispatch`` among them (with the device corpus, N steps a
window replay one CUDA graph of the whole step on the card), and the
segmentation CLI's ``--watch-interval``, without which a run watches its
norms every 30 steps and so trains one eager step a window. A SIGTERM
saves the state at the next step boundary; the same command with
``--auto-resume`` (or ``--resume-from <run dir>``) continues the
interrupted epoch exactly.

``--num-devices N`` trains data-parallel on N ranks, one process and one
card each (NCCL; with ``--device cpu``, N processes over gloo), as the
segmentation CLI does: each rank trains its slice of every global ``--bs``
batch, the loss and gradients are the global batch's, and only rank 0 logs
and writes checkpoints. Outside a launcher the command starts the N ranks
itself; under ``torchrun --nproc-per-node N -m s2tpu_torch.cli.train_mae``
N must equal the world size. -1 (the default) takes every visible card (a
launcher's world size; one process on the CPU). With ``--device-corpus
--steps-per-dispatch K`` each rank replays its step graph over NCCL.
``--device-corpus-sharded`` implies ``--device-corpus`` and, on N > 1
ranks, uploads to each rank only its 1/N block of the images.

``--pp S`` runs the ViT's encoder blocks (and its decoder blocks where S
divides their depth) as S GPipe stages over the mesh's model axis, in
``--pp-microbatches`` micro-batches (default 2): ``--num-devices N`` then
builds an (N / S) x S data x model mesh, as the JAX CLI's
``make_mesh(N, model_parallel=S)`` (``s2tpu_torch.parallel.pipeline``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from s2tpu_torch.configs import mae as mae_cfg
from s2tpu_torch.configs.data_config import AOI_NAMES
from s2tpu_torch.utils import get_logger, get_unique_run_name

logger = get_logger(__name__)

MAE_LABEL_MAP = "osm-multiclass"  # the sources' file contract needs one; MAE reads no labels


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("aoi", choices=list(AOI_NAMES))
    p.add_argument("--type", default="finetune", choices=list(mae_cfg.PRESETS))
    p.add_argument("--from-scratch", action="store_true", help="random init (no Prithvi_100M.pt)")
    p.add_argument("--bs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--log-interval", type=int, default=None)
    p.add_argument(
        "--watch-interval", type=int, default=None,
        help="grad/param-norm logging every N steps (0 disables; default 30); a watched run trains one step a "
        "window, so --steps-per-dispatch needs 0",
    )
    p.add_argument("--num-frames", type=int, default=None)
    p.add_argument("--crop", type=int, default=None, help="training crop size (/16; default 224)")
    p.add_argument(
        "--bands", default=None,
        help="spectral band set ('default', 'all12', or a comma list); other than the Prithvi-HLS six, "
        "normalization uses the dataset's statistics",
    )
    p.add_argument("--mask-ratio", type=float, default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--wandb", action="store_true", help="disable wandb (the port logs to JSONL only)")
    p.add_argument("--tags", nargs="+", default=[])
    p.add_argument(
        "--num-devices", type=int, default=-1,
        help="data-parallel ranks, one process and one card each (-1: every visible card; one process on the CPU)",
    )
    p.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument(
        "--ema-decay", type=float, default=None,
        help="keep a parameter EMA; the val loss and the reconstruction use the averaged weights",
    )
    p.add_argument("--data-dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=None, help="micro-batches per optimizer update")
    p.add_argument("--remat", action="store_true", help="recompute each ViT block's activations in the backward pass")
    p.add_argument(
        "--pp", type=int, default=None, metavar="STAGES",
        help="pipeline-parallel stages over the mesh's 'model' axis (GPipe micro-batch schedule; --num-devices "
        "must be divisible by it)",
    )
    p.add_argument("--pp-microbatches", type=int, default=None, help="micro-batches per pipeline schedule (default 2)")
    p.add_argument(
        "--device-corpus", action="store_true", help="upload the corpus to the card once; crop and flip on the card"
    )
    p.add_argument(
        "--device-corpus-sharded", action="store_true",
        help="implies --device-corpus; on N ranks each card holds only its 1/N block of the images",
    )
    p.add_argument(
        "--steps-per-dispatch", type=int, default=None,
        help="device-corpus mode: N steps a window, each a replay of one CUDA graph of the whole step "
        "(watched norms are read every step: with --watch-interval above 0, windows hold one eager step)",
    )
    p.add_argument("--resume-from", default=None, help="run directory of a previous run: restore its latest epoch")
    p.add_argument(
        "--auto-resume", action="store_true",
        help="resume from this run's own directory when it holds a checkpoint; needs a stable --name",
    )
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> mae_cfg.MAEConfig:
    config = mae_cfg.base_config(aoi=args.aoi)
    config.train.num_devices = args.num_devices
    config = mae_cfg.PRESETS[args.type](config)
    t, dmc = config.train, config.datamodule
    dmc.dataset_cfg.data_dir = args.data_dir or dmc.dataset_cfg.data_dir
    if args.bands:
        from s2tpu_torch.configs.data_config import parse_bands

        dmc.dataset_cfg.bands = parse_bands(args.bands)
    dmc.batch_size = args.bs or dmc.batch_size
    if args.crop:
        if args.crop % 16:
            raise ValueError(f"--crop must be a multiple of the ViT patch size 16, got {args.crop}")
        dmc.random_crop_size = args.crop
    t.from_scratch = args.from_scratch or t.from_scratch
    t.lr = args.lr or t.lr
    t.max_epochs = args.epochs or t.max_epochs
    t.log_interval = args.log_interval or t.log_interval
    t.watch_interval = args.watch_interval if args.watch_interval is not None else t.watch_interval
    t.compute_dtype = args.compute_dtype or t.compute_dtype
    t.ema_decay = args.ema_decay if args.ema_decay is not None else t.ema_decay
    t.use_wandb_logger = False if args.wandb else t.use_wandb_logger
    t.tags.extend(args.tags)
    t.seed = args.seed if args.seed is not None else t.seed
    t.grad_accum_steps = args.grad_accum or t.grad_accum_steps
    t.remat = args.remat or t.remat
    t.device_corpus = args.device_corpus or args.device_corpus_sharded or t.device_corpus
    t.device_corpus_sharded = args.device_corpus_sharded or t.device_corpus_sharded
    t.steps_per_dispatch = args.steps_per_dispatch if args.steps_per_dispatch is not None else t.steps_per_dispatch
    if args.num_frames:
        config.model.num_frames = args.num_frames
        dmc.dataset_cfg.n_time_frames = args.num_frames
    if args.mask_ratio is not None:
        config.model.mask_ratio = args.mask_ratio
    if args.pp:
        config.model.pipeline_stages = args.pp
    if args.pp_microbatches:
        config.model.pipeline_microbatches = args.pp_microbatches
    # --auto-resume needs a run name (-> checkpoint directory) that is stable
    # across invocations of the same command line.
    t.run_name = (
        f"{args.name or 'run'}_{t.project_name}"
        if args.auto_resume
        else get_unique_run_name(name=args.name, postfix=t.project_name)
    )
    t.wandb_entity = os.getenv("WANDB_ENTITY")
    return config


def build_datamodule(config: mae_cfg.MAEConfig):
    """The MAE corpus of ``config``: the AOI's sentinel rasters without
    labels, ``n_time_frames`` frames per sample, host crops and flips."""
    from s2tpu_torch.configs.segmentation import DatamoduleConfig, DatasetConfig
    from s2tpu_torch.data.dataset import TiffSource
    from s2tpu_torch.data.pipeline import Datamodule

    ds, dmc = config.datamodule.dataset_cfg, config.datamodule
    source = TiffSource(
        ds.aoi, MAE_LABEL_MAP, data_dir=ds.data_dir, require_labels=False, n_time_frames=ds.n_time_frames
    )
    return Datamodule(
        DatamoduleConfig(
            dataset_cfg=DatasetConfig(
                aoi=ds.aoi, label_map=MAE_LABEL_MAP, data_dir=ds.data_dir, bands=list(ds.bands),
                n_time_frames=ds.n_time_frames,
            ),
            batch_size=dmc.batch_size,
            data_split=dmc.data_split,
            val_batch_size_multiplier=dmc.val_batch_size_multiplier,
            augment=dmc.augment,
            random_crop_size=dmc.random_crop_size,
            prefetch=dmc.prefetch,
            shuffle_seed=dmc.shuffle_seed,
        ),
        source=source,
    )


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse ``argv`` and train; returns the per-epoch records."""
    from pathlib import Path

    import torch.distributed as dist

    from s2tpu_torch import resolve_device
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs.paths import CKPT_DIR, LOG_DIR
    from s2tpu_torch.parallel import multihost
    from s2tpu_torch.train.logging_utils import RunLogger
    from s2tpu_torch.train.mae_trainer import MAETrainer

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # before any data work: no card, no run
    n = multihost.num_ranks(args.num_devices, device)
    if (args.pp or 1) > 1 and n % args.pp:
        raise SystemExit(f"--pp {args.pp} needs --num-devices N divisible by {args.pp} (N ranks, one process "
                         f"each), and {n} rank(s) were asked for")
    if n > 1 and not dist.is_initialized() and not multihost.under_launcher():
        return multihost.spawn_ranks(main, argv, n, device)
    mesh = multihost.data_axis_mesh(n, device, model_parallel=args.pp or 1)
    rank0 = multihost.process_index() == 0
    config = config_from_args(args)
    multihost.share_run_name(config.train, n)
    dm = build_datamodule(config)
    config_dict = dataclasses.asdict(config)
    run_logger = RunLogger(config.train.run_name, LOG_DIR / "runs", config=config_dict) if rank0 else None
    ckpt_dir = Path(args.resume_from) if args.resume_from else CKPT_DIR / config.train.project_name / config.train.run_name
    ckpt = CheckpointManager(ckpt_dir, keep=config.train.ckpt_keep, config_dict=config_dict if rank0 else None)
    trainer = MAETrainer(config, dm, mesh=mesh, run_logger=run_logger, checkpoint_manager=ckpt, device=device)
    start_epoch = trainer.resume_from_checkpoint() if (args.resume_from or args.auto_resume) else 0
    epochs = config.train.max_epochs if config.train.max_epochs > 0 else 10**6
    ranks = f" and {n - 1} more ranks" if n > 1 else ""
    logger.info(f"MAE {args.type} of Prithvi ({config.model.num_frames} frame(s)) on {trainer.device}{ranks} "
                f"into {ckpt_dir}")
    return trainer.fit(epochs=epochs, start_epoch=start_epoch)


if __name__ == "__main__":
    main()
