"""Checkpoint migration CLI (the port of ``s2tpu/cli/convert_weights.py``): reference PyTorch files <-> port checkpoints.

The same six kinds and flags as the JAX CLI; where it writes Orbax, this one
writes the port's own checkpoints (``s2tpu_torch.checkpoint.io``). No device
is needed: these are file conversions.

Backbone weights:

    python -m s2tpu_torch.cli.convert_weights prithvi weights/Prithvi_100M.pt --out D [--num-frames T]
    python -m s2tpu_torch.cli.convert_weights efficientnet weights/efficientnet-b5.pth --version b5 --out F.pt

``prithvi`` writes a port MAE run directory (epoch 0) that
``load_mae_checkpoint``, ``train_segmentation --backbone-ckpt`` and
``export_embeddings`` read; ``efficientnet`` writes a state dict that
``EfficientNetUNet(version, in_channels=6, num_classes=2)`` loads with
``strict=True``: the encoder from the ImageNet file, the 6-band stem and the
decoder at seeded init.

A trained reference Lightning ``.ckpt`` (or a bare state dict) becomes a
complete port run directory at epoch 0, which ``cli.infer`` serves and
``train_segmentation --resume-from`` continues:

    python -m s2tpu_torch.cli.convert_weights import-ckpt runs/unet_b5.ckpt --model efficientnet-unet-b5
        --aoi at --labels osm-multiclass [--crop N] --out ckpts/sentinel-segmentation/imported-b5

A port run exports to the reference names (Prithvi with its position tables
put back), for a PyTorch serving stack or for ``s2tpu``'s own importers:

    python -m s2tpu_torch.cli.convert_weights export-unet <run dir> --out F.pt [--epoch N] [--no-ema]
    python -m s2tpu_torch.cli.convert_weights export-prithvi <MAE run dir> --out F.pt
    python -m s2tpu_torch.cli.convert_weights export-prithvi-seg <run dir> --out F.pt

The port's trainers keep no parameter EMA (ROADMAP item 15.4), so a port run
exports its raw weights; ``--no-ema`` is accepted for the JAX CLI's command
lines.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from s2tpu_torch.utils import get_logger, load_prithvi_model_args

logger = get_logger(__name__)

KINDS = ("prithvi", "efficientnet", "import-ckpt", "export-unet", "export-prithvi", "export-prithvi-seg")


def convert_prithvi(path: str, out: str, num_frames: int = 1, aoi: str | None = None) -> Path:
    """Published-layout Prithvi MAE weights -> a port MAE run directory at
    epoch 0: the MAE finetune preset's config at ``num_frames`` frames and
    the weights loaded with ``strict=True`` into a ``PrithviMAE`` of the
    published geometry (``PrithviConfig.from_model_args``), beside a fresh
    Adam as ``MAETrainer`` builds it."""
    from s2tpu_torch.checkpoint.convert import load_prithvi_weights
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs import mae as mae_cfg
    from s2tpu_torch.models.prithvi_mae import PrithviConfig, PrithviMAE
    from s2tpu_torch.train.train_state import make_optimizer

    model_config = PrithviConfig.from_model_args(load_prithvi_model_args(), num_frames=num_frames)
    config = mae_cfg.finetune(mae_cfg.base_config(aoi) if aoi else mae_cfg.base_config())
    config.model.num_frames = config.datamodule.dataset_cfg.n_time_frames = num_frames
    config.datamodule.random_crop_size = model_config.img_size
    model = PrithviMAE(model_config, generator=torch.Generator().manual_seed(config.train.seed))
    load_prithvi_weights(model, path)
    t = config.train
    ckpt = CheckpointManager(out, keep=t.ckpt_keep, config_dict=dataclasses.asdict(config))
    ckpt.save_epoch(0, model, make_optimizer(model.parameters(), t.lr, t.weight_decay, t.betas), step=0)
    logger.info(f"Converted Prithvi weights {path} -> MAE run directory {out} (epoch 0, {num_frames} frame(s))")
    return Path(out)


def convert_efficientnet(path: str, out: str, version: str) -> Path:
    """lukemelas ImageNet EfficientNet-``version`` -> a state dict of
    ``EfficientNetUNet(version, in_channels=6, num_classes=2)``: the mapped
    encoder over the model's seeded init (the RGB stem and the decoder stay
    at it)."""
    from s2tpu_torch.checkpoint.convert import convert_efficientnet_state_dict
    from s2tpu_torch.models.efficientnet_unet import EfficientNetUNet, EfficientNetUNetConfig

    model = EfficientNetUNet(EfficientNetUNetConfig(version=version, in_channels=6, num_classes=2),
                             generator=torch.Generator().manual_seed(0))
    encoder = convert_efficientnet_state_dict(torch.load(path, map_location="cpu", weights_only=True), in_channels=6)
    model.load_state_dict({**model.state_dict(), **encoder}, strict=True)  # raises on a key or shape of another version
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), out)
    logger.info(f"Converted EfficientNet-{version} weights {path} -> {out} ({len(encoder)} encoder tensors)")
    return Path(out)


def import_reference_checkpoint(
    path: str, model_name: str, aoi: str, labels: str, out: str, crop: int | None = None
) -> Path:
    """A trained reference checkpoint -> a complete port run directory at
    epoch 0 (``s2tpu/cli/convert_weights.py:83-140``): ``config.json`` of
    ``base_config(model_name, aoi, labels)`` (``crop`` the tile and crop
    size), the weights loaded with ``strict=True`` into the config's model,
    and the optimizer as ``SegmentationTrainer`` builds it (Adam over the
    parameters that require a gradient: fc-prithvi's frozen backbone stays
    out), at step 0. The trainer sets each step's learning rate from its
    schedule."""
    from s2tpu_torch.checkpoint.convert import reference_state_dict
    from s2tpu_torch.checkpoint.io import CheckpointManager
    from s2tpu_torch.configs import segmentation as cfg_lib
    from s2tpu_torch.train.train_state import make_optimizer

    config = cfg_lib.base_config(model_name, aoi=aoi, label_map=labels)
    if crop:
        config.datamodule.random_crop_size = crop
    t = config.train
    model = config.build_model(device="cpu", param_dtype=torch.float32, generator=torch.Generator().manual_seed(t.seed))
    model.load_state_dict(reference_state_dict(torch.load(path, map_location="cpu", weights_only=True)), strict=True)
    optimizer = make_optimizer(model.parameters(), t.lr, t.weight_decay, t.betas)
    ckpt = CheckpointManager(out, keep=t.ckpt_keep, config_dict=dataclasses.asdict(config))
    ckpt.save_epoch(0, model, optimizer, step=0)
    logger.info(f"Imported reference checkpoint {path} -> {out} (epoch 0)")
    return Path(out)


def _refuse_ema(config_dict: dict, use_ema: bool, run_dir: str) -> None:
    if use_ema and (config_dict.get("train") or {}).get("ema_decay"):
        raise NotImplementedError(
            f"{run_dir} was configured with ema_decay, but the port keeps no parameter EMA (ROADMAP item 15.4): "
            "pass --no-ema to export the raw weights"
        )


def export_unet_checkpoint(run_dir: str, out: str, epoch: int | None = None, use_ema: bool = True) -> Path:
    """A port EfficientNet-UNet run (its latest epoch, or ``epoch``) -> the
    reference ``EfficientnetUnet`` state dict, f32 (the port's names are the
    reference's; the reference's unused ``encoder.fc`` is not in it)."""
    from s2tpu_torch.checkpoint.convert import cpu_f32
    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.configs.segmentation import config_to_dict

    config, state = load_checkpoint(run_dir, epoch=epoch)
    if not config.model_name.value.startswith("efficientnet-unet"):
        raise ValueError(f"export-unet needs an efficientnet-unet run, got {config.model_name.value}")
    _refuse_ema(config_to_dict(config), use_ema, run_dir)
    return _save(cpu_f32(state), out, f"{run_dir} -> {out} (reference UNet layout)")


def export_prithvi_checkpoint(run_dir: str, out: str, epoch: int | None = None, use_ema: bool = True) -> Path:
    """A port MAE run -> the published ``Prithvi_100M.pt`` layout, the
    position tables regenerated for the run's frames and crop."""
    from s2tpu_torch.checkpoint.convert import with_position_tables
    from s2tpu_torch.checkpoint.io import load_mae_checkpoint
    from s2tpu_torch.models.prithvi_mae import PrithviConfig

    config, state = load_mae_checkpoint(run_dir, epoch=epoch)
    _refuse_ema(dataclasses.asdict(config), use_ema, run_dir)
    model_config = PrithviConfig.from_model_args(
        load_prithvi_model_args(), num_frames=config.model.num_frames, img_size=config.datamodule.random_crop_size
    )
    return _save(with_position_tables(state, model_config), out, f"{run_dir} -> {out} (Prithvi_100M layout)")


def export_prithvi_seg_checkpoint(run_dir: str, out: str, epoch: int | None = None, use_ema: bool = True) -> Path:
    """A port fc-prithvi run -> the reference ``PrithviSegmentationNet``
    state dict, ``backbone.pos_embed`` regenerated for the run's geometry."""
    from s2tpu_torch.checkpoint.convert import with_position_tables
    from s2tpu_torch.checkpoint.io import load_checkpoint
    from s2tpu_torch.configs.segmentation import config_to_dict, fc_prithvi_config

    config, state = load_checkpoint(run_dir, epoch=epoch)
    if not config.model_name.value.startswith("fc-prithvi"):
        raise ValueError(f"export-prithvi-seg needs an fc-prithvi run, got {config.model_name.value}")
    _refuse_ema(config_to_dict(config), use_ema, run_dir)
    backbone = fc_prithvi_config(config).backbone
    return _save(with_position_tables(state, backbone, prefix="backbone."), out,
                 f"{run_dir} -> {out} (reference seg-net layout)")


def _save(state: dict[str, torch.Tensor], out: str, what: str) -> Path:
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    logger.info(f"Exported {what}: {len(state)} tensors")
    return Path(out)


def build_parser() -> argparse.ArgumentParser:
    from s2tpu_torch.configs.data_config import AOI_NAMES, LABEL_MAPS
    from s2tpu_torch.configs.segmentation import ModelName

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=list(KINDS))
    p.add_argument(
        "path", help=".pt/.pth/.ckpt file of the reference ecosystem (import), or a port run directory (export-*)"
    )
    p.add_argument("--out", required=True)
    p.add_argument("--num-frames", type=int, default=1, help="prithvi: frames of the MAE run")
    p.add_argument("--version", default="b0", help="efficientnet: EfficientNet version (b0-b7)")
    p.add_argument("--model", default=None, choices=[m.value for m in ModelName], help="import-ckpt: model name")
    p.add_argument("--aoi", default=None, choices=list(AOI_NAMES),
                   help="import-ckpt: AOI; prithvi: the MAE run's AOI (default: the MAE config's)")
    p.add_argument("--labels", default=None, choices=list(LABEL_MAPS), help="import-ckpt: label map")
    p.add_argument("--crop", type=int, default=None, help="import-ckpt: crop/tile size (default 224)")
    p.add_argument("--epoch", type=int, default=None, help="export-*: checkpoint epoch (default latest)")
    p.add_argument(
        "--no-ema", action="store_true",
        help="export-*: export the raw params (a port run has no EMA; a config with ema_decay needs this flag)",
    )
    return p


def main(argv: list[str] | None = None) -> Path:
    p = build_parser()
    args = p.parse_args(argv)
    use_ema = not args.no_ema
    if args.kind == "prithvi":
        return convert_prithvi(args.path, args.out, args.num_frames, aoi=args.aoi)
    if args.kind == "efficientnet":
        return convert_efficientnet(args.path, args.out, args.version)
    if args.kind == "export-unet":
        return export_unet_checkpoint(args.path, args.out, epoch=args.epoch, use_ema=use_ema)
    if args.kind == "export-prithvi":
        return export_prithvi_checkpoint(args.path, args.out, epoch=args.epoch, use_ema=use_ema)
    if args.kind == "export-prithvi-seg":
        return export_prithvi_seg_checkpoint(args.path, args.out, epoch=args.epoch, use_ema=use_ema)
    if not (args.model and args.aoi and args.labels):
        p.error("import-ckpt requires --model, --aoi and --labels")
    return import_reference_checkpoint(args.path, args.model, args.aoi, args.labels, args.out, crop=args.crop)


if __name__ == "__main__":
    main()
