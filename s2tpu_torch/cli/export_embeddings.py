"""Export MAE encoder embeddings: MAE run directory -> per-segment feature vectors (the port of ``s2tpu/cli/export_embeddings.py``).

    python -m s2tpu_torch.cli.export_embeddings <MAE run dir> [--split all] [--pool mean|cls|tokens]
        [--crop N] [--bs N] [--epoch N] [--data-dir D] [--out F.npz] [--device cuda|cpu]

Reads a run directory of ``s2tpu_torch.cli.train_mae`` (or of
``convert_weights prithvi``), its best epoch by the validation loss or else
its latest, and writes an ``.npz`` with ``embeddings`` (N, D), or
(N, 1 + L, D) for ``--pool tokens``, ``segment_ids`` (the on-disk segment
stems) and ``meta`` (the export settings, JSON), as the JAX CLI does.
Segments are center-cropped to ``--crop`` (default: the run's training
crop; 0: the whole segment); the position tables are regenerated for the
crop, which must be a multiple of the patch size. Runs on the card unless
``--device cpu``. ``--int8`` waits for ``infer/quantize.py`` (ROADMAP item
17) and is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from s2tpu_torch.utils import get_logger, load_prithvi_mean_std, load_prithvi_model_args

logger = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    from s2tpu_torch.infer.embed import POOLS

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt_dir", help="MAE run directory written by cli.train_mae or convert_weights prithvi")
    p.add_argument("--split", default="all", choices=["all", "train", "val", "test"])
    p.add_argument("--pool", default="mean", choices=list(POOLS))
    p.add_argument("--bs", type=int, default=32)
    p.add_argument(
        "--crop", type=int, default=None,
        help="center-crop size, a multiple of the patch size (default: the training crop; 0 = the whole segment)",
    )
    p.add_argument("--out", default=None, metavar="F.npz")
    p.add_argument("--epoch", type=int, default=None, help="checkpoint epoch (default: best, else latest)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--int8", action="store_true", help="int8 encoder serving: not ported yet (ROADMAP item 17)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def segment_id(source, idx: int) -> str:
    """The JAX CLI's ``_segment_id``: the segment number of a multi-frame
    sample, else the raster's stem."""
    if source.n_time_frames > 1:
        return str(source.label_index_for(idx))
    return source.sentinel_files[idx].stem


def main(argv: list[str] | None = None) -> Path:
    import torch

    from s2tpu_torch import resolve_device
    from s2tpu_torch.checkpoint.io import CheckpointManager, load_mae_checkpoint
    from s2tpu_torch.cli.train_mae import MAE_LABEL_MAP
    from s2tpu_torch.configs.paths import OUT_DIR
    from s2tpu_torch.configs.segmentation import COMPUTE_DTYPES
    from s2tpu_torch.data.dataset import TiffSource, train_val_test_split
    from s2tpu_torch.infer.embed import center_crop, load_encoder, make_embed_fn
    from s2tpu_torch.models.prithvi_mae import PrithviConfig

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.int8:
        parser.error("--int8 is not ported to s2tpu_torch yet (ROADMAP item 17, infer/quantize.py)")
    device = resolve_device(args.device)
    ckpt = CheckpointManager(args.ckpt_dir)
    best = ckpt.best_epoch()
    epoch = args.epoch if args.epoch is not None else (best if best is not None else ckpt.latest_epoch())
    config, state = load_mae_checkpoint(args.ckpt_dir, epoch=epoch)
    ds = config.datamodule.dataset_cfg
    data_dir = args.data_dir or ds.data_dir

    source = TiffSource(ds.aoi, MAE_LABEL_MAP, data_dir=data_dir, require_labels=False,
                        n_time_frames=config.model.num_frames)
    if args.split == "all":
        indices = list(range(len(source)))
    else:
        splits = train_val_test_split(len(source), config.datamodule.data_split, seed=config.datamodule.shuffle_seed)
        indices = [int(i) for i in dict(zip(("train", "val", "test"), splits))[args.split]]
    if not indices:
        raise ValueError(f"split {args.split!r} selects no segments")

    seg_hw = source[indices[0]].x.shape[-3]
    crop = args.crop if args.crop is not None else config.datamodule.random_crop_size
    crop = min(crop or seg_hw, seg_hw)
    model_config = PrithviConfig.from_model_args(
        load_prithvi_model_args(), num_frames=config.model.num_frames, img_size=crop
    )
    model_config = dataclasses.replace(model_config, attention_impl=config.model.attention_impl)
    if crop % model_config.patch_size:
        raise ValueError(f"--crop {crop} must be a multiple of the patch size {model_config.patch_size}")
    model = load_encoder(state, model_config, COMPUTE_DTYPES[config.train.compute_dtype], device)
    logger.info(f"Restored MAE checkpoint epoch {epoch} from {args.ckpt_dir} (encoder only, on {device})")

    embed = make_embed_fn(model, *load_prithvi_mean_std(), pool=args.pool)
    chunks, ids = [], []
    for lo in range(0, len(indices), args.bs):
        chunk = indices[lo : lo + args.bs]
        imgs = np.stack([center_crop(np.asarray(source[i].x), crop) for i in chunk])
        chunks.append(embed(torch.from_numpy(imgs)).to(torch.float32).cpu().numpy())
        ids.extend(segment_id(source, i) for i in chunk)
    embeddings = np.concatenate(chunks, axis=0)

    out = Path(args.out) if args.out else OUT_DIR / f"{Path(args.ckpt_dir).name}_embeddings.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "pool": args.pool, "crop": int(crop), "split": args.split, "int8": False, "epoch": int(epoch),
        "aoi": ds.aoi, "embed_dim": int(model_config.embed_dim),
    }
    np.savez(out, embeddings=embeddings, segment_ids=np.asarray(ids), meta=json.dumps(meta))
    logger.info(f"Wrote {embeddings.shape} embeddings for {len(ids)} segments -> {out}")
    return out


if __name__ == "__main__":
    main()
